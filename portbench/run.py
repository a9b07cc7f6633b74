"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the program (``src/repro_torch``).  It runs on the machine it is
started on and needs as many CUDA cards as the cell asks for; without them
it exits 3, and without the program (``src/repro_torch``) 5, and prints no
result.  The last line of standard output is the
result (``harness.run_cell``); with ``--trace 0`` it holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics.  It exits 4
if a module named ``jax``, ``jaxlib``, ``flax`` or ``repro`` was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# every cache of the program and its libraries at a fixed path in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(BUILD / "torch_extensions"))
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(BUILD / "inductor"))
os.environ.setdefault("CUDA_CACHE_PATH", str(BUILD / "nv"))
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.load_bench()
    cell = harness.find(bench["workloads"], args.workload, "workload")
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"the program, src/repro_torch, is not in {ROOT}", file=sys.stderr)
        return 5
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    # the configurations state float32: no product runs in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"modules of JAX or its package were loaded: {found}", file=sys.stderr)
        return 4
    harness.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
