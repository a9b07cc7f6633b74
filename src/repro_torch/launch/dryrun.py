"""Multi-card dry run: one rank's step of every cell on the production
meshes (PyTorch port of ``repro.launch.dryrun``).

``repro`` compiles each cell for (16, 16) ("data", "model") and (2, 16, 16)
("pod", "data", "model") and reads XLA's memory and cost analyses.  torch
has no ahead-of-time compiler; the port instead runs ONE rank's real step
(rank 0) under a ``fake`` process group of 256 or 512 ranks (16 for the
debug 4 x 4 mesh), initialised in this process: its collectives move
nothing and cost nothing, so the rank's work runs alone at the rank's local
shapes (``launch/cells.py``).

  * On the meta device (always): FLOPs counted by
    ``torch.utils.flop_counter.FlopCounterMode``, ``useful_flops_ratio =
    model_flops / (counted x ranks)``; the collectives by kind with their
    bytes on the wire (``launch/roofline.collective_totals``); the rank's
    argument bytes (parameters, optimizer state, batch and cache, exact from
    the local shapes); and a reckoned peak: the argument bytes plus the
    peak of the bytes the step allocates and has not freed (``LiveBytes``,
    storages tracked as ops create them).
  * With ``--device cuda``, also on the card: the same step at the same
    local shapes, run twice (the first call builds any kernel), its
    measured peak (``torch.cuda.max_memory_allocated``) and the second
    call's milliseconds.  Under the fake group the time is the rank's own
    work, without any collective's.  ``--no-count`` skips the meta pass
    (its Python shape inference takes minutes on the largest train cells):
    the collectives are then those the first call on the card counted, and
    the FLOPs are not counted.

``fits`` is peak <= ``HBM_PER_CHIP``: the measured peak where the card ran,
the reckoned one otherwise; no factor scales either.  Records go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --device meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh single --arch yi-34b \\
        --shape train_4k        # --device cuda, the default: needs the card
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import resolve_device
from repro_torch.core import distributed as cd
from repro_torch.launch.cells import Cell, build_cell, list_cells
from repro_torch.launch.mesh import HBM_PER_CHIP, make_debug_mesh, make_production_mesh
from repro_torch.launch.roofline import build_roofline, collective_totals
from repro_torch.sharding.api import use_mesh

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts", "dryrun_torch")
MESHES = {"single_pod_16x16": (256, False), "multi_pod_2x16x16": (512, True),
          "debug_4x4": (16, None)}


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages that ops create while it is active and
    that are still alive (``live``), and their peak: each new storage is
    counted once, by its size, until it is freed.  The storages of
    ``known`` (the step's arguments) are not new: an in-place op returns
    them."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._sizes = {key: 0 for key in _storages(known)}  # storage key -> bytes

    def _free(self, key):
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._sizes:
                    self._sizes[key] = st.nbytes()
                    self.live += self._sizes[key]
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, key)
        return out


def _storages(args) -> dict:
    """{storage key: bytes} of every tensor in ``args`` (a module's
    parameters and buffers included)."""
    seen = {}

    def visit(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                visit(t)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[st._cdata] = st.nbytes()
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(args)
    return seen


def argument_bytes(args) -> int:
    """Bytes of the distinct storages of every tensor in ``args``."""
    return sum(_storages(args).values())


def fake_group(world: int) -> None:
    """A ``fake`` default process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as tdist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if tdist.is_initialized():
        tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def make_mesh(mesh_name: str):
    """The named mesh over a new fake group of its size."""
    world, multi = MESHES[mesh_name]
    fake_group(world)
    if multi is None:
        return make_debug_mesh((4, 4))
    return make_production_mesh(multi_pod=multi)


def _count(cell: Cell, mesh) -> dict:
    """The meta pass: FLOPs, collectives, argument bytes, reckoned peak."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    built = build_cell(cell, mesh, device="meta")
    arg_b = argument_bytes(built["args"])
    cd.reset_collective_stats()
    with use_mesh(mesh), FlopCounterMode(display=False) as flops, \
            LiveBytes(built["args"]) as live:
        built["fn"](*built["args"])
    stats = cd.collective_stats()
    return {"built": built, "flops": float(flops.get_total_flops()), "stats": stats,
            "argument_bytes": arg_b, "step_peak_bytes": live.peak,
            "reckoned_peak_bytes": arg_b + live.peak, "count_s": time.time() - t0}


def _execute(cell: Cell, mesh, device) -> dict:
    """The card pass: the step twice at the same local shapes; peak and ms."""
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    built = build_cell(cell, mesh, device=dev)
    args, fn, carry = built.pop("args"), built.pop("fn"), built.pop("carry", None)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    cd.reset_collective_stats()
    with use_mesh(mesh):
        out = fn(*args)
        torch.cuda.synchronize(dev)
        stats = cd.collective_stats()
        args = carry(out, args) if carry else args
        del out
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize(dev)
        ms = 1e3 * (time.perf_counter() - t0)
    del out, args
    return {"built": built, "stats": stats,
            "measured_peak_bytes": int(torch.cuda.max_memory_allocated(dev)), "step_ms": ms,
            "launches": {k: v for k, v in ops.launch_counts().items() if v},
            "card": torch.cuda.get_device_name(dev)}


def run_cell(cell: Cell, mesh, mesh_name: str, art_dir: str, device="cuda",
             count: bool = True) -> dict:
    """One cell on one mesh (a ``Mesh`` over a fake group of its size):
    the meta pass (unless ``count`` is False, on the card only), then with
    ``device="cuda"`` the card pass; the record, also written to
    ``art_dir``."""
    cell_id = f"{cell.arch}__{cell.shape}__{mesh_name}".replace("/", "-")
    out_path = os.path.join(art_dir, cell_id + ".json")
    rec = {"arch": cell.arch, "shape": cell.shape, "mesh": mesh_name, "kind": cell.kind,
           "n_chips": int(mesh.size), "device": str(device)}
    if cell.skip_reason:
        rec.update(status="skipped", skip_reason=cell.skip_reason)
        _write(out_path, rec)
        print(f"[skip] {cell_id}: {cell.skip_reason}")
        return rec
    dev = resolve_device(device)
    if not count and dev.type != "cuda":
        raise ValueError("count=False leaves only the card pass: device must be cuda")
    try:
        memory = {"hbm_per_chip": HBM_PER_CHIP}
        counted = None
        if count:
            cnt = _count(cell, mesh)
            built, stats, counted = cnt.pop("built"), cnt["stats"], cnt["flops"]
            memory.update(argument_bytes=cnt["argument_bytes"],
                          step_peak_bytes=cnt["step_peak_bytes"],
                          reckoned_peak_bytes=cnt["reckoned_peak_bytes"])
        if dev.type == "cuda":
            run = _execute(cell, mesh, dev)
            built_cuda, stats_cuda = run.pop("built"), run.pop("stats")
            if not count:
                built, stats = built_cuda, stats_cuda
            del built_cuda
            memory.update(run)
            memory["peak_source"] = "measured"
            peak = memory["measured_peak_bytes"]
        else:
            memory["peak_source"] = "reckoned"
            peak = memory["reckoned_peak_bytes"]
        memory["peak_bytes"] = peak
        memory["fits"] = bool(peak <= HBM_PER_CHIP)
        coll = collective_totals(stats)
        rl = build_roofline(model_flops=built["model_flops"],
                            hlo_bytes_per_chip=built["analytic_bytes"] / mesh.size,
                            collective_totals=coll, n_chips=int(mesh.size),
                            analytic_flops=built.get("analytic_flops"))
        rec.update(
            status="ok",
            count_s=round(cnt["count_s"], 1) if count else None,
            opt=built.get("opt"),
            tokens=built.get("tokens"),
            model_flops=built["model_flops"],
            analytic_flops=built.get("analytic_flops"),
            counted_flops_per_chip=counted,
            analytic_bytes=built.get("analytic_bytes"),
            accum_steps=built.get("accum_steps"),
            serve_params=built.get("serve_params"),
            # MODEL_FLOPS / counted total (the rank's count x ranks)
            useful_flops_ratio=(built["model_flops"] / (counted * mesh.size)
                                if counted else None),
            collectives=coll,
            collective_calls={k: {"calls": v["calls"], "bytes": v["bytes"],
                                  "groups": v["groups"]}
                              for k, v in stats["kinds"].items()},
            memory=memory,
            param_state_bytes_global=built.get("param_bytes"),
            roofline=rl.as_dict(),
        )
        print(f"[ok]   {cell_id}: peak/card={peak / 2**30:.2f}GiB ({memory['peak_source']}) "
              f"dominant={rl.dominant} bound={rl.bound_s * 1e3:.2f}ms"
              + (f" step={memory['step_ms']:.1f}ms" if "step_ms" in memory else ""),
              flush=True)
    except Exception as e:  # noqa: BLE001 - record and continue
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[FAIL] {cell_id}: {type(e).__name__}: {str(e)[:200]}", flush=True)
    _write(out_path, rec)
    return rec


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="run only this arch")
    ap.add_argument("--shape", default=None, help="run only this shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both", "debug"])
    ap.add_argument("--art-dir", default=os.path.abspath(ART_DIR))
    ap.add_argument("--device", default="cuda", choices=["meta", "cuda"],
                    help="meta: count only; cuda (the default): also execute the rank's step "
                         "on the card (raises without one)")
    ap.add_argument("--no-count", action="store_true",
                    help="with --device cuda: skip the meta pass (no FLOP count, no reckoned "
                         "peak; the collectives from the card's first call)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    names = {"single": ["single_pod_16x16"], "multi": ["multi_pod_2x16x16"],
             "both": ["single_pod_16x16", "multi_pod_2x16x16"], "debug": ["debug_4x4"]}
    cells = [c for c in list_cells()
             if (args.arch is None or c.arch == args.arch)
             and (args.shape is None or c.shape == args.shape)]
    n_ok = n_skip = n_fail = 0
    for mesh_name in names[args.mesh]:
        mesh = make_mesh(mesh_name)
        print(f"dry-run: {len(cells)} cells on {mesh_name} ({mesh.size} ranks, fake group, "
              f"rank 0 on {args.device})", flush=True)
        for cell in cells:
            rec = run_cell(cell, mesh, mesh_name, args.art_dir, args.device,
                           count=not args.no_count)
            n_ok += rec["status"] == "ok"
            n_skip += rec["status"] == "skipped"
            n_fail += rec["status"] == "error"
    print(f"done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
