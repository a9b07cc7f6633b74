"""Find the highest rate a stream cell's scheduler sustains (its knee).

    python3 portbench/sweep.py --workload wiki128-kl.stream --seed 7 \\
        --rates 1000 2000 4000 --seconds 6 [--slots 512 1024]

Sets up as the cell does (data, build, scheduler at the mix's server
settings, or at each ``--slots``), then offers each rate for ``--seconds``
under the mix's arrival law through ``run_stream(realtime=True)``, each
after ``open_window`` as the cell's window is, and prints one JSON line per rate:
the completed rate, p50 / p95, the mean wait for a slot in the first and
the last quarter of arrivals (a growing backlog shows as the second far
above the first), how long after the last arrival the stream drained, and
the device's idle share over a profiled second.  The benchmark's runs never
run this; the cell's rate is set from its output (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parent.parent),
                str(pathlib.Path(__file__).resolve().parent.parent / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import traffic as T  # noqa: E402
from portbench.base import Clock, open_window, prepare  # noqa: E402
from portbench.harness import find, load_bench, load_config  # noqa: E402
from portbench.trace import profiled  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--slots", type=int, nargs="*")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, help="fewer rows, for a rehearsal on the CPU")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = load_bench()
    cell = find(bench["workloads"], args.workload, "workload")
    cfg = load_config(bench, cell["config"])
    if args.n:
        cfg.update(n=args.n, queries=min(args.n, int(cfg["queries"])))
        cfg["spec"] = {**cfg["spec"], "ef_search": 64}
    mix = T.load(cell["traffic"])
    srv = mix["server"]
    clock = Clock(args.device)
    X, pool, idx = prepare(cfg, args.seed, args.device, clock)
    order = T.pool_order(pool.shape[0], args.seed)
    pool_host = pool.cpu().numpy()
    for slots in args.slots or [int(srv["slots"])]:
        sched = idx.scheduler(**{**srv, "slots": slots})
        sched.warmup(pool_host[order[0]])
        sched.run_stream(pool_host[order[:2 * slots]], warm=False)
        for rate in args.rates:
            at_rate = {**mix, "rate_qps": rate}
            t_arr = T.arrivals(at_rate, args.seconds, args.seed)
            N = t_arr.shape[0]
            q = pool_host[order[np.arange(N) % pool.shape[0]]]
            t0 = open_window()
            res = sched.run_stream(q, t_arr, realtime=True, warm=False)
            wall = time.perf_counter() - t0
            lat = np.asarray([r.latency for r in res])
            wait = np.asarray([r.t_admit - r.t_arrival for r in res])
            quarter = max(N // 4, 1)
            ts = min(1.0, args.seconds)
            t_tr = T.arrivals(at_rate, ts, args.seed, "trace")
            q_tr = pool_host[order[np.arange(t_tr.shape[0]) % pool.shape[0]]]
            tr = profiled(lambda: sched.run_stream(q_tr, t_tr, realtime=True, warm=False))
            print(json.dumps({
                "slots": slots, "offered_qps": rate, "requests": N,
                "completed_qps": N / wall, "drain_s": wall - float(t_arr[-1]),
                "p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p95_ms": 1e3 * float(np.percentile(lat, 95)),
                "wait_ms_first_quarter": 1e3 * float(wait[:quarter].mean()),
                "wait_ms_last_quarter": 1e3 * float(wait[-quarter:].mean()),
                "idle_share": tr.idle_share if tr.busy_s > 0 else None,
                "kind": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}),
                flush=True)
        del sched
    return 0


if __name__ == "__main__":
    sys.exit(main())
