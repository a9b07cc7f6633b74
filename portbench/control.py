"""The control of the comparison that decides ``correct``: the reference put
in the program's place, computed one precision lower (TF32 where the
configuration states float32), judged by the same numbers as the program.

    python3 portbench/control.py --workload wiki128-kl.bulk --seeds 1 2 3
    python3 portbench/control.py --workload wiki128-kl-min.build --seeds 1 2 3

Each entry names its control (``control`` in ``entries/<entry>.py``): for a
searching cell (``searcher``, ``stream``) the exact top-k of every pool
query under TF32, with its TF32 distances, as a search's answers; for a
``build`` cell each sampled node's exact forward list (the configuration's
``NN`` nearest under the build distance, itself left out) under TF32, as a
graph's rows.  One line of JSON per seed with each number, at the
configuration's own size, on the card (``--device cpu`` and ``--n`` /
``--queries`` for a small rehearsal).  The benchmark's
runs never run this; ``PERF.md`` keeps the readings and the limits set
from them.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path[:0] = [str(pathlib.Path(__file__).resolve().parent.parent)]

import torch  # noqa: E402

from portbench import judge as J  # noqa: E402
from portbench import reference  # noqa: E402
from portbench import traffic as T  # noqa: E402
from portbench.base import reference_of  # noqa: E402
from portbench.data import make_data  # noqa: E402
from portbench.harness import find, load_bench, load_config, load_limits  # noqa: E402


def control_answers(cfg: dict, lim: dict, seed: int, device) -> dict:
    """A searching cell's control: the exact top-k of every pool query in TF32,
    with its TF32 distances, as a search's answers."""
    X, pool = make_data(cfg, seed, device)
    dist, k = reference_of(cfg), int(cfg["spec"]["k"])
    used = torch.ones(pool.shape[0], dtype=torch.bool, device=pool.device)
    _, truth = J.pool_truth(dist, X, pool, used, k)
    d, ids = reference.exact_topk(dist, pool, X, k, tf32=True)
    qidx = torch.arange(pool.shape[0], device=pool.device)
    return J.judge_answers(dist, X, pool, qidx, ids, d, truth, due=pool.shape[0],
                           floor=float(lim["recall_at_10_floor"]),
                           limit_gap=float(lim["dist_gap"]))


def control_graph(cfg: dict, lim: dict, seed: int, device) -> dict:
    """A building cell's control: each sampled node's exact forward list under
    TF32 as a graph's rows."""
    X, _ = make_data(cfg, seed, device)
    dist, spec = reference_of(cfg), cfg["spec"]
    n, K, build = X.shape[0], int(spec["NN"]), spec["build_policy"]
    nodes = J.sample_nodes(n, int(lim["judge_nodes"]), seed, X.device)
    _, truth = J.graph_truth(dist, X, nodes, build)
    _, fwd = reference.exact_topk(dist, X[nodes], X, K, policy_name=build, exclude=nodes,
                                  tf32=True)
    # rows of a graph: the sampled nodes' control lists, every other row a
    # valid placeholder (its own id shifted by one), which ``invalid`` passes
    rows = (torch.arange(n, device=X.device)[:, None]
            + torch.arange(1, K + 1, device=X.device)[None, :]) % n
    rows[nodes] = fwd
    return J.judge_graph(dist, X, rows, K, nodes, truth, build=build,
                         floor=float(lim["graph_recall_floor"]),
                         limit_gap=float(lim["order_gap"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int)
    ap.add_argument("--queries", type=int)
    args = ap.parse_args(argv)
    bench = load_bench()
    cell = find(bench["workloads"], args.workload, "workload")
    cfg = load_config(bench, cell["config"])
    lim = load_limits(args.workload)
    fn = T.entry(T.load(cell["traffic"])).control
    if args.n:
        cfg["n"] = args.n
    if args.queries:
        cfg["queries"] = args.queries
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        checks = fn(cfg, lim, seed, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          **{k: v[0] for k, v in checks.items()},
                          "correct": all(ok for _, _, ok in checks.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
