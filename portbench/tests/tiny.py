"""A tiny size of every cell, for runs of the whole harness on the CPU."""

from __future__ import annotations

import time

TINY = {
    "config": {"n": 1500, "queries": 192, "spec": {"NN": 10, "nnd_iters": 4, "ef_search": 32}},
    "traffic": {"batch": 64, "rate_qps": 300,
                "server": {"slots": 16, "frontier": 4, "steps_per_sync": 2}},
    "limits": {"recall_at_10_floor": 0.3, "graph_recall_floor": 0.3, "judge_nodes": 128},
}

SECONDS = 0.5


def run_tiny(workload: str, seed: int = 2**31 + 17, trace: bool = False) -> dict:
    from portbench import harness

    return harness.run_cell(harness.load_bench(), workload, seed, SECONDS, trace, "cpu",
                            time.perf_counter(), TINY)


def cells_by_entry() -> dict:
    """One cell of each traffic mix's entry (searcher, build, stream)."""
    from portbench import harness
    from portbench import traffic as T

    out = {}
    for w in harness.load_bench()["workloads"]:
        out.setdefault(T.load(w["traffic"])["entry"], w["name"])
    return out
