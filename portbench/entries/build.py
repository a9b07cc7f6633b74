"""``ANNIndex.build`` of the whole corpus, back to back, the same spec and
``build_seed`` each time (``build_rate``).  The window's last graph is
judged; a traced run profiles one more build after the window.
"""

from __future__ import annotations

import time

from portbench import judge as J
from portbench.base import Clock, Run, build_index, open_window, prepare, reference_of, sync
from portbench.control import control_graph as control  # noqa: F401
from portbench.trace import profiled


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        limits: dict) -> Run:
    clock = Clock(device)
    X, _, _ = prepare(cfg, seed, device, clock, with_index=False)
    n = X.shape[0]
    neighbors = build_index(cfg, X, device).neighbors
    clock.lap("warmup")

    builds = 0
    t0 = open_window()
    while True:
        neighbors = build_index(cfg, X, device).neighbors
        sync(device)
        builds += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0
    counters = {"builds": builds, "window_s": window}
    tr = None
    if trace:
        tr = profiled(lambda: build_index(cfg, X, device).neighbors)
        tr.result = None
    spec = cfg["spec"]

    def judge():
        dist = reference_of(cfg)
        nodes = J.sample_nodes(n, int(limits["judge_nodes"]), seed, X.device)
        _, truth = J.graph_truth(dist, X, nodes, spec["build_policy"])
        return J.judge_graph(dist, X, neighbors, int(spec["NN"]), nodes, truth,
                             build=spec["build_policy"],
                             floor=float(limits["graph_recall_floor"]),
                             limit_gap=float(limits["order_gap"]))

    return Run(setup=clock.parts, metrics={"build_rate": builds * n / window},
               attempted=builds, counters=counters,
               notes={"builds": builds, "window_s": window}, judge=judge, t_window=t0, trace=tr)
