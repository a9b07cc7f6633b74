"""``SlotScheduler.run_stream`` with ``realtime=True`` under open-loop
arrivals (``p95_ms``).

The mix gives the arrival law and its parameters (``traffic.arrivals``) and
``server``, the keyword arguments of ``ANNIndex.scheduler`` (slots,
frontier, lock-steps per tick).  A request is timed from its scheduled
arrival to its retirement on the wall clock; the generator's lateness, how
long after its due time each request was handed to the scheduler, goes on an
earlier line.  A traced run profiles ``TRACE_SECONDS`` of the same law after
the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic as T
from portbench.base import Clock, Run, answers_judge, open_window, prepare
from portbench.control import control_answers as control  # noqa: F401
from portbench.trace import profiled

TRACE_SECONDS = 1.0


def _submit_log(sched, log: list):
    """Record when each request is handed to the scheduler against the time it
    was due, on the clock ``run_stream`` starts right after its ``reset``."""
    reset, submit = sched.reset, sched.submit
    origin = [0.0]

    def timed_reset():
        reset()
        origin[0] = time.perf_counter()

    def timed_submit(q, rid=None, t_arrival=0.0, **kw):
        log.append(time.perf_counter() - origin[0] - t_arrival)
        return submit(q, rid=rid, t_arrival=t_arrival, **kw)

    sched.reset, sched.submit = timed_reset, timed_submit


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        limits: dict) -> Run:
    clock = Clock(device)
    X, pool, idx = prepare(cfg, seed, device, clock)
    slots = int(mix["server"]["slots"])
    sched = idx.scheduler(**mix["server"])
    del idx
    P = pool.shape[0]
    order = T.pool_order(P, seed)
    pool_host = pool.cpu().numpy()
    t_arr = T.arrivals(mix, seconds, seed)
    N = t_arr.shape[0]
    qidx = order[np.arange(N) % P]
    # warm-up: one request through admit, step and retire, then every slot
    # filled at once and drained
    sched.warmup(pool_host[order[0]])
    sched.run_stream(pool_host[order[:2 * slots]], warm=False)
    clock.lap("warmup")

    late: list = []
    _submit_log(sched, late)
    t0 = open_window()
    res = sched.run_stream(pool_host[qidx], t_arr, realtime=True, warm=False)
    window = time.perf_counter() - t0
    lat = np.asarray([r.latency for r in res])
    late_a = np.asarray(late)
    # every retired request's times (s, on run_stream's clock) and lock-steps
    counters = {"requests": {f: np.asarray([getattr(r, f) for r in res])
                             for f in ("t_arrival", "t_admit", "t_done", "hops")},
                "window_s": window}
    notes = {"requests": N, "offered_qps": N / seconds, "window_s": window,
             "generator_late_ms": {"mean": 1e3 * float(late_a.mean()),
                                   "p95": 1e3 * float(np.percentile(late_a, 95)),
                                   "max": 1e3 * float(late_a.max())},
             "p50_ms": 1e3 * float(np.percentile(lat, 50)),
             "p99_ms": 1e3 * float(np.percentile(lat, 99))}
    tr = None
    if trace:
        t_tr = T.arrivals(mix, TRACE_SECONDS, seed, "trace")
        q_tr = pool_host[order[np.arange(t_tr.shape[0]) % P]]
        tr = profiled(lambda: len(sched.run_stream(q_tr, t_tr, realtime=True, warm=False)))
    del sched
    k = int(cfg["spec"]["k"])
    ids = torch.as_tensor(np.stack([r.ids for r in res]).reshape(-1, k), device=pool.device)
    dists = torch.as_tensor(np.stack([r.dists for r in res]).reshape(-1, k),
                            device=pool.device)
    qrows = torch.as_tensor(qidx[[r.rid for r in res]], device=pool.device)
    return Run(setup=clock.parts,
               metrics={"p95_ms": 1e3 * float(np.percentile(lat, 95))},
               attempted=N, counters=counters, notes=notes,
               judge=answers_judge(cfg, X, pool, qrows, ids, dists, N, limits), t_window=t0,
               trace=tr)
