"""``ANNIndex.searcher()`` over batches of the pool: closed loop, back to
back, each batch synchronised (``qps``).

The mix gives ``batch``, the queries per call; the pool is sent in an order
drawn from the seed.  A traced run profiles ``TRACE_BATCHES`` more batches
after the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import traffic as T
from portbench.base import Clock, Run, answers_judge, open_window, prepare, sync
from portbench.control import control_answers as control  # noqa: F401
from portbench.trace import profiled

TRACE_BATCHES = 1


def run(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool, device,
        limits: dict) -> Run:
    clock = Clock(device)
    X, pool, idx = prepare(cfg, seed, device, clock)
    search = idx.searcher()
    del idx
    B, P = int(mix["batch"]), pool.shape[0]
    order = torch.as_tensor(T.pool_order(P, seed), device=pool.device)
    sent = pool[order].contiguous()  # the pool in the order it is sent
    n_batches = -(-P // B)
    batches = [sent[b * B:(b + 1) * B] for b in range(n_batches)]
    search(batches[0])
    if P % B:
        search(batches[-1])
    clock.lap("warmup")

    qrows, out_i, out_d, out_e, batch_s = [], [], [], [], []
    due = 0
    t0 = open_window()
    j = 0
    while True:
        qb = batches[j % n_batches]
        tb = time.perf_counter()
        d, ids, n_evals, _ = search(qb)
        sync(device)
        batch_s.append(time.perf_counter() - tb)
        due += qb.shape[0]
        start = (j % n_batches) * B
        qrows.append(order[start:start + ids.shape[0]])
        out_i.append(ids)
        out_d.append(d)
        out_e.append(n_evals)
        j += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window = time.perf_counter() - t0

    tr = None
    counters = {"queries": due, "evals": float(torch.cat(out_e).double().sum()),
                "batches": j, "window_s": window, "row_floats": int(cfg["d"])}
    if trace:
        def segment():
            ev = 0.0
            for b in range(TRACE_BATCHES):
                ev += float(search(batches[b % n_batches])[2].double().sum())
            return ev

        tr = profiled(segment)
        counters["trace_evals"] = tr.result
    del search
    qidx, ids, dists = torch.cat(qrows), torch.cat(out_i), torch.cat(out_d)
    return Run(setup=clock.parts, metrics={"qps": due / window}, attempted=due,
               counters=counters,
               notes={"batches": j, "window_s": window, "batch_s": {
                   "min": min(batch_s), "median": float(np.median(batch_s)), "max": max(batch_s)}},
               judge=answers_judge(cfg, X, pool, qidx, ids, dists, due, limits), t_window=t0,
               trace=tr)
