"""Retrieval serving driver (PyTorch port of ``repro.launch.serve``: static
batches, continuous batching with SLO admission, and the churn endpoint).

Builds an index over LDA-like histograms (NN-descent, or SW-graph with the
wave or the sequential engine) under a build policy, answers the held-out
queries in fixed batches through the batched or the reference engine, and
scores them against an exact scan:

    python -m repro_torch.launch.serve --n-db 20000 --dim 32 --queries 256 --batch 64
    python -m repro_torch.launch.serve --builder swgraph --wave 64
    python -m repro_torch.launch.serve --index-sym min
    python -m repro_torch.launch.serve --spec TUNED_spec.json
    python -m repro_torch.launch.serve --churn-rounds 4 --churn-insert 256 --churn-delete 200
    python -m repro_torch.launch.serve --continuous [--slo-ms 40 --tenants 2 --priority 0.6,0.4]

``--spec`` takes a plain spec, a tuned-spec artifact or a learned-weights
artifact (seals checked, ``core.spec.load_spec``) and defines the whole
scenario.  With ``--churn-rounds`` the index is built with a ``--capacity``
slot budget (by default n_db + every churn insert) and kept live through
rounds of insert / delete / query traffic (``core.online``); the loop ends
with a ``compact()`` and a recall audit against an exact scan of the
surviving rows.

With ``--continuous`` the queries also arrive as a Poisson process (rate =
``--utilization`` x the measured static-batch capacity) and are served by
the slot scheduler (``core.scheduler``): each of ``--slots`` slots retires
its query the moment it converges and takes the next.  The driver reports
p50/p95/p99 latency of static batches, dispatch-on-idle dynamic batches and
the scheduler over the same trace.  ``--slo-ms`` then serves a trace of
``--tenants`` merged per-tenant Poisson streams (class mix ``--priority``)
through SLO admission, which demotes a request down the demotion ladder
before it sheds it, against a FIFO scheduler on the same trace: in-SLO
share and goodput, by class and tenant.

With ``--shards N`` the corpus is served scatter-gather from N shards
(``core.distributed``): ``main`` spawns N ranks (``serve_sharded``), each
holding its block of rows and its own NN-descent subgraph, all driving one
``ShardedSlotScheduler`` that exchanges candidates once per tick.
``--drop-shards s`` freezes the last s shards (the straggler model) and
``--steps-per-sync`` sets the lock-steps per exchange:

    python -m repro_torch.launch.serve --shards 4 [--steps-per-sync 2] [--drop-shards 1]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.brute_force import knn_scan
from repro_torch.core.distances import get_distance
from repro_torch.core.distributed import (ShardedSlotScheduler, all_gather, build_local_subgraphs,
                                          collective_stats, init_group, local_block, pick_backend,
                                          rank_device, sharded_knn_scan, world_and_rank)
from repro_torch.core.index import ANNIndex
from repro_torch.core.metrics import recall_at_k, speedup_model
from repro_torch.core.spec import RetrievalSpec, demotion_ladder, load_spec
from repro_torch.data.synthetic import lda_like_histograms, split_queries
from repro_torch.kernels.ops import launch_counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _since(counts0: dict) -> dict:
    """Kernel launches by name since the ``launch_counts()`` snapshot ``counts0``."""
    return {name: n - counts0[name] for name, n in launch_counts().items()}


# ---------------------------------------------------------------------------
# arrival processes and the serving disciplines
# ---------------------------------------------------------------------------


def poisson_arrivals(n: int, rate: float, rng=None) -> np.ndarray:
    """Cumulative arrival times (seconds) of a rate-``rate`` Poisson process."""
    rng = rng or np.random.default_rng(0)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def multi_tenant_arrivals(n: int, rate: float, tenants: int, rng=None, weights=None):
    """Independent per-tenant Poisson traces merged into one stream.

    Tenant ``t`` gets ``weights[t] / sum(weights)`` of ``rate`` (uniform by
    default) and ``round(n * share)`` of the requests.  Returns
    ``(arrivals (n,), tenant_ids (n,))`` sorted by arrival time.
    """
    rng = rng or np.random.default_rng(0)
    tenants = max(1, int(tenants))
    w = np.ones((tenants,), float) if weights is None else np.asarray(weights, float)
    w = w / w.sum()
    counts = np.maximum(1, np.round(n * w).astype(int))
    while counts.sum() > n:
        counts[int(np.argmax(counts))] -= 1
    while counts.sum() < n:
        counts[int(np.argmin(counts))] += 1
    arr = np.concatenate([poisson_arrivals(int(c), rate * w[t], rng)
                          for t, c in enumerate(counts)])
    tid = np.concatenate([np.full((int(c),), t, np.int64) for t, c in enumerate(counts)])
    order = np.argsort(arr, kind="stable")
    return arr[order], tid[order]


def qos_summary(results, slo_s: float, *, n_classes: int = 1, n_tenants: int = 1) -> dict:
    """In-SLO share and goodput of a list of ``SlotResult``.

    A request is in SLO when it was served (not shed) within ``slo_s`` of
    its arrival; goodput is in-SLO completions per second of the trace's
    makespan.  By class and by tenant where there is more than one.
    """
    lat = np.asarray([r.latency for r in results], float)
    shed = np.asarray([r.shed for r in results], bool)
    ok = ~shed & (lat <= slo_s)
    t_end = max(r.t_done for r in results)
    t_start = min(r.t_arrival for r in results)
    out = {"n": len(results), "in_slo": float(ok.mean()),
           "goodput_qps": float(ok.sum()) / max(t_end - t_start, 1e-9),
           "shed_frac": float(shed.mean())}
    if n_classes > 1:
        prio = np.asarray([r.priority for r in results])
        out["in_slo_by_class"] = {int(c): float(ok[prio == c].mean())
                                  for c in range(n_classes) if (prio == c).any()}
    if n_tenants > 1:
        ten = np.asarray([r.tenant for r in results])
        out["in_slo_by_tenant"] = {int(t): float(ok[ten == t].mean())
                                   for t in range(n_tenants) if (ten == t).any()}
    return out


def latency_stats(lat_s, prefix: str = "") -> dict:
    """p50/p95/p99 (ms) of per-request latencies in seconds."""
    lat_s = np.asarray(lat_s, float)
    return {f"{prefix}p{p}_ms": 1e3 * float(np.percentile(lat_s, p)) for p in (50, 95, 99)}


def _serve_batch(search, Q, sel, dev):
    """Search rows ``sel`` of Q; (seconds between device syncs, ids, n_evals) on the host."""
    _sync(dev)
    t0 = time.perf_counter()
    out = search(Q[torch.as_tensor(sel, device=Q.device)])
    _sync(dev)
    return time.perf_counter() - t0, out[1].cpu().numpy(), out[2].cpu().numpy()


def simulate_static_batches(search, Q, arrivals, batch: int):
    """Static batching on a virtual clock with measured compute.

    Requests form batches of ``batch`` in arrival order; a batch starts when
    its last member has arrived and the one server is free, and holds the
    server for its measured ``search`` time (until its slowest query
    converges).  Returns (latencies (n,), ids (n, k), n_evals (n,)) in
    request order.
    """
    arrivals = np.asarray(arrivals, float)
    n, dev = Q.shape[0], Q.device
    order = np.argsort(arrivals, kind="stable")
    lat = np.zeros((n,), float)
    evals = np.zeros((n,), np.int64)
    rows = {}
    t_free = 0.0
    for lo in range(0, n, batch):
        sel = order[lo:lo + batch]
        service, batch_ids, batch_evals = _serve_batch(search, Q, sel, dev)
        t_done = max(t_free, float(arrivals[sel].max())) + service
        t_free = t_done
        lat[sel] = t_done - arrivals[sel]
        for j, r in enumerate(sel):
            rows[int(r)] = batch_ids[j]
            evals[r] = batch_evals[j]
    return lat, np.stack([rows[j] for j in range(n)]), evals


def simulate_dynamic_batches(search, Q, arrivals, max_batch: int):
    """Dispatch-on-idle dynamic batching, the stronger classical baseline.

    When the one server frees (or a request reaches an idle server), every
    waiting request, up to ``max_batch``, starts at once.  Dispatch sizes
    are padded to power-of-two buckets, as a fixed-shape server would, and
    the padded rows' compute is charged to the batch; every bucket is
    warmed before the trace.  Same return contract as
    ``simulate_static_batches``.
    """
    arrivals = np.asarray(arrivals, float)
    n, dev = Q.shape[0], Q.device
    order = np.argsort(arrivals, kind="stable")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    for b in buckets:  # every dispatch shape, outside the timed region
        _serve_batch(search, Q, np.arange(b) % n, dev)
    lat = np.zeros((n,), float)
    evals = np.zeros((n,), np.int64)
    rows = {}
    t_free = 0.0
    i = 0
    while i < n:
        # server idle: dispatch everything that has arrived by now
        t_disp = max(t_free, float(arrivals[order[i]]))
        j = i
        while j < n and arrivals[order[j]] <= t_disp and j - i < max_batch:
            j += 1
        sel = order[i:j]
        bucket = next(b for b in buckets if b >= len(sel))
        pad = np.concatenate([sel, np.repeat(sel[:1], bucket - len(sel))])
        service, batch_ids, batch_evals = _serve_batch(search, Q, pad, dev)
        t_free = t_disp + service
        lat[sel] = t_free - arrivals[sel]
        for p, r in enumerate(sel):
            rows[int(r)] = batch_ids[p]
            evals[r] = batch_evals[p]
        i = j
    return lat, np.stack([rows[j] for j in range(n)]), evals


def run_continuous(idx, Q, arrivals, *, k: int, ef_search: int, slots: int, frontier: int,
                   adaptive: bool = False, steps_per_sync: int = 4, realtime: bool = False):
    """Serve the arrival trace through the slot scheduler; the same return
    contract as ``simulate_static_batches``."""
    sched = idx.scheduler(k, ef_search, slots=slots, frontier=frontier, adaptive=adaptive,
                          steps_per_sync=steps_per_sync)
    res = sched.run_stream(Q, arrivals, realtime=realtime)
    return (np.asarray([r.latency for r in res]), np.stack([r.ids for r in res]),
            np.asarray([r.n_evals for r in res]))


def run_churn(idx, Q, pool, *, rounds: int, insert_n: int, delete_n: int, batch: int,
              k: int, ef_search: int, frontier: int, verbose: bool = True) -> dict:
    """Steady-state mutation endpoints: rounds of insert / delete / query churn.

    ``pool``: (rounds * insert_n, m) fresh points to stream in.  Deletes
    draw uniformly from the alive ids (``np.random.default_rng(0)``).  Each
    phase is timed with a device sync around it.  Returns the throughput
    of each phase, the churn query latency, a ``compact()``, a recall audit
    of the whole query set against an exact scan of the surviving rows, and
    the kernel launches of each phase by kernel (all 0 on the CPU).
    """
    online = idx.ensure_online()
    dev = Q.device
    search = idx.searcher(k, ef_search, frontier=frontier, adaptive=False)
    search(Q[:batch])  # steady-state timings
    _sync(dev)
    rng = np.random.default_rng(0)
    phases = ("insert", "delete", "search", "compact", "audit")
    launches = {phase: dict.fromkeys(launch_counts(), 0) for phase in phases}
    seconds = dict.fromkeys(phases, 0.0)
    q_t, n_ins, n_del = [], 0, 0

    def timed(phase, fn):
        counts0 = launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        dt = time.perf_counter() - t0
        seconds[phase] += dt
        for name, n in _since(counts0).items():
            launches[phase][name] += n
        return out, dt

    for r in range(rounds):
        chunk = pool[r * insert_n:(r + 1) * insert_n]
        timed("insert", lambda: idx.insert(chunk))
        n_ins += chunk.shape[0]
        alive_ids = np.flatnonzero(online.alive.cpu().numpy())
        victims = rng.choice(alive_ids, size=min(delete_n, len(alive_ids)), replace=False)
        timed("delete", lambda: idx.delete(victims))
        n_del += len(victims)
        qb = Q[(r * batch) % max(1, Q.shape[0] - batch):][:batch]
        q_t.append(timed("search", lambda: search(qb))[1] / qb.shape[0])
    compact_stats, compact_s = timed("compact", idx.compact)

    def audit():
        # the exact scan of the surviving rows, then the live search
        surv = torch.nonzero(online.alive).squeeze(1)
        _, true_pos = knn_scan(idx.dist, Q, online.X[surv], k)
        return surv[true_pos.long()], search(Q)[1]

    (true_global, ids), _ = timed("audit", audit)
    stats = {
        "rounds": rounds,
        "inserted": n_ins,
        "deleted": n_del,
        "inserts_per_s": n_ins / max(seconds["insert"], 1e-9),
        "deletes_per_s": n_del / max(seconds["delete"], 1e-9),
        "churn_p50_latency_ms": 1e3 * float(np.percentile(q_t, 50)),
        "compact_s": compact_s,
        "compact_repaired": compact_stats["repaired"],
        "recall@k_after_churn": recall_at_k(ids, true_global.cpu().numpy()),
        "n_alive": online.n_alive,
        "capacity_used": online.n_total,
        "phase_s": seconds,
        "kernel_launches": launches,
    }
    if verbose:
        print(f"[serve/churn] {stats}")
    return stats


def build_and_serve(*, spec: RetrievalSpec | None = None, distance: str = "kl",
                    n_db: int = 20_000, dim: int = 32, n_queries: int = 256,
                    batch: int = 64, k: int = 10, ef_search: int = 96,
                    index_sym: str = "none",
                    builder: str = "nndescent", build_engine: str = "wave", wave: int = 64,
                    engine: str = "batched", frontier: int = 4,
                    n_entries: int = 4, capacity: int | None = None, churn_rounds: int = 0,
                    churn_insert: int = 256, churn_delete: int = 200,
                    continuous: bool = False, slots: int = 48, cont_frontier: int = 12,
                    adaptive_frontier: bool = False, utilization: float = 0.4,
                    slo_ms: float | None = None, tenants: int = 1, priority_mix=None,
                    ladder_source=None, alpha: float = 0.08, seed: int = 0,
                    device="cuda", verbose: bool = True) -> dict:
    """Build, warm, serve ``n_queries`` in batches of ``batch``, score; then
    the continuous and QoS paths (``continuous``, ``slo_ms``) and, with
    ``churn_rounds`` > 0, ``run_churn`` over the live index.

    ``spec`` is the whole scenario when given (its distance, k, ef_search,
    engine, frontier, scheduler knobs and capacity override the loose
    arguments); the other arguments are the workload.  ``capacity``
    defaults to n_db + every churn insert when churning.  Returns the stats
    dict: build seconds, recall@k against ``knn_scan``, distance-evaluation
    reduction, per-query and per-batch latency percentiles, queries per
    second, the CUDA kernel launches by phase and kernel (all 0 on the
    CPU), and ``continuous``, ``qos`` and ``churn`` when asked for.
    """
    dev = resolve_device(device)
    if spec is None:
        # the same scenario repro's serve driver records for these flags
        spec = RetrievalSpec(
            distance=distance, build_policy=index_sym, builder=builder,
            build_engine=build_engine, wave=wave, NN=15, ef_construction=100,
            n_entries=n_entries, capacity=capacity, k=k, ef_search=ef_search,
            engine=engine, frontier=frontier, slots=slots, sched_frontier=cont_frontier,
            adaptive=adaptive_frontier, steps_per_sync=4,
        )
    else:
        distance, k, ef_search = spec.distance, spec.k, spec.ef_search
        engine, frontier, capacity = spec.engine, spec.frontier, spec.capacity
        slots, cont_frontier = spec.slots, spec.sched_frontier
        adaptive_frontier = spec.adaptive
    rng = np.random.default_rng(seed)
    data = lda_like_histograms(rng, n_db + n_queries, dim, alpha=alpha, device=dev)
    Q, rest = split_queries(data, n_queries, rng)
    X = rest[:n_db]
    # the churn pool comes after the queries from the same generator, so the
    # served data does not depend on the churn flags
    pool_n = churn_rounds * churn_insert
    pool = lda_like_histograms(rng, pool_n, dim, alpha=alpha, device=dev) if pool_n else None
    if churn_rounds > 0 and capacity is None:
        capacity = n_db + pool_n
    if capacity != spec.capacity:
        spec = spec.replace(capacity=capacity)
    if capacity is not None and engine != "batched":
        raise ValueError("mutable (--capacity / --churn-rounds) serving requires "
                         "--engine batched")
    dist = get_distance(distance)
    generator = torch.Generator(device=dev).manual_seed(seed)

    launches0 = launch_counts()
    t0 = time.perf_counter()
    idx = ANNIndex.build(X, dist, spec=spec, generator=generator)
    _sync(dev)
    build_s = time.perf_counter() - t0
    build_launches = _since(launches0)

    # the static, dynamic and batch phases are the fixed-frontier baseline:
    # adaptive stays off there, whatever the spec says
    search = idx.searcher(k, ef_search, engine=engine, frontier=frontier, adaptive=False)
    # warm every batch shape served (full batches plus a ragged tail)
    search(Q[:batch])
    if n_queries % batch:
        search(Q[:n_queries % batch])
    _sync(dev)

    _, true_ids = knn_scan(dist, Q, X, k)

    launches0 = launch_counts()
    lat, batch_s, evals, all_ids = [], [], [], []
    t_all = time.perf_counter()
    for lo in range(0, n_queries, batch):
        qb = Q[lo:lo + batch]
        t0 = time.perf_counter()
        _, ids, n_evals, _ = search(qb)
        _sync(dev)
        batch_s.append(time.perf_counter() - t0)
        lat.append(batch_s[-1] / qb.shape[0])
        evals.append(n_evals.cpu().numpy())
        all_ids.append(ids.cpu().numpy())
    serve_s = time.perf_counter() - t_all
    search_launches = _since(launches0)

    recall = recall_at_k(np.concatenate(all_ids), true_ids)
    stats = {
        "device": str(dev),
        "build_s": build_s,
        "builder": spec.builder,
        "build_engine": idx.build_info["build_engine"],
        "index_sym_resolved": idx.build_info["index_sym_resolved"],
        "query_sym_resolved": idx.build_info["query_sym_resolved"],
        "engine": engine,
        "served": n_queries,
        "recall@k": recall,
        "eval_reduction": speedup_model(n_db, np.concatenate(evals)),
        "qps": n_queries / serve_s,
        "p50_latency_ms": 1e3 * float(np.percentile(lat, 50)),
        "p99_latency_ms": 1e3 * float(np.percentile(lat, 99)),
        "p50_batch_ms": 1e3 * float(np.percentile(batch_s, 50)),
        "p99_batch_ms": 1e3 * float(np.percentile(batch_s, 99)),
        "build_kernel_launches": sum(build_launches.values()),
        "search_kernel_launches": sum(search_launches.values()),
        "kernel_launches": {"build": build_launches, "search": search_launches},
        "mean_degree": idx.build_info["mean_degree"],
        "spec": spec.to_dict(),
        "spec_fingerprint": spec.fingerprint(),
    }
    if verbose:
        print(f"[serve] dist={distance} build={spec.build_policy} search={spec.search_policy} "
              f"n={n_db} dim={dim} -> "
              f"{ {k_: v for k_, v in stats.items() if k_ != 'spec'} }")
    if continuous:
        stats.update(_serve_continuous(
            idx, spec, Q, true_ids, search, batch_s, n_db=n_db, batch=batch, k=k,
            ef_search=ef_search, slots=slots, cont_frontier=cont_frontier,
            adaptive_frontier=adaptive_frontier, utilization=utilization, slo_ms=slo_ms,
            tenants=tenants, priority_mix=priority_mix, ladder_source=ladder_source,
            launches=stats["kernel_launches"], verbose=verbose))
    if churn_rounds > 0:
        stats["churn"] = run_churn(idx, Q, pool, rounds=churn_rounds, insert_n=churn_insert,
                                   delete_n=churn_delete, batch=batch, k=k,
                                   ef_search=ef_search, frontier=frontier, verbose=verbose)
    return stats


def _serve_continuous(idx, spec, Q, true_ids, search, batch_s, *, n_db, batch, k, ef_search,
                      slots, cont_frontier, adaptive_frontier, utilization, slo_ms, tenants,
                      priority_mix, ladder_source, launches, verbose) -> dict:
    """``build_and_serve``'s continuous phase, and its QoS phase with ``slo_ms``:
    ``{"continuous": ..., "qos": ...}`` with ``repro``'s keys; each phase's
    kernel launches are added to ``launches``."""
    dev = Q.device
    # Poisson load at `utilization` x the measured static capacity
    rate = utilization * batch / float(np.median(batch_s))
    if adaptive_frontier:
        # the adaptive engine trades steps for evaluations: anchor its load
        # to its own measured capacity, or the queue saturates
        probe = idx.scheduler(k, ef_search, slots=slots, frontier=cont_frontier, adaptive=True,
                              steps_per_sync=4)
        n_probe = min(96, Q.shape[0])
        res = probe.run_stream(Q[:n_probe])
        # the virtual clock counts tick compute only, so max t_done is the drain time
        rate = min(rate, utilization * n_probe / max(r.t_done for r in res))
    n_queries = Q.shape[0]
    arrivals = poisson_arrivals(n_queries, rate, np.random.default_rng(1))
    s_lat, _, _ = simulate_static_batches(search, Q, arrivals, batch)
    d_lat, d_ids, _ = simulate_dynamic_batches(search, Q, arrivals, batch)
    counts0 = launch_counts()
    # the slot engine's latency is steps x tick, so it takes a fatter frontier
    c_lat, c_ids, c_evals = run_continuous(idx, Q, arrivals, k=k, ef_search=ef_search,
                                           slots=slots, frontier=cont_frontier,
                                           adaptive=adaptive_frontier)
    _sync(dev)
    launches["continuous"] = _since(counts0)
    cont = {
        "offered_qps": rate,
        "slots": slots,
        "frontier": cont_frontier,
        "adaptive_frontier": adaptive_frontier,
        "recall@k": recall_at_k(c_ids, true_ids),
        "eval_reduction": speedup_model(n_db, c_evals),
        **latency_stats(c_lat),
        "static_p99_ms": latency_stats(s_lat)["p99_ms"],
        "dynamic_p99_ms": latency_stats(d_lat)["p99_ms"],
        "dynamic_recall@k": recall_at_k(d_ids, true_ids),
        "p99_speedup_vs_static": float(np.percentile(s_lat, 99) / np.percentile(c_lat, 99)),
        "p99_speedup_vs_dynamic": float(np.percentile(d_lat, 99) / np.percentile(c_lat, 99)),
    }
    out = {"continuous": cont}
    if verbose:
        print(f"[serve/continuous] {cont}")
    if slo_ms is None:
        return out

    ladder = demotion_ladder(spec, ladder_source)
    mix = np.asarray([1.0] if not priority_mix else priority_mix, float)
    mix = mix / mix.sum()
    rng_q = np.random.default_rng(7)
    q_arr, t_ids = multi_tenant_arrivals(n_queries, rate, tenants, rng_q)
    prios = rng_q.choice(len(mix), size=n_queries, p=mix)
    counts0 = launch_counts()
    sched = idx.scheduler(spec=spec, ladder=ladder, slo_ms=slo_ms,
                          background=idx.online is not None)
    res = sched.run_stream(Q, q_arr, tenants=t_ids, priorities=prios)
    _sync(dev)
    launches["qos"] = _since(counts0)
    # FIFO baseline: the same trace, no admission control or demotion
    fifo = qos_summary(idx.scheduler(spec=spec).run_stream(Q, q_arr), slo_ms * 1e-3)
    qos = {
        "slo_ms": slo_ms,
        "tenants": max(1, int(tenants)),
        "ladder": [r.name for r in sched.rungs],
        **qos_summary(res, slo_ms * 1e-3, n_classes=len(mix), n_tenants=tenants),
        "demoted": sched.qos_stats["demoted"],
        "shed": sched.qos_stats["shed"],
        "fifo_in_slo": fifo["in_slo"],
        "fifo_goodput_qps": fifo["goodput_qps"],
    }
    out["qos"] = qos
    if verbose:
        print(f"[serve/qos] {qos}")
    return out


def build_and_serve_sharded(*, distance: str = "kl", n_db: int = 4096, dim: int = 32,
                            n_queries: int = 256, k: int = 10, ef_search: int = 96,
                            slots: int = 32, shards: int = 4, steps_per_sync: int = 1,
                            drop_shards: int = 0, NN: int = 15, nnd_iters: int = 8,
                            compare_replicated: bool = True, alpha: float = 0.08, seed: int = 0,
                            device="cuda", group=None, verbose: bool = True) -> dict:
    """Scatter-gather serving: the slot scheduler over a SHARDED corpus.

    Called on every rank of ``group``, whose size must be ``shards``
    (``serve_sharded`` spawns the ranks).  Every rank draws the same data
    from ``seed`` on the host and keeps only its block of ``n_db / shards``
    rows (padded when not divisible) on ``device``; it builds its local
    NN-descent subgraph and serves the queries, all submitted at t = 0,
    through its replica of the ``ShardedSlotScheduler``.  The ground truth
    is ``sharded_knn_scan`` on the ranks.  With ``compare_replicated``
    rank 0 also serves the queries through the replicated ``SlotScheduler``
    over one NN-descent graph of the union corpus and reports the recall
    gap the serving gate bounds (0.005).

    Returns the stats: ``repro``'s keys (the port compiles nothing, so there
    are no executable counts), the backend and ranks per card, ticks, ms
    per tick, collectives per tick, the share of the tick spent in its
    exchange (``collective_share``), the kernel launches by phase (this
    rank's, and every rank's by rank).  Only rank 0's stats carry the
    replicated comparison.
    """
    import torch.distributed as tdist

    world, shard = world_and_rank(group)
    if world != shards:
        raise ValueError(f"shards {shards} != the group's {world} ranks")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    data = lda_like_histograms(rng, n_db + n_queries, dim, alpha=alpha, device="cpu")
    Q_host, rest = split_queries(data, n_queries, rng)
    X_host = rest[:n_db]
    X_local, n_real, n_local = local_block(X_host, shard, world)
    X_local, Q = X_local.to(dev), Q_host.to(dev)
    dist = get_distance(distance)
    launches = {}

    def phase(name, fn):
        counts0 = launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        launches[name] = _since(counts0)
        return out, time.perf_counter() - t0

    def build():
        nbrs = build_local_subgraphs(dist, X_local, NN=NN, nnd_iters=nnd_iters, seed=seed,
                                     group=group)
        return ShardedSlotScheduler(dist, X_local, nbrs, n_real, slots=slots, ef=ef_search, k=k,
                                    steps_per_sync=steps_per_sync, drop_shards=drop_shards,
                                    group=group)

    sched, build_s = phase("build", build)
    (_, true_ids), _ = phase("ground_truth",
                             lambda: sharded_knn_scan(dist, Q, X_local, k, n_real, group=group))
    sched.warmup(Q_host[0].numpy())
    calls0 = collective_stats()
    res, serve_s = phase("serve", lambda: sched.run_stream(Q_host.numpy(), warm=False))
    calls = collective_stats()
    ids = np.stack([r.ids for r in res])
    evals = np.asarray([r.n_evals for r in res])
    # every rank's launches by phase and kernel, in one all-gather
    names = list(launch_counts())
    mine = torch.tensor([[launches[p][n] for n in names] for p in launches], dtype=torch.int64,
                        device=dev)
    by_rank = all_gather(mine, group).cpu().tolist()
    stats = {
        "shards": shards,
        "n_db": n_db,
        "rows_per_shard": n_local,
        "build_s": build_s,
        "slots": slots,
        "steps_per_sync": steps_per_sync,
        "drop_shards": drop_shards,
        "recall@k": recall_at_k(ids, true_ids),
        "eval_reduction": speedup_model(n_db, evals),
        **latency_stats([r.latency for r in res]),
        "backend": tdist.get_backend(group),
        "ranks_per_card": pick_backend(world, dev)[1],
        "device": str(dev),
        "served": n_queries,
        "qps": n_queries / serve_s,
        "ticks": sched.ticks,
        "ms_per_tick": 1e3 * sched.tick_s / max(sched.ticks, 1),
        "collectives_per_tick": (calls["calls"] - calls0["calls"]) / max(sched.ticks, 1),
        "collective_share": sched.exchange_s / max(sched.tick_s, 1e-12),
        "max_id": int(ids.max()),
        "mean_evals": float(evals.mean()),
        "kernel_launches": launches,
        "kernel_launches_by_rank": [{p: dict(zip(names, row)) for p, row in zip(launches, rows)}
                                    for rows in by_rank],
    }
    if compare_replicated and shard == 0:
        spec = RetrievalSpec(distance=distance, builder="nndescent", NN=NN, nnd_iters=nnd_iters)
        idx = ANNIndex.build(X_host.to(dev), dist, spec=spec,
                             generator=torch.Generator(device=dev).manual_seed(seed + 3))
        res_r = idx.scheduler(k, ef_search, slots=slots).run_stream(Q_host.numpy())
        r_repl = recall_at_k(np.stack([r.ids for r in res_r]), true_ids)
        stats["replicated_recall@k"] = r_repl
        stats["recall_gap"] = r_repl - stats["recall@k"]
    if verbose:
        print(f"[serve/sharded] dist={distance} n={n_db} x{shards} -> {stats}", flush=True)
    return stats


def _rank_main(rank: int, world: int, backend: str, device: str, store: str, fn,
               args: tuple) -> None:
    """One spawned rank of ``run_ranks``: its device, the group, then
    ``fn(device, *args)``, whose result goes to ``<store>.<rank>.json``."""
    import torch.distributed as tdist

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)  # the lock-step loop launches many tiny ops
    init_group(backend, f"file://{store}", rank, world)
    try:
        out = fn(dev, *args)
    finally:
        tdist.destroy_process_group()
    pathlib.Path(f"{store}.{rank}.json").write_text(json.dumps(out))


def run_ranks(fn, shards: int, device="cuda", *args) -> list:
    """``fn(device, *args)`` on ``shards`` spawned ranks of one process
    group; every rank's result (JSON), in rank order.

    ``fn`` is a module-level function, called on every rank with that
    rank's device.  The backend is fixed here, before any rank starts
    (``pick_backend``: NCCL where each rank has a card of its own, gloo
    otherwise) and printed.  On the card every kernel is built before the
    spawn, so the ranks only load them.  A rank's failure raises here.
    """
    import torch.multiprocessing as mp

    from repro_torch.kernels import build as kernel_build

    dev = resolve_device(device)
    backend, ranks_per_card = pick_backend(shards, dev)
    print(f"[ranks] {shards} ranks, backend={backend}, ranks_per_card={ranks_per_card}",
          flush=True)
    if dev.type == "cuda":
        kernel_build.build_all()
    with tempfile.TemporaryDirectory() as tmp:
        store = str(pathlib.Path(tmp) / "store")
        mp.start_processes(_rank_main, args=(shards, backend, dev.type, store, fn, args),
                           nprocs=shards, join=True, start_method="spawn")
        return [json.loads(pathlib.Path(f"{store}.{r}.json").read_text())
                for r in range(shards)]


def _serve_rank(dev, kwargs: dict) -> dict:
    world, rank = world_and_rank()
    return build_and_serve_sharded(shards=world, device=dev, verbose=rank == 0, **kwargs)


def serve_sharded(shards: int, device="cuda", **kwargs) -> dict:
    """``build_and_serve_sharded(**kwargs)`` on ``shards`` spawned ranks
    (``run_ranks``); rank 0's stats."""
    return run_ranks(_serve_rank, shards, device, kwargs)[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; the default cuda raises when no card is present")
    ap.add_argument("--spec", default=None,
                    help="a RetrievalSpec JSON, a tuned-spec artifact or a learned-weights "
                         "artifact (a path or the JSON text; seals checked); it defines the "
                         "scenario and may not be combined with the scenario flags")
    # scenario flags default to None so that a clash with --spec is seen
    ap.add_argument("--distance", default=None)
    ap.add_argument("--n-db", type=int, default=20_000)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--ef", type=int, default=None, dest="ef_search")
    ap.add_argument("--index-sym", default=None,
                    help="graph-construction distance policy (avg, min, reverse, l2, max, "
                         "blend(a), rankblend(a[,tau]), learned(ref))")
    ap.add_argument("--builder", default=None, choices=["nndescent", "swgraph"])
    ap.add_argument("--build-engine", default=None, choices=["wave", "sequential"],
                    help="swgraph construction engine (wave-parallel vs reference)")
    ap.add_argument("--wave", type=int, default=None,
                    help="points inserted per construction wave (swgraph builder)")
    ap.add_argument("--engine", default=None, choices=["batched", "reference"])
    ap.add_argument("--frontier", type=int, default=None,
                    help="beam candidates expanded per lock-step (batched engine)")
    ap.add_argument("--entries", type=int, default=None, dest="n_entries",
                    help="entry points seeded per query (medoid + random)")
    ap.add_argument("--capacity", type=int, default=None,
                    help="mutable-index slot budget (enables insert/delete; defaults to "
                         "n_db + total churn inserts)")
    ap.add_argument("--churn-rounds", type=int, default=0,
                    help="rounds of steady-state insert/delete/query churn after the "
                         "initial serve phase")
    ap.add_argument("--churn-insert", type=int, default=256,
                    help="points inserted per churn round")
    ap.add_argument("--churn-delete", type=int, default=200,
                    help="points tombstoned per churn round")
    ap.add_argument("--continuous", action="store_true",
                    help="also serve a Poisson arrival trace through the slot scheduler and "
                         "compare latency percentiles against static and dynamic batching")
    ap.add_argument("--slots", type=int, default=None,
                    help="concurrent in-flight queries in the scheduler (default 48)")
    ap.add_argument("--cont-frontier", type=int, default=None,
                    help="per-slot frontier of the scheduler (default 12: slot latency is "
                         "steps x tick, not batch service)")
    ap.add_argument("--adaptive-frontier", action="store_true", default=None,
                    help="per-slot adaptive frontier width (fewer distance evaluations)")
    ap.add_argument("--utilization", type=float, default=0.4,
                    help="Poisson arrival rate as a fraction of the measured static-batch "
                         "capacity")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency budget (ms): serve the trace through SLO "
                         "admission (demote, then shed) against a FIFO scheduler")
    ap.add_argument("--tenants", type=int, default=1,
                    help="per-tenant Poisson traces merged into the load, served under "
                         "deficit round-robin (QoS path, needs --slo-ms)")
    ap.add_argument("--priority", default=None,
                    help="comma-separated QoS class mix, highest class first (e.g. 0.6,0.4): "
                         "class p starts at ladder rung p (QoS path, needs --slo-ms)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve scatter-gather from N corpus shards through the sharded slot "
                         "scheduler, one spawned rank per shard")
    ap.add_argument("--drop-shards", type=int, default=0,
                    help="freeze the last s shards at admission (bounded-staleness straggler "
                         "model, sharded path)")
    ap.add_argument("--steps-per-sync", type=int, default=1,
                    help="beam lock-steps per cross-shard sync point (sharded path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.shards:
        bad = [f for f, v in [("--spec", args.spec), ("--continuous", args.continuous or None),
                              ("--churn-rounds", args.churn_rounds or None),
                              ("--slo-ms", args.slo_ms)] if v]
        if bad:
            ap.error(f"--shards is its own serving path; incompatible with {bad}")
        return serve_sharded(args.shards, device=args.device, n_db=args.n_db, dim=args.dim,
                             n_queries=args.queries, drop_shards=args.drop_shards,
                             steps_per_sync=args.steps_per_sync, seed=args.seed,
                             **{k: v for k, v in [("distance", args.distance),
                                                  ("ef_search", args.ef_search),
                                                  ("slots", args.slots)] if v is not None})
    if args.slo_ms is not None and not args.continuous:
        ap.error("--slo-ms needs --continuous (it shapes the arrival trace)")
    if (args.tenants != 1 or args.priority) and args.slo_ms is None:
        ap.error("--tenants / --priority need --slo-ms (the QoS path)")
    priority_mix = None
    if args.priority:
        try:
            priority_mix = [float(x) for x in args.priority.split(",")]
        except ValueError:
            ap.error(f"--priority expects comma-separated fractions, got {args.priority!r}")
        if not priority_mix or min(priority_mix) <= 0:
            ap.error("--priority fractions must be positive")
    scenario = {"distance": args.distance, "ef_search": args.ef_search,
                "index_sym": args.index_sym, "builder": args.builder,
                "build_engine": args.build_engine, "wave": args.wave, "engine": args.engine,
                "frontier": args.frontier, "n_entries": args.n_entries,
                "capacity": args.capacity, "slots": args.slots,
                "cont_frontier": args.cont_frontier,
                "adaptive_frontier": args.adaptive_frontier}
    spec = None
    ladder_source = None
    if args.spec:
        clash = sorted(k for k, v in scenario.items() if v is not None)
        if clash:
            ap.error(f"--spec defines the scenario; conflicting flags: {clash}")
        spec = load_spec(args.spec)
        text = args.spec if "{" in args.spec else pathlib.Path(args.spec).read_text()
        doc = json.loads(text)
        if isinstance(doc, dict) and "frontier" in doc:
            # a tuned artifact's Pareto frontier feeds the demotion ladder
            ladder_source = doc
    return build_and_serve(spec=spec, n_db=args.n_db, dim=args.dim, n_queries=args.queries,
                           batch=args.batch, churn_rounds=args.churn_rounds,
                           churn_insert=args.churn_insert, churn_delete=args.churn_delete,
                           continuous=args.continuous, utilization=args.utilization,
                           slo_ms=args.slo_ms, tenants=args.tenants, priority_mix=priority_mix,
                           ladder_source=ladder_source, seed=args.seed, device=args.device,
                           **{k: v for k, v in scenario.items() if v is not None})


if __name__ == "__main__":
    print(json.dumps({k: v for k, v in main().items() if k != "spec"}))
