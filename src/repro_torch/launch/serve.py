"""Retrieval serving driver (PyTorch port of ``repro.launch.serve``: static
batches and the churn endpoint).

Builds an index over LDA-like histograms (NN-descent, or SW-graph with the
wave or the sequential engine) under a build policy, answers the held-out
queries in fixed batches through the batched or the reference engine, and
scores them against an exact scan:

    python -m repro_torch.launch.serve --n-db 20000 --dim 32 --queries 256 --batch 64
    python -m repro_torch.launch.serve --builder swgraph --wave 64
    python -m repro_torch.launch.serve --index-sym min
    python -m repro_torch.launch.serve --spec TUNED_spec.json
    python -m repro_torch.launch.serve --churn-rounds 4 --churn-insert 256 --churn-delete 200

``--spec`` takes a plain spec, a tuned-spec artifact or a learned-weights
artifact (seals checked, ``core.spec.load_spec``) and defines the whole
scenario.  With ``--churn-rounds`` the index is built with a ``--capacity``
slot budget (by default n_db + every churn insert) and kept live through
rounds of insert / delete / query traffic (``core.online``); the loop ends
with a ``compact()`` and a recall audit against an exact scan of the
surviving rows.  It runs on the card unless ``--device cpu`` is given.  The
continuous, QoS and sharded serving paths of ``repro`` are not in this
slice.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.brute_force import knn_scan
from repro_torch.core.distances import get_distance
from repro_torch.core.index import ANNIndex
from repro_torch.core.metrics import recall_at_k, speedup_model
from repro_torch.core.spec import RetrievalSpec, load_spec
from repro_torch.data.synthetic import lda_like_histograms, split_queries
from repro_torch.kernels.ops import launch_counts


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _since(counts0: dict) -> dict:
    """Kernel launches by name since the ``launch_counts()`` snapshot ``counts0``."""
    return {name: n - counts0[name] for name, n in launch_counts().items()}


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
                    alpha: float = 0.08, seed: int = 0,
                    device="cuda", verbose: bool = True) -> dict:
    """Build, warm, serve ``n_queries`` in batches of ``batch``, score; then,
    with ``churn_rounds`` > 0, ``run_churn`` over the live index.

    ``spec`` is the whole scenario when given (its distance, k, ef_search,
    engine, frontier and capacity override the loose arguments); the other
    arguments are the workload.  ``capacity`` defaults to n_db + every churn
    insert when churning.  Returns the stats dict: build seconds, recall@k
    against ``knn_scan``, distance-evaluation reduction, per-query and
    per-batch latency percentiles, queries per second, the CUDA kernel
    launches made by the build and by the timed batches, in total and by
    kernel (all 0 on the CPU), and ``churn`` when churning.
    """
    dev = resolve_device(device)
    if spec is None:
        # the same scenario repro's serve driver records for these flags
        spec = RetrievalSpec(
            distance=distance, build_policy=index_sym, builder=builder,
            build_engine=build_engine, wave=wave, NN=15, ef_construction=100,
            n_entries=n_entries, capacity=capacity, k=k, ef_search=ef_search,
            engine=engine, frontier=frontier, slots=48, sched_frontier=12,
            adaptive=False, steps_per_sync=4,
        )
    else:
        distance, k, ef_search = spec.distance, spec.k, spec.ef_search
        engine, frontier, capacity = spec.engine, spec.frontier, spec.capacity
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
    if churn_rounds > 0:
        stats["churn"] = run_churn(idx, Q, pool, rounds=churn_rounds, insert_n=churn_insert,
                                   delete_n=churn_delete, batch=batch, k=k,
                                   ef_search=ef_search, frontier=frontier, verbose=verbose)
    return stats


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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    scenario = {"distance": args.distance, "ef_search": args.ef_search,
                "index_sym": args.index_sym, "builder": args.builder,
                "build_engine": args.build_engine, "wave": args.wave, "engine": args.engine,
                "frontier": args.frontier, "n_entries": args.n_entries,
                "capacity": args.capacity}
    spec = None
    if args.spec:
        clash = sorted(k for k, v in scenario.items() if v is not None)
        if clash:
            ap.error(f"--spec defines the scenario; conflicting flags: {clash}")
        spec = load_spec(args.spec)
    return build_and_serve(spec=spec, n_db=args.n_db, dim=args.dim, n_queries=args.queries,
                           batch=args.batch, churn_rounds=args.churn_rounds,
                           churn_insert=args.churn_insert, churn_delete=args.churn_delete,
                           seed=args.seed, device=args.device,
                           **{k: v for k, v in scenario.items() if v is not None})


if __name__ == "__main__":
    print(json.dumps({k: v for k, v in main().items() if k != "spec"}))
