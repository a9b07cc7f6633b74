"""Retrieval serving driver (PyTorch port of ``repro.launch.serve``, static batches).

Builds an index over LDA-like histograms (NN-descent, or SW-graph with the
wave or the sequential engine) under a build policy, answers the held-out
queries in fixed batches through the batched or the reference engine, and
scores them against an exact scan:

    python -m repro_torch.launch.serve --n-db 20000 --dim 32 --queries 256 --batch 64
    python -m repro_torch.launch.serve --builder swgraph --wave 64
    python -m repro_torch.launch.serve --index-sym min
    python -m repro_torch.launch.serve --spec TUNED_spec.json

``--spec`` takes a plain spec, a tuned-spec artifact or a learned-weights
artifact (seals checked, ``core.spec.load_spec``) and defines the whole
scenario.  It runs on the card unless ``--device cpu`` is given.  The
continuous, churn, QoS and sharded serving paths of ``repro`` are not in
this slice.
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


def build_and_serve(*, spec: RetrievalSpec | None = None, distance: str = "kl",
                    n_db: int = 20_000, dim: int = 32, n_queries: int = 256,
                    batch: int = 64, k: int = 10, ef_search: int = 96,
                    index_sym: str = "none",
                    builder: str = "nndescent", build_engine: str = "wave", wave: int = 64,
                    engine: str = "batched", frontier: int = 4,
                    n_entries: int = 4, alpha: float = 0.08, seed: int = 0,
                    device="cuda", verbose: bool = True) -> dict:
    """Build, warm, serve ``n_queries`` in batches of ``batch``, score.

    ``spec`` is the whole scenario when given (its distance, k, ef_search,
    engine and frontier override the loose arguments); the other arguments
    are the workload.  Returns the stats dict: build seconds, recall@k
    against ``knn_scan``, distance-evaluation reduction, per-query and
    per-batch latency percentiles, queries per second, and the CUDA kernel
    launches made by the build and by the timed batches, in total and by
    kernel (all 0 on the CPU).
    """
    dev = resolve_device(device)
    if spec is None:
        # the same scenario repro's serve driver records for these flags
        spec = RetrievalSpec(
            distance=distance, build_policy=index_sym, builder=builder,
            build_engine=build_engine, wave=wave, NN=15, ef_construction=100,
            n_entries=n_entries, capacity=None, k=k, ef_search=ef_search,
            engine=engine, frontier=frontier, slots=48, sched_frontier=12,
            adaptive=False, steps_per_sync=4,
        )
    else:
        distance, k, ef_search = spec.distance, spec.k, spec.ef_search
        engine, frontier = spec.engine, spec.frontier
    rng = np.random.default_rng(seed)
    data = lda_like_histograms(rng, n_db + n_queries, dim, alpha=alpha, device=dev)
    Q, rest = split_queries(data, n_queries, rng)
    X = rest[:n_db]
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
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    scenario = {"distance": args.distance, "ef_search": args.ef_search,
                "index_sym": args.index_sym, "builder": args.builder,
                "build_engine": args.build_engine, "wave": args.wave, "engine": args.engine,
                "frontier": args.frontier}
    spec = None
    if args.spec:
        clash = sorted(k for k, v in scenario.items() if v is not None)
        if clash:
            ap.error(f"--spec defines the scenario; conflicting flags: {clash}")
        spec = load_spec(args.spec)
    return build_and_serve(spec=spec, n_db=args.n_db, dim=args.dim, n_queries=args.queries,
                           batch=args.batch, seed=args.seed, device=args.device,
                           **{k: v for k, v in scenario.items() if v is not None})


if __name__ == "__main__":
    print(json.dumps({k: v for k, v in main().items() if k != "spec"}))
