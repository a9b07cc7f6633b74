"""Recall@10 of the JAX package for each construction policy: the floors
that ``chip_smoke.py`` (phase 14, ``JAX_RECALL``) holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_policy_recall.py [--bm25-docs 4000] \
        [--runs serve bm25 churn continuous sharded autotune learned]

One JSON line per run:

* ``repro.launch.serve.build_and_serve`` at its defaults (n=20,000, d=32,
  KL, NN-descent, ef 96, frontier 4, 256 queries) with ``index_sym`` each
  of avg, min, reverse, l2, max, blend(0.25) and rankblend(0.5), then with
  ``spec=load_spec(...)`` of ``TUNED_spec.json`` and ``LEARNED_weights.json``;
* BM25 on the Manner proxy of ``benchmarks/datasets.py`` (vocab 2,048,
  mean 60 terms, 256 held-out queries), NN-descent at the serve defaults
  built under ``none`` and under ``natural``, searched under BM25.  The JAX
  package scores a viewed distance by gathering its rows, about 2.2 GB per
  1,000 documents, so keep ``--bm25-docs`` within the host's memory;
* churn: ``build_and_serve`` at its defaults with ``--churn-rounds 4
  --churn-insert 256 --churn-delete 200`` (the online index), whose
  ``recall@k_after_churn`` is the floor of ``chip_smoke.py``'s phase 15
  (``JAX_CHURN_RECALL``);
* continuous: ``build_and_serve`` at its defaults with ``continuous=True``
  (48 slots, frontier 12, utilization 0.4: the slot scheduler over a
  Poisson trace), whose continuous ``recall@k`` is the floor of
  ``chip_smoke.py``'s phase 17 (``JAX_CONTINUOUS_RECALL``); the line also
  carries the static line's recall.  The recall does not depend on the
  trace: a query's result is the same whenever it is admitted;
* sharded: ``repro.launch.serve.main(["--shards", "4"])`` (its CLI
  defaults: n=20,000, d=32, KL, NN 15, 8 rounds, 32 slots, ef 96, 256
  queries; ``build_and_serve_sharded``), then with ``--drop-shards 1``,
  whose ``recall@k`` are the floors of ``chip_smoke.py``'s phase 19
  (``JAX_SHARDED_RECALL``).  Each runs in a subprocess that forces 4 host
  devices before JAX starts; the line carries the replicated recall and
  the gap.

* autotune: ``repro.core.autotune`` on ``benchmarks/bench_autotune.py``'s
  full workload, drawn as ``chip_smoke.py``'s phase 21 draws it (the port's
  ``lda_like_histograms`` and ``split_queries`` from
  ``numpy.random.default_rng(0)``: KL, n = 4,096, d = 32, 128 queries split
  64 calibration / 64 holdout): SW-graph wave 64, NN 15, ef_construction
  100, the bench's full axes, 3 rungs, the hand anchor ``blend(0.75)/ef 32``;
  the tuned spec is ``pick(max_evals=hand)``.  Its holdout recall is the
  floor of phase 21 (``JAX_TUNED``); the line carries its fingerprint;
* learned: ``repro.core.fit_construction_distance`` on
  ``benchmarks/bench_learned.py``'s workload B at full size, on the port's
  text collection (``numpy.random.default_rng(5)``: 2,048 documents plus 64
  queries, vocab 1,024, split 32 / 32): BM25, the same base spec, rank 16,
  150 steps, 256 anchors, seed 1, and the ``natural`` context row.  The
  learned spec's holdout recall is the floor of phase 22 (``JAX_LEARNED``).

Everything is drawn from fixed ``jax.random`` keys or numpy seeds: the same
numbers on every run.  A JAX program (the last two runs also import the
port's numpy data generators): run it where the JAX package runs.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np

from repro.core.brute_force import knn_scan
from repro.core.index import ANNIndex
from repro.core.metrics import recall_at_k
from repro.core.spec import RetrievalSpec, load_spec
from repro.data.synthetic import split_queries, text_collection
from repro.launch.serve import build_and_serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("avg", "min", "reverse", "l2", "max", "blend(0.25)", "rankblend(0.5)")
ARTIFACTS = ("TUNED_spec.json", "LEARNED_weights.json")
CHURN = dict(churn_rounds=4, churn_insert=256, churn_delete=200)


def serve_runs():
    for policy in POLICIES:
        yield policy, build_and_serve(index_sym=policy, verbose=False)["recall@k"]
    for name in ARTIFACTS:
        spec = load_spec(str(ROOT / name))
        yield name, build_and_serve(spec=spec, verbose=False)["recall@k"]


def bm25_runs(n_db: int, n_q: int = 256):
    tc = text_collection(jax.random.PRNGKey(5), n=n_db + n_q, vocab=2048, mean_len=60)
    Q, X = split_queries(tc.counts, n_q, jax.random.PRNGKey(6))
    dist = tc.bm25()
    _, true_ids = knn_scan(dist, Q, X, 10)
    for policy in ("none", "natural"):
        spec = RetrievalSpec(distance="bm25", build_policy=policy, NN=15, ef_search=96,
                             frontier=4, n_entries=4)
        idx = ANNIndex.build(X, dist, spec=spec, key=jax.random.PRNGKey(7), natural=tc.natural)
        search = idx.searcher()
        ids = np.concatenate([np.asarray(search(Q[lo:lo + 64])[1]) for lo in range(0, n_q, 64)])
        yield f"bm25 {policy} n={n_db}", recall_at_k(ids, np.asarray(true_ids))


def churn_runs():
    churn = build_and_serve(verbose=False, **CHURN)["churn"]
    yield "churn", churn["recall@k_after_churn"]


def continuous_runs():
    st = build_and_serve(verbose=False, continuous=True)
    yield "continuous", st["continuous"]["recall@k"], {"static_recall@k": st["recall@k"]}


SHARDED = {"sharded": ["--shards", "4"],
           "sharded drop 1": ["--shards", "4", "--drop-shards", "1"]}
SHARDED_RUN = """
import json, sys
from repro.launch.serve import main
st = main(sys.argv[1:])
print(json.dumps(st))
"""


def sharded_runs():
    # the forced host device count is read once, when the JAX backend starts:
    # each run gets a process of its own
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    for label, argv in SHARDED.items():
        proc = subprocess.run([sys.executable, "-c", SHARDED_RUN, *argv], env=env,
                              capture_output=True, text=True, check=True)
        st = json.loads(proc.stdout.strip().splitlines()[-1])
        yield label, st["recall@k"], {k: st[k] for k in ("replicated_recall@k", "recall_gap",
                                                         "rows_per_shard", "drop_shards")}


# phase 21 of chip_smoke.py: bench_autotune.py's full workload
TUNE_N, TUNE_Q, TUNE_DIM = 4096, 128, 32
TUNE_BASE = dict(distance="kl", builder="swgraph", build_engine="wave", wave=64, NN=15,
                 ef_construction=100, k=10, frontier=1)
HAND_ALPHA, HAND_EF = 0.75, 32
# phase 22: bench_learned.py's workload B at full size
BM25_DOCS, BM25_Q, BM25_VOCAB = 2048, 64, 1024


def tune_axes():
    from repro.core import Blend

    return dict(build_policy=[Blend(a) for a in (0.0, 0.25, 0.5, 0.75, 1.0)],
                ef_search=[16, 32, 96], frontier=[1, 2], adaptive=[False, True],
                patience=[1, 2])


def _holdout(spec, X, Q, true_np, key, dist=None, natural=None):
    idx = ANNIndex.build(X, dist, spec=spec, key=key, natural=natural)
    _, ids, n_evals, _ = idx.searcher(spec=spec)(Q)
    return {"recall@10": round(recall_at_k(np.asarray(ids), true_np), 4),
            "evals_per_query": round(float(np.mean(np.asarray(n_evals))), 1)}


def autotune_runs():
    import jax.numpy as jnp
    from repro.core import Blend, autotune
    from repro_torch.data.synthetic import lda_like_histograms as port_histograms
    from repro_torch.data.synthetic import split_queries as port_split

    rng = np.random.default_rng(0)
    Q, X = port_split(port_histograms(rng, TUNE_N + TUNE_Q, TUNE_DIM, device="cpu"),
                      TUNE_Q, rng)
    X, Q = jnp.asarray(X.numpy()), jnp.asarray(Q.numpy())
    Q_cal, Q_hold = Q[:TUNE_Q // 2], Q[TUNE_Q // 2:]
    base = RetrievalSpec(**TUNE_BASE)
    hand = base.replace(build_policy=Blend(HAND_ALPHA), ef_search=HAND_EF)
    res = autotune(np.asarray(X), np.asarray(Q_cal), base=base, axes=tune_axes(),
                   anchors=[hand], k=10, rungs=3, seed=0, verbose=False)
    hand_c = res.lookup(hand)
    choice = res.pick(max_evals=hand_c.objectives["evals_per_query"])
    _, true_ids = knn_scan(base.base_distance(), Q_hold, X, 10)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 2)
    held = {name: _holdout(spec, X, Q_hold, np.asarray(true_ids), key)
            for name, spec in (("hand", hand), ("tuned", choice.spec))}
    yield "autotune", held["tuned"]["recall@10"], {
        "tuned_spec_fingerprint": choice.fingerprint, "tuned_spec": choice.spec.to_dict(),
        "tuned_cal": choice.objectives, "hand_cal": hand_c.objectives,
        "holdout": held, "rungs": [[h["n"], len(h["evaluated"]), len(h["survivors"])]
                                   for h in res.history]}


def learned_runs():
    import jax.numpy as jnp
    from repro.core import Blend, fit_construction_distance
    from repro.data.synthetic import TextCollection
    from repro_torch.data.synthetic import text_collection as port_text

    counts = port_text(np.random.default_rng(5), BM25_DOCS + BM25_Q, vocab=BM25_VOCAB,
                       device="cpu").counts.numpy()
    n = counts.shape[0]
    df = np.sum(counts > 0, axis=0).astype(np.float32)
    tc = TextCollection(counts=jnp.asarray(counts),
                        idf=jnp.log(1.0 + (n - jnp.asarray(df) + 0.5) / (jnp.asarray(df) + 0.5)),
                        avg_len=float(np.mean(counts.sum(axis=1, dtype=np.float64))))
    X, Q = jnp.asarray(counts[:BM25_DOCS]), jnp.asarray(counts[BM25_DOCS:])
    Q_cal, Q_hold = Q[:BM25_Q // 2], Q[BM25_Q // 2:]
    dist = tc.bm25()
    base = RetrievalSpec(**dict(TUNE_BASE, distance="bm25"), ef_search=HAND_EF)
    res = fit_construction_distance(X, Q_cal, base=base, dist=dist, natural=tc.natural,
                                    hand_policy=Blend(HAND_ALPHA), rank=16, steps=150,
                                    n_anchors=256, seed=1, verbose=False)
    key = jax.random.PRNGKey(17)
    _, true_hold = knn_scan(dist, Q_hold, X, 10)
    held = {name: _holdout(spec, X, Q_hold, np.asarray(true_hold), key, dist, tc.natural)
            for name, spec in (("hand", base.replace(build_policy=Blend(HAND_ALPHA))),
                               ("learned", res.spec))}
    _, true_cal = knn_scan(dist, Q_cal, X, 10)
    natural = _holdout(base.replace(build_policy="natural"), X, Q_cal, np.asarray(true_cal),
                       key, dist, tc.natural)
    yield "learned bm25", held["learned"]["recall@10"], {
        "weights_fingerprint": res.fingerprint, "build_policy": str(res.spec.build_policy),
        "learned_cal": res.objectives, "hand_cal": res.anchor, "holdout": held,
        "natural_cal": natural, "calibration": res.calibration}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bm25-docs", type=int, default=4000)
    ap.add_argument("--runs", nargs="+",
                    choices=("serve", "bm25", "churn", "continuous", "sharded", "autotune",
                             "learned"),
                    default=["serve", "bm25", "churn", "continuous", "sharded", "autotune",
                             "learned"])
    args = ap.parse_args(argv)
    make = {"serve": serve_runs, "bm25": lambda: bm25_runs(args.bm25_docs),
            "churn": churn_runs, "continuous": continuous_runs, "sharded": sharded_runs,
            "autotune": autotune_runs, "learned": learned_runs}
    for runs in (make[name]() for name in args.runs):
        t0 = time.perf_counter()
        for label, recall, *extra in runs:
            print(json.dumps({"run": label, "recall@k": recall, **(extra[0] if extra else {}),
                              "cpu_wall_s": time.perf_counter() - t0}), flush=True)
            jax.clear_caches()  # many fresh jitted closures exhaust the CPU linker
            t0 = time.perf_counter()


if __name__ == "__main__":
    main()
