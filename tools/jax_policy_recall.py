"""Recall@10 of the JAX package for each construction policy: the floors
that ``chip_smoke.py`` (phase 14, ``JAX_RECALL``) holds the port to.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_policy_recall.py [--bm25-docs 4000] \
        [--runs serve bm25 churn continuous sharded]

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

Everything is drawn from fixed ``jax.random`` keys: the same numbers on
every run.  A JAX program: run it where the JAX package runs.
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


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bm25-docs", type=int, default=4000)
    ap.add_argument("--runs", nargs="+",
                    choices=("serve", "bm25", "churn", "continuous", "sharded"),
                    default=["serve", "bm25", "churn", "continuous", "sharded"])
    args = ap.parse_args(argv)
    make = {"serve": serve_runs, "bm25": lambda: bm25_runs(args.bm25_docs),
            "churn": churn_runs, "continuous": continuous_runs, "sharded": sharded_runs}
    for runs in (make[name]() for name in args.runs):
        t0 = time.perf_counter()
        for label, recall, *extra in runs:
            print(json.dumps({"run": label, "recall@k": recall, **(extra[0] if extra else {}),
                              "cpu_wall_s": time.perf_counter() - t0}), flush=True)
            jax.clear_caches()  # many fresh jitted closures exhaust the CPU linker
            t0 = time.perf_counter()


if __name__ == "__main__":
    main()
