"""Port parity for the construction and search policies as a whole: builds,
rerank, filter-and-refine, the spec algebra and the sealed artifacts.

* NN-descent with ``repro``'s replayed draws under avg, min, reverse and l2
  (kl and renyi_0.25 bases) gives exactly ``repro``'s adjacency.
* A W=16 wave build under ``min`` equals ``repro``'s exactly.
* The rerank searcher (build and search ``min``, k_c 40) over a
  ``repro``-built index returns ``repro``'s ids, ``n_evals`` and hops at
  frontier 1 and 4.
* ``filter_and_refine`` and ``kc_sweep`` return ``repro``'s ids and sweep.
* Every policy kind binds and builds in ``ANNIndex``, with and without a
  rerank spec; ``build_info``'s resolved policies are ``repro``'s.
* Both repo artifacts load through ``load_spec`` with ``repro``'s
  fingerprints; a tampered copy raises.  ``to_json``, ``fingerprint`` and
  ``grid`` are byte-identical for every policy kind.
* The serve entry point takes ``--index-sym`` and ``--spec`` on the CPU.
"""

import copy
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import build_swgraph_wave, get_distance
from repro.core import filter_refine as jfr
from repro.core import nndescent as jnn
from repro.core import spec as jspec
from repro.core.brute_force import knn_scan
from repro.core.index import ANNIndex
from repro.data.synthetic import lda_like_histograms, split_queries, text_collection
from repro_torch.convert import index_from_jax
from repro_torch.core import build_engine as tbe
from repro_torch.core import distances as td
from repro_torch.core import filter_refine as tfr
from repro_torch.core import nndescent as tnn
from repro_torch.core import spec as tspec
from repro_torch.core.index import ANNIndex as TIndex
from repro_torch.data.synthetic import TextCollection
from repro_torch.launch import serve as tserve

from test_torch_nndescent import replay_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, DIM, KNN, ITERS, N_RANDOM = 512, 32, 15, 8, 8
ALL_POLICIES = ["none", "avg", "min", "reverse", "l2", "natural", "max", "blend(0.25)",
                "rankblend(0.5)", "rankblend(0.5,2.0)", "learned"]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the port's lock-step loops launch many tiny ops,
    and a thread pool per test worker oversubscribes the cores (~10x slower
    under parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    X = lda_like_histograms(jax.random.PRNGKey(3), N + 64, DIM)
    return split_queries(X, 64, jax.random.PRNGKey(4))  # (Q, db)


@pytest.mark.parametrize("policy", ["avg", "min", "reverse", "l2"])
@pytest.mark.parametrize("name", ["kl", "renyi_0.25"])
def test_nndescent_under_a_policy_with_replayed_draws(name, policy, data):
    _, db = data
    key = jax.random.PRNGKey(5)
    jdist = jspec.DistancePolicy.parse(policy).bind(get_distance(name))
    want, _ = jnn.build_nndescent(jdist, db, key, K=KNN, iters=ITERS)
    draws = replay_draws(key, N, KNN, ITERS, N_RANDOM, 2 * KNN)
    tdist = tspec.DistancePolicy.parse(policy).bind(td.get_distance(name))
    got, deg = tnn.build_nndescent(tdist, _t(db), K=KNN, iters=ITERS, n_random=N_RANDOM,
                                   draws=draws)
    want = np.asarray(want)
    assert got.shape == want.shape == (N, 2 * KNN)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (deg.numpy() == (got.numpy() >= 0).sum(1)).all()


def test_wave16_build_under_min_equals_jax(data):
    _, db = data
    db = db[:200]
    want, want_deg = build_swgraph_wave(jspec.DistancePolicy("min").bind(get_distance("kl")),
                                        db, NN=8, ef_construction=40, wave=16)
    got, got_deg = tbe.build_swgraph_wave(tspec.DistancePolicy("min").bind(td.get_distance("kl")),
                                          _t(db), NN=8, ef_construction=40, wave=16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))


RERANK = dict(distance="kl", build_policy="min", search_policy="min", k_c=40, NN=10,
              nnd_iters=4, ef_search=32)


@pytest.fixture(scope="module")
def rerank_index(data):
    _, db = data
    return ANNIndex.build(db, spec=jspec.RetrievalSpec(**RERANK), key=jax.random.PRNGKey(1))


@pytest.mark.parametrize("frontier", [1, 4])
def test_rerank_searcher_matches_jax(frontier, data, rerank_index):
    Q, _ = data
    jidx = rerank_index
    arrays = {a: np.asarray(getattr(jidx, a)) for a in ("X", "neighbors", "entries")}
    tidx = index_from_jax(arrays, jidx.spec.to_dict(), device="cpu")
    assert tidx.search_dist.name == jidx.search_dist.name == "kl-min"
    want = [np.asarray(a) for a in jidx.searcher(frontier=frontier)(Q)]
    got = [a.numpy() for a in tidx.searcher(frontier=frontier)(_t(Q))]
    for label, g, w in zip(("ids", "n_evals", "hops"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=label)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert (got[2] >= RERANK["k_c"]).all()  # the rerank's k_c evaluations are counted


def test_policy_builds_select_entries_under_the_search_distance(data):
    """The port's own build under the rerank spec binds both policies and
    serves ascending, finite results."""
    Q, db = data
    tidx = TIndex.build(_t(db), spec=tspec.RetrievalSpec(**RERANK))
    assert tidx.build_info["index_sym_resolved"] == "min"
    assert tidx.build_info["query_sym_resolved"] == "min"
    d, ids, n_evals, hops = tidx.searcher()(_t(Q))
    assert ids.shape == (64, 10) and bool((ids >= 0).all()) and bool(torch.isfinite(d).all())
    assert bool((d[:, 1:] >= d[:, :-1]).all())


@pytest.mark.parametrize("proxy", ["min", "l2", "avg"])
def test_filter_and_refine_and_kc_sweep_match_jax(proxy, data):
    Q, db = data
    Q = Q[:32]
    jorig, torig = get_distance("kl"), td.get_distance("kl")
    jproxy = jspec.DistancePolicy.parse(proxy).bind(jorig)
    tproxy = tspec.DistancePolicy.parse(proxy).bind(torig)
    want_d, want_i = jfr.filter_and_refine(jorig, jproxy, Q, db, 10, 40, chunk=256)
    got_d, got_i = tfr.filter_and_refine(torig, tproxy, _t(Q), _t(db), 10, 40, chunk=256)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    _, true_ids = knn_scan(jorig, Q, db, 10)
    want = jfr.kc_sweep(jorig, jproxy, Q, db, true_ids, k=10, max_pow=4, chunk=256)
    got = tfr.kc_sweep(torig, tproxy, _t(Q), _t(db), _t(true_ids), k=10, max_pow=4, chunk=256)
    assert got == want


def test_rerank_ties_padding_and_modes():
    """Equal distances keep the lower position first; -1 padding ranks last;
    mode="right" ranks by d(q, x)."""
    kl = td.get_distance("kl")
    X = torch.from_numpy(np.random.default_rng(0).dirichlet(np.ones(8), 20).astype(np.float32))
    Q = X[:2]
    cand = torch.tensor([[5, 5, -1, 3, 5], [7, -1, 9, 9, 1]], dtype=torch.int32)
    d, ids = tfr.rerank(kl, Q, X, cand, 5)
    want = kl.query_matrix(Q, X)
    for b in range(2):
        c = [int(i) for i in cand[b] if i >= 0]
        order = sorted(range(len(c)), key=lambda p: (float(want[b, c[p]]), p))
        assert ids[b, :len(c)].tolist() == [c[p] for p in order]
        assert ids[b, 4] == -1 and torch.isinf(d[b, 4])
    _, ids_r = tfr.rerank(kl, Q, X, cand, 4, mode="right")
    d_r = kl.query_matrix(Q, X, mode="right")
    assert float(d_r[1, ids_r[1, 0]]) == float(d_r[1, cand[1][cand[1] >= 0].long()].min())
    with pytest.raises(ValueError, match="mode"):
        tfr.rerank(kl, Q, X, cand, 4, mode="both")


def _learned_weights():
    L = np.random.default_rng(2).normal(size=(DIM, 4)).astype(np.float32) * 0.1
    return {"alpha": 0.75, "beta": 0.3, "tau": None, "L": L.tolist()}


@pytest.mark.parametrize("policy", ALL_POLICIES)
def test_every_policy_kind_binds_and_builds(policy, data):
    """ANNIndex.build + searcher() run under every build policy kind, and
    under it as a rerank search policy; the policies resolve and bind as
    repro's do on the same database."""
    Q, db = data
    X = db[:200]
    natural = None
    dist_j, dist_t = get_distance("kl"), None
    if policy == "natural":
        tc = text_collection(jax.random.PRNGKey(0), n=200, vocab=128, mean_len=20)
        ttc = TextCollection.from_counts(_t(tc.counts))
        X, Q = tc.counts, tc.counts[:16]
        dist_j, dist_t, natural = tc.bm25(), ttc.bm25(), (tc.natural, ttc.natural)
    if policy == "learned":
        w = _learned_weights()
        policy = str(jspec.Learned(w))
        assert str(tspec.Learned(w)) == policy
    want = jspec.DistancePolicy.parse(policy).resolve(dist_j, X)
    want_name = want.bind(dist_j, natural=natural and natural[0]).name
    for search in (False, True):
        changes = dict(build_policy=policy, NN=8, nnd_iters=2, ef_search=24)
        if search:
            changes.update(search_policy=policy, k_c=24)
        tidx = TIndex.build(_t(X), dist_t, spec=tspec.RetrievalSpec(**changes),
                            natural=natural and natural[1])
        keys = ("index_sym_resolved", "query_sym_resolved") if search else ("index_sym_resolved",)
        for key in keys:
            got = tspec.DistancePolicy.parse(tidx.build_info[key])
            assert (got.kind, got.alpha, got.ref) == (want.kind, want.alpha, want.ref)
            assert (got.tau is None) == (want.tau is None)
            if got.tau is not None:
                np.testing.assert_allclose(got.tau, want.tau, rtol=1e-6)
        assert tidx.build_dist.name == want_name
        assert tidx.search_dist.name == (want_name if search else tidx.dist.name)
        d, ids, n_evals, _ = tidx.searcher()(_t(Q[:16]))
        assert ids.shape == (16, 10) and bool((ids >= 0).all())
        assert bool(torch.isfinite(d).all())


@pytest.mark.parametrize("path", ["TUNED_spec.json", "LEARNED_weights.json"])
def test_repo_artifacts_load_with_the_same_fingerprints(path, tmp_path):
    src = ROOT / path
    want = jspec.load_spec(str(src))
    got = tspec.load_spec(str(src))
    assert got.fingerprint() == want.fingerprint() and got.to_json() == want.to_json()
    doc = json.loads(src.read_text())
    assert tspec.load_spec(doc) == got == tspec.load_spec(src.read_text())
    if path.startswith("LEARNED"):
        # the weights are registered: the learned policy binds on its own
        assert got.bind_build().name == f"negdot-learned({got.build_policy.ref})"
        bad = copy.deepcopy(doc)
        bad["weights"]["alpha"] = 0.5
        with pytest.raises(ValueError, match="weights fingerprint mismatch"):
            tspec.load_spec(bad)
        bad = copy.deepcopy(doc)
        bad["spec"]["ef_search"] += 1
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            tspec.load_spec(bad)
    else:
        bad = copy.deepcopy(doc)
        bad["tuned_spec"]["ef_search"] += 1
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            tspec.load_spec(bad)
        tampered = tmp_path / "tampered.json"
        tampered.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            tspec.load_spec(str(tampered))
    with pytest.raises(ValueError, match="not a"):
        tspec.load_tuned_artifact(dict(doc, kind="other"))
    with pytest.raises(ValueError, match="not a"):
        tspec.load_learned_artifact(dict(doc, kind="other"))


def test_artifact_writers_match():
    w = _learned_weights()
    for mod in (jspec, tspec):
        mod.Learned(w)
    spec_j = jspec.RetrievalSpec(distance="negdot", build_policy=str(jspec.Learned(w)))
    spec_t = tspec.RetrievalSpec.from_dict(spec_j.to_dict())
    assert (json.dumps(tspec.learned_artifact(spec_t, w, {"recall": 0.5}), sort_keys=True)
            == json.dumps(jspec.learned_artifact(spec_j, w, {"recall": 0.5}), sort_keys=True))
    frontier = [(spec_t.replace(ef_search=e), {"recall": e / 100}) for e in (16, 32)]
    frontier_j = [(spec_j.replace(ef_search=e), {"recall": e / 100}) for e in (16, 32)]
    assert (json.dumps(tspec.tuned_artifact(spec_t, {"recall": 0.9}, frontier=frontier),
                       sort_keys=True)
            == json.dumps(jspec.tuned_artifact(spec_j, {"recall": 0.9}, frontier=frontier_j),
                          sort_keys=True))
    with pytest.raises(ValueError, match="does not reference"):
        tspec.learned_artifact(spec_t.replace(build_policy="none"), w, {})


@pytest.mark.parametrize("policy", ["none", "avg", "min", "reverse", "l2", "natural", "max",
                                    "blend(0.3)", "rankblend(0.5)", "rankblend(0.6,2.0)",
                                    "learned(58d1967c9ff3)"])
def test_spec_json_fingerprint_and_grid_byte_identical(policy):
    changes = dict(build_policy=policy, search_policy=policy if policy != "none" else "none")
    j, t = jspec.RetrievalSpec(**changes), tspec.RetrievalSpec(**changes)
    assert t.to_json() == j.to_json() and t.fingerprint() == j.fingerprint()
    axes = dict(ef_search=[32, 96], build_policy=[policy, "blend(0.75)"], frontier=[1, 4])
    assert [s.to_json() for s in t.grid(**axes)] == [s.to_json() for s in j.grid(**axes)]
    assert t.grid() == [t]
    for ctor in ("Blend", "RankBlend"):
        assert str(getattr(tspec, ctor)(0.25)) == str(getattr(jspec, ctor)(0.25))
    assert str(tspec.MaxSym()) == str(jspec.MaxSym()) == "max"
    assert str(tspec.RankBlend(0.25, None)) == str(jspec.RankBlend(0.25, None))


def test_dominates_and_pareto_frontier_match():
    rng = np.random.default_rng(3)
    pts = [{"recall": float(r), "evals": float(e)}
           for r, e in zip(rng.integers(0, 5, 30) / 4, rng.integers(0, 6, 30))]
    kw = dict(maximize=("recall",), minimize=("evals",))
    assert tspec.pareto_frontier(pts, **kw) == jspec.pareto_frontier(pts, **kw)
    for a in pts[:6]:
        for b in pts[:6]:
            assert tspec.dominates(a, b, **kw) == jspec.dominates(a, b, **kw)
    with pytest.raises(ValueError):
        tspec.dominates(pts[0], pts[1])


def test_serve_takes_index_sym_and_the_repo_artifacts():
    base = ["--device", "cpu", "--n-db", "200", "--queries", "16", "--batch", "16"]
    stats = tserve.main(base + ["--index-sym", "min"])
    assert stats["spec"]["build_policy"] == "min" and stats["index_sym_resolved"] == "min"
    assert stats["recall@k"] > 0.8
    for path in ("TUNED_spec.json", "LEARNED_weights.json"):
        stats = tserve.main(base + ["--spec", str(ROOT / path)])
        assert stats["spec_fingerprint"] == jspec.load_spec(str(ROOT / path)).fingerprint()
        assert stats["recall@k"] > 0.4
    with pytest.raises(SystemExit):
        tserve.main(base + ["--spec", str(ROOT / "TUNED_spec.json"), "--ef", "64"])
