"""Port parity for learned construction distances (``repro_torch.core.learned``
and ``core.metric_learning``).

``tests/test_learned.py``'s ``tiny_fit`` workload (KL, n = 420, 24
calibration queries, d = 16, K = 5, SW-graph wave 32, NN 8, ef_construction
40; rank 8, 20 steps, 64 anchors, k_pos 5, alphas (0.75, 1), betas (0.5,))
runs through both packages on the same arrays:

  * ``true_neighbor_ids`` equals ``repro``'s ids, also where self is not
    rank 0 (negdot, rows doubled);
  * ``fit_mahalanobis_map`` with ``repro``'s draws replayed (anchors, L0,
    and each step's batch) gives ``repro``'s L within atol 1e-5 (20 steps
    of float32 SGD summed in another order);
  * ``_median_scales`` on the same L agrees within 1e-6 relative;
  * ``fit_construction_distance`` with ``repro``'s L, beta_unit and tau_cal
    replayed (``terms``; an ulp of L changes every weights fingerprint and
    so the candidates' order) and its shared build's entry points replayed
    (``entries=``) gives every row's recall and evals exactly, the same
    winner and the same artifact fingerprints.

Then ``test_learned.py``'s contracts on the port's own fit: learned >= the
anchor at no more evals, determinism, tamper rejection, and the slot
scheduler serving the learned spec.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import RetrievalSpec as JSpec
from repro.core import fit_construction_distance as jfit
from repro.core import true_neighbor_ids as jtrue_neighbor_ids
from repro.core.batched_beam import select_entries as jselect_entries
from repro.core.distances import get_distance as jget_distance
from repro.core.learned import _median_scales as jmedian_scales
from repro.core.metric_learning import fit_mahalanobis_map as jfit_map
from repro.core.symmetrize import calibrate_tau as jcalibrate_tau
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch.convert import mahalanobis_from_jax
from repro_torch.core.distances import get_distance
from repro_torch.core.index import ANNIndex
from repro_torch.core.learned import (LearnedTerms, _median_scales,
                                      fit_construction_distance, mahalanobis_weights)
from repro_torch.core.metric_learning import (BATCH, MahalanobisDraws, fit_mahalanobis_map,
                                              learn_mahalanobis, true_neighbor_ids)
from repro_torch.core.spec import RetrievalSpec, load_learned_artifact, load_spec
from repro_torch.core.symmetrize import learned_weights_fingerprint

K = 5
BASE_KW = dict(distance="kl", builder="swgraph", build_engine="wave", wave=32, NN=8,
               ef_construction=40, k=K, ef_search=16, frontier=1)
FIT_KW = dict(rank=8, steps=20, n_anchors=64, k_pos=5, alphas=(0.75, 1.0), betas=(0.5,),
              verbose=False)
MAP_KW = dict(rank=8, steps=20, n_anchors=64, k_pos=5)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores (the port's lock-step loops run ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def workload():
    key = jax.random.PRNGKey(0)
    data = lda_like_histograms(key, 420 + 24, 16)
    Q, X = split_queries(data, 24, jax.random.fold_in(key, 1))
    return np.asarray(X), np.asarray(Q)


def repro_map_draws(key, n: int, m: int, rank: int, steps: int, n_anchors: int,
                    k_pos: int) -> MahalanobisDraws:
    """``repro.core.metric_learning.fit_mahalanobis_map``'s draws from ``key``."""
    k1, k2, k3 = jax.random.split(key, 3)
    anchors = jax.random.choice(k1, n, (min(n_anchors, n),), replace=False)
    L0 = jax.random.normal(k2, (m, min(rank, m))) / jnp.sqrt(m)
    idx, pos, neg = [], [], []
    for i in range(steps):
        ka, kp, kn = jax.random.split(jax.random.fold_in(k3, i), 3)
        idx.append(jax.random.randint(ka, (BATCH,), 0, anchors.shape[0]))
        pos.append(jax.random.randint(kp, (BATCH, 1), 0, k_pos)[:, 0])
        neg.append(jax.random.randint(kn, (BATCH,), 0, n))
    return MahalanobisDraws(*(_t(a) for a in (anchors, L0, jnp.stack(idx), jnp.stack(pos),
                                              jnp.stack(neg))))


def test_true_neighbor_ids_equal_repro(workload):
    X, _ = workload
    anchors = np.arange(0, 420, 7)
    for name in ("kl", "negdot"):
        want = np.asarray(jtrue_neighbor_ids(jget_distance(name), jnp.asarray(X),
                                             jnp.asarray(anchors), 5))
        got = true_neighbor_ids(get_distance(name), _t(X), _t(anchors), 5)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_true_neighbor_ids_masks_self_by_id_not_position():
    """negdot: d(u, u) = -||u||^2 but d(u, 2u) = -2||u||^2, so self is not
    rank 0; the id mask drops the anchor and keeps the doubled row."""
    rng = np.random.RandomState(0)
    U = rng.randn(6, 8).astype(np.float32)
    X = np.concatenate([U, 2.0 * U]).astype(np.float32)
    anchors = np.arange(6)
    got = true_neighbor_ids(get_distance("negdot"), _t(X), _t(anchors), 3).numpy()
    want = np.asarray(jtrue_neighbor_ids(jget_distance("negdot"), jnp.asarray(X),
                                         jnp.asarray(anchors), 3))
    np.testing.assert_array_equal(got, want)
    for i in range(6):
        assert i not in got[i] and i + 6 in got[i]


def test_fit_mahalanobis_map_with_replayed_draws_matches_repro(workload):
    X, _ = workload
    jdist, dist = jget_distance("kl"), get_distance("kl")
    key = jax.random.PRNGKey(4)
    want = np.asarray(jfit_map(jnp.asarray(X), jdist, key, **MAP_KW))
    draws = repro_map_draws(key, X.shape[0], X.shape[1], **MAP_KW)
    got = fit_mahalanobis_map(_t(X), dist, draws=draws, **MAP_KW)
    assert got.shape == want.shape == (16, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert not np.allclose(got.numpy(), draws.L0.numpy(), atol=1e-3)  # the fit moved L
    # the learned proxy: squared L2 between mapped rows
    proxy = learn_mahalanobis(_t(X), dist, torch.Generator().manual_seed(0), **MAP_KW)
    D = proxy.matrix(_t(X[:5]), _t(X[:5]))
    assert bool((D.diagonal().abs() < 1e-5).all()) and torch.allclose(D, D.T, atol=1e-5)


def test_median_scales_match_repro(workload):
    X, _ = workload
    L = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (16, 8)), np.float32)
    want = jmedian_scales(jget_distance("kl"), L, jnp.asarray(X))
    got = _median_scales(get_distance("kl"), mahalanobis_from_jax(L, device="cpu"), _t(X))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def fit_pair(workload):
    """repro's fit, and the port's with repro's terms and entries replayed."""
    X, Q = workload
    jdist = jget_distance("kl")
    jres = jfit(X, Q, base=JSpec(**BASE_KW), **FIT_KW)
    # repro's internal terms, recomputed exactly as fit_construction_distance does
    k_fit, k_build = jax.random.split(jax.random.PRNGKey(0))
    L = jfit_map(jnp.asarray(X), jdist, k_fit, **MAP_KW)
    med_base, med_maha = jmedian_scales(jdist, L, jnp.asarray(X))
    terms = LearnedTerms(mahalanobis_from_jax(np.asarray(L), device="cpu"), med_base / med_maha,
                         jcalibrate_tau(jdist, jnp.asarray(X)))
    entries = jselect_entries(jdist, jnp.asarray(X), n_entries=JSpec(**BASE_KW).n_entries,
                              key=jax.random.fold_in(jax.random.fold_in(k_build, 0xB), 0xE))
    tres = fit_construction_distance(_t(X), _t(Q), base=RetrievalSpec(**BASE_KW),
                                     terms=terms, entries=_t(entries),
                                     **FIT_KW)
    return jres, tres


def test_replayed_fit_gives_repro_rows_and_winner(fit_pair):
    jres, tres = fit_pair
    assert tres.anchor == jres.anchor
    assert [dict(c) for c in tres.candidates] == [dict(c) for c in jres.candidates]
    assert tres.fingerprint == jres.fingerprint
    assert tres.weights == jres.weights
    assert tres.objectives == jres.objectives
    assert tres.spec.to_dict() == jres.spec.to_dict()
    assert tres.calibration == jres.calibration
    tart, jart = tres.artifact(), jres.artifact()
    assert (tart["weights_fingerprint"], tart["spec_fingerprint"]) == (
        jart["weights_fingerprint"], jart["spec_fingerprint"])
    assert json.dumps(tart, sort_keys=True) == json.dumps(jart, sort_keys=True)


@pytest.fixture(scope="module")
def own_fit(workload):
    X, Q = workload
    return fit_construction_distance(_t(X), _t(Q), base=RetrievalSpec(**BASE_KW), **FIT_KW)


def test_fit_beats_or_matches_the_anchor(own_fit):
    res = own_fit
    assert res.objectives["recall"] >= res.anchor["recall"]
    assert res.objectives["evals_per_query"] <= res.anchor["evals_per_query"]
    assert res.spec.build_policy.kind == "learned"
    assert res.spec.build_policy.ref == res.fingerprint
    clone_fp = learned_weights_fingerprint(mahalanobis_weights(None, 0.75, 0.0))
    clones = [c for c in res.candidates if c["weights_fingerprint"] == clone_fp]
    assert len(clones) == 1
    assert clones[0]["recall"] == res.anchor["recall"]
    assert clones[0]["evals_per_query"] == res.anchor["evals_per_query"]
    assert len(res.candidates) == 4  # the clone, 2 alphas x 1 beta, 1 rankblend proxy


def test_fit_is_deterministic(own_fit, workload):
    X, Q = workload
    again = fit_construction_distance(_t(X), _t(Q), base=RetrievalSpec(**BASE_KW), **FIT_KW)
    assert again.fingerprint == own_fit.fingerprint
    assert again.weights == own_fit.weights
    assert json.dumps(again.artifact(), sort_keys=True) == json.dumps(own_fit.artifact(),
                                                                      sort_keys=True)


def test_artifact_roundtrip_and_tamper_rejection(own_fit, workload, tmp_path):
    X, Q = workload
    path = tmp_path / "LEARNED_weights.json"
    art = own_fit.save(str(path))
    assert "frontier" not in art
    spec, doc = load_learned_artifact(str(path))
    assert spec == own_fit.spec and doc["weights_fingerprint"] == own_fit.fingerprint
    assert load_spec(str(path)) == own_fit.spec
    idx = ANNIndex.build(_t(X), spec=spec)
    _, ids, _, _ = idx.searcher(spec=spec)(_t(Q))
    assert tuple(ids.shape) == (Q.shape[0], K)
    tampered = dict(art, weights=dict(art["weights"], alpha=0.9))
    with pytest.raises(ValueError, match="weights fingerprint mismatch"):
        load_learned_artifact(tampered)
    with pytest.raises(ValueError):
        load_learned_artifact(dict(art, spec=dict(art["spec"], ef_search=999)))
    # repro reads the port's artifact
    from repro.core import load_spec as jload_spec

    assert jload_spec(str(path)).to_dict() == own_fit.spec.to_dict()


def test_scheduler_serves_the_learned_spec(own_fit, workload):
    X, Q = workload
    spec = own_fit.spec
    idx = ANNIndex.build(_t(X), spec=spec)
    _, ids, _, _ = idx.searcher(spec=spec)(_t(Q))
    out = idx.scheduler(spec=spec, frontier=spec.frontier).run_stream(_t(Q))
    assert [r.rid for r in out] == list(range(Q.shape[0]))
    got = np.stack([np.asarray(r.ids) for r in sorted(out, key=lambda r: r.rid)])
    np.testing.assert_array_equal(got, ids.numpy())
