"""Port parity: the batched beam engine against ``repro.core.batched_beam``.

The graph is built by the JAX package and handed over as numpy arrays; both
engines search it from the same entries.  Under ``kl`` and ``renyi_0.25`` the
beams' ids, the eval counts and the hop counts must be exactly equal to the
JAX default CPU searcher, and the beams' distances equal to 1e-6 (float32
dot products summed in another order).  Under ``l2`` the seed's own engine
is not exact against its reference (ROADMAP section 3), so the gate there is
distances within 1e-5 and recall within 0.005.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ANNIndex, get_distance, knn_scan, make_step_searcher, recall_at_k
from repro.core import batched_beam as jbb
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch.core import batched_beam as tbb
from repro_torch.core import distances as td

N_DB, N_Q, DIM, K, EF = 600, 16, 16, 10, 48


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.fixture(scope="module")
def data():
    X = lda_like_histograms(jax.random.PRNGKey(0), N_DB + N_Q, DIM)
    Q, db = split_queries(X, N_Q, jax.random.PRNGKey(1))
    return Q, db


@pytest.fixture(scope="module")
def graphs(data):
    _, db = data
    out = {}
    for name in ("kl", "renyi_0.25", "l2"):
        idx = ANNIndex.build(db, get_distance(name), builder="nndescent", NN=10,
                             nnd_iters=6, key=jax.random.PRNGKey(2))
        out[name] = idx
    return out


def _both(name, idx, db, Q, frontier, adaptive=False):
    jeng = make_step_searcher(get_distance(name), idx.neighbors, db, ef=EF, k=K,
                              entries=idx.entries, frontier=frontier, adaptive=adaptive)
    teng = tbb.make_step_searcher(td.get_distance(name), _t(idx.neighbors), _t(db), ef=EF,
                                  k=K, entries=_t(idx.entries), frontier=frontier,
                                  adaptive=adaptive)
    want = [np.asarray(a) for a in jeng(Q)]
    got = [a.numpy() for a in teng(_t(Q))]
    return want, got


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("frontier", [1, 4])
@pytest.mark.parametrize("name", ["kl", "renyi_0.25"])
def test_searcher_exact_parity(name, frontier, adaptive, data, graphs):
    Q, db = data
    (d1, i1, e1, h1), (d2, i2, e2, h2) = _both(name, graphs[name], db, Q, frontier, adaptive)
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_array_equal(e2, e1)
    np.testing.assert_array_equal(h2, h1)
    np.testing.assert_allclose(d2, d1, rtol=1e-6, atol=1e-6)
    assert i2.dtype == np.int32 and e2.dtype == np.int32


@pytest.mark.parametrize("frontier", [1, 4])
def test_searcher_l2_within_tolerance(frontier, data, graphs):
    Q, db = data
    (d1, i1, _, _), (d2, i2, _, _) = _both("l2", graphs["l2"], db, Q, frontier)
    np.testing.assert_allclose(d2, d1, rtol=1e-5, atol=1e-5)
    _, true_ids = knn_scan(get_distance("l2"), Q, db, K)
    r_jax = recall_at_k(i1, np.asarray(true_ids))
    r_port = recall_at_k(i2, np.asarray(true_ids))
    assert abs(r_port - r_jax) <= 0.005, (r_port, r_jax)


def test_batched_beam_search_state_matches(data, graphs):
    """The raw engine state (full beams, expanded flags, visited words)."""
    Q, db = data
    idx = graphs["kl"]
    jd_, tdist = get_distance("kl"), td.get_distance("kl")
    jc, tc = jd_.prep_scan(db), tdist.prep_scan(_t(db))
    jq = jax.vmap(jd_.prep_query)(Q)
    tq_rep, tq_bias = tdist.prep_right(_t(Q)), tdist.bias_right(_t(Q))
    from repro.kernels.ops import frontier_gather_scores as jfg
    from repro_torch.kernels.ops import frontier_gather_scores as tfg

    js = jbb.batched_beam_search(
        idx.neighbors, lambda ids: jfg(jd_, ids, jq["rep"], jq["bias"], jc["rep"], jc["bias"]),
        idx.entries, N_Q, EF, frontier=2)
    ts = tbb.batched_beam_search(
        _t(idx.neighbors), lambda ids: tfg(tdist, ids.contiguous(), tq_rep, tq_bias,
                                           tc["rep"], tc["bias"]),
        _t(idx.entries), N_Q, EF, frontier=2)
    np.testing.assert_array_equal(ts.beam_i.numpy(), np.asarray(js.beam_i))
    np.testing.assert_array_equal(ts.expanded.numpy(), np.asarray(js.expanded))
    np.testing.assert_array_equal(ts.visited.numpy(), np.asarray(js.visited).view(np.int32))
    np.testing.assert_array_equal(ts.done.numpy(), np.asarray(js.done))


def test_bitonic_merge_equals_stable_argsort():
    rng = np.random.default_rng(0)
    B, ef, C = 7, 12, 9
    # few distinct values: many exact ties across and within the two inputs
    bd = np.sort(rng.integers(0, 6, (B, ef)).astype(np.float32), axis=1)
    kd = np.sort(rng.integers(0, 6, (B, C)).astype(np.float32), axis=1)
    bd[:, -2:] = np.inf
    bi = rng.integers(0, 100, (B, ef)).astype(np.int32)
    ki = rng.integers(0, 100, (B, C)).astype(np.int32)
    be, ke = rng.random((B, ef)) < 0.5, rng.random((B, C)) < 0.5
    got = tbb._merge_beams((_t(bd), _t(bi), _t(be)), (_t(kd), _t(ki), _t(ke)), ef)
    order = np.argsort(np.concatenate([bd, kd], 1), axis=1, kind="stable")[:, :ef]
    for g, cat in zip(got, (np.concatenate([bd, kd], 1), np.concatenate([bi, ki], 1),
                            np.concatenate([be, ke], 1))):
        np.testing.assert_array_equal(g.numpy(), np.take_along_axis(cat, order, 1))
    want = jbb._bitonic_merge((jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(be)),
                              (jnp.asarray(kd), jnp.asarray(ki), jnp.asarray(ke)), ef)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_tie_rule_matches_lax_top_k():
    """Equal values: the lower index comes first, as in ``jax.lax.top_k``."""
    x = np.array([[3, 1, 2, 1, 1, np.inf, 2], [5, 5, 5, 5, 0, 0, 5]], np.float32)
    vals, idx = tbb._smallest(_t(x), 5)
    neg, jidx = jax.lax.top_k(-jnp.asarray(x), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(idx.numpy()[1], [4, 5, 0, 1, 2])


@pytest.mark.parametrize("n_entries", [1, 4])
@pytest.mark.parametrize("name", ["kl", "itakura_saito"])
def test_select_entries_with_injected_draws(name, n_entries, data):
    _, db = data
    key = jax.random.PRNGKey(7)
    want = np.asarray(jbb.select_entries(get_distance(name), db, n_entries, key=key,
                                         sample=64))
    # replay the JAX draws: the same key split, the same choices
    k_sample, k_rand = jax.random.split(key)
    probe = jax.random.choice(k_sample, N_DB, (64,), replace=False)
    rand = jax.random.choice(k_rand, N_DB, (min(4 * n_entries, N_DB),), replace=False)
    got = tbb.select_entries(td.get_distance(name), _t(db), n_entries, sample=64,
                             probe=_t(probe), rand=_t(rand))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_select_entries_excludes_medoid_from_random_spread(data):
    _, db = data
    medoid = int(tbb.select_entries(td.get_distance("kl"), _t(db), 1, sample=64,
                                    probe=torch.arange(64))[0])
    rand = torch.tensor([5, medoid, 9, 11], dtype=torch.int32)
    got = tbb.select_entries(td.get_distance("kl"), _t(db), 4, sample=64,
                             probe=torch.arange(64), rand=rand)
    assert got.tolist() == [medoid, 5, 9, 11]
    g = torch.Generator().manual_seed(0)
    drawn = tbb.select_entries(td.get_distance("kl"), _t(db), 4, generator=g)
    assert len(set(drawn.tolist())) == 4


def test_frontier_compact_width_and_adaptive_update_match():
    for T, M, c in [(1, 30, 32), (4, 30, 32), (4, 10, 100), (2, 40, 16)]:
        assert tbb.frontier_compact_width(T, M, c) == jbb.frontier_compact_width(T, M, c)
    rng = np.random.default_rng(1)
    B, ef = 9, 6
    beam = np.sort(rng.random((B, ef)).astype(np.float32), 1)
    beam[0, -1] = np.inf
    t_cur = rng.integers(1, 5, B).astype(np.int32)
    stall = rng.integers(0, 3, B).astype(np.int32)
    worst = beam[:, -1] + rng.choice([-0.1, 0.0, 0.1], B).astype(np.float32)
    jst = jbb.BatchBeamState(jnp.asarray(beam), *([None] * 6))
    tst = tbb.BatchBeamState(_t(beam), *([None] * 6))
    want = jbb.adaptive_width_update(jst, jnp.asarray(t_cur), jnp.asarray(stall),
                                     jnp.asarray(worst), 4, 2)
    got = tbb.adaptive_width_update(tst, _t(t_cur), _t(stall), _t(worst), 4, 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n_active", [0, 1, 300])
@pytest.mark.parametrize("frontier", [1, 4])
def test_n_active_prefix_mask_matches(frontier, n_active, data, graphs):
    """``n_active`` (the wave builder's frozen prefix) as a 0-d tensor: equal
    beams, eval counts, hops and visited words; nothing >= n_active is reached."""
    Q, db = data
    idx = graphs["kl"]
    jd_, tdist = get_distance("kl"), td.get_distance("kl")
    jc, tc = jd_.prep_scan(db), tdist.prep_scan(_t(db))
    jq = jax.vmap(jd_.prep_query)(Q)
    tq_rep, tq_bias = tdist.prep_right(_t(Q)), tdist.bias_right(_t(Q))
    from repro_torch.kernels.ops import frontier_gather_scores as tfg

    # entries on both sides of the prefix boundary
    entries = np.array([0, 5, 299, 300, 450], np.int32)
    js = _jax_prefix_search(frontier)(idx.neighbors, jq, jc, jnp.asarray(entries),
                                      jnp.int32(n_active))
    ts = tbb.batched_beam_search(
        _t(idx.neighbors), lambda ids: tfg(tdist, ids.contiguous(), tq_rep, tq_bias,
                                           tc["rep"], tc["bias"]),
        _t(entries), N_Q, EF, frontier=frontier, n_active=torch.tensor(n_active))
    for field in ("beam_i", "expanded", "n_evals", "hops", "done"):
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)), err_msg=field)
    np.testing.assert_array_equal(ts.visited.numpy(), np.asarray(js.visited).view(np.int32))
    np.testing.assert_allclose(ts.beam_d.numpy(), np.asarray(js.beam_d), rtol=1e-6, atol=1e-6)
    assert int(ts.beam_i.max()) < n_active


@functools.lru_cache(maxsize=None)
def _jax_prefix_search(frontier):
    """JAX ``batched_beam_search`` with a traced ``n_active``: one compile per frontier."""
    from repro.kernels.ops import frontier_gather_scores as jfg

    jd_ = get_distance("kl")

    @jax.jit
    def run(neighbors, jq, jc, entries, n_active):
        return jbb.batched_beam_search(
            neighbors, lambda ids: jfg(jd_, ids, jq["rep"], jq["bias"], jc["rep"], jc["bias"]),
            entries, N_Q, EF, frontier=frontier, n_active=n_active)

    return run
