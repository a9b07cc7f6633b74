"""Port parity: SW-graph construction against ``repro.core.swgraph`` and
``repro.core.build_engine``.

* The sequential ``build_swgraph`` gives exactly JAX's adjacency.
* The port's wave builder at W=1 gives exactly the port's sequential
  adjacency (the same scoring on the CPU, so bit for bit).
* At W=16 the wave builder gives exactly JAX's ``build_swgraph_wave``
  adjacency: the stricter of ROADMAP M7's two gates (exact, or recall@10
  within 0.005) holds.
* ``reverse_edge_merge`` equals JAX's on the cases of
  ``tests/test_build_engine.py``'s merge tests, ``rounds=3`` included.
* ``reverse_edge_scores`` (the M = 1 scores the card takes from
  ``gather_scores``) equals JAX's for six distances at rtol = atol = 1e-5,
  the tolerance of ``tests/test_kernels.py``: the two sum in another order.

Every other comparison of adjacency is exact (tolerance 0): ids and degrees
are integers, and the slot distances the merge keeps are copies of its
inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_swgraph, build_swgraph_wave, get_distance, reverse_edge_merge
from repro.data.synthetic import lda_like_histograms
from repro_torch.core import build_engine as tbe
from repro_torch.core import distances as td
from repro_torch.core import swgraph as tsw

from graph_invariants import check_adjacency_invariants

N, DIM, NN, EFC = 300, 16, 8, 40


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def db():
    return lda_like_histograms(jax.random.PRNGKey(0), N, DIM)


@pytest.fixture(scope="module")
def sequential(db):
    """The port's sequential build under kl (shared by two tests)."""
    return tsw.build_swgraph(td.get_distance("kl"), _t(db), NN=NN, ef_construction=EFC)


@pytest.mark.parametrize("name", ["kl", "l2"])
def test_sequential_build_equals_jax(name, db, sequential):
    want_adj, want_deg = build_swgraph(get_distance(name), db, NN=NN, ef_construction=EFC)
    if name == "kl":
        got_adj, got_deg = sequential
    else:
        got_adj, got_deg = tsw.build_swgraph(td.get_distance(name), _t(db), NN=NN,
                                             ef_construction=EFC)
    assert got_adj.dtype == torch.int32 and got_adj.shape == (N, 2 * NN)
    np.testing.assert_array_equal(got_adj.numpy(), np.asarray(want_adj))
    np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))


def test_wave1_equals_sequential_bit_for_bit(db, sequential):
    adj, deg = tbe.build_swgraph_wave(td.get_distance("kl"), _t(db), NN=NN,
                                      ef_construction=EFC, wave=1)
    assert torch.equal(adj, sequential[0]) and torch.equal(deg, sequential[1])


@pytest.mark.parametrize("name", ["kl", "renyi_0.25"])
def test_wave16_equals_jax_wave_build(name, db):
    """ROADMAP M7 gate at W=16: the exact gate holds."""
    want_adj, want_deg = build_swgraph_wave(get_distance(name), db, NN=NN,
                                            ef_construction=EFC, wave=16)
    got_adj, got_deg = tbe.build_swgraph_wave(td.get_distance(name), _t(db), NN=NN,
                                              ef_construction=EFC, wave=16)
    np.testing.assert_array_equal(got_adj.numpy(), np.asarray(want_adj))
    np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))
    check_adjacency_invariants(got_adj.numpy(), N, 2 * NN)


def test_wave_build_knobs_match_jax(db):
    """Explicit frontier, intra-links and reverse rounds, and M_max > 2 NN."""
    X = db[:120]
    kw = dict(NN=6, ef_construction=24, M_max=14, wave=8, rev_rounds=3, frontier=2,
              intra_links=2)
    want, _ = build_swgraph_wave(get_distance("kl"), X, **kw)
    got, _ = tbe.build_swgraph_wave(td.get_distance("kl"), _t(X), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _merge_case():
    adj = np.array([[1, 2, 3], [-1, -1, -1], [-1, -1, -1], [-1, -1, -1]], np.int32)
    adj_d = np.array([[1.0, 5.0, 9.0], [np.inf] * 3, [np.inf] * 3, [np.inf] * 3], np.float32)
    owners = np.array([0, 0, 1, 1, 1, 1], np.int32)
    cands = np.array([2, 3, 0, 2, 3, 1], np.int32)  # 2/3 present in row 0; 1 is a self-loop
    d_rev = np.array([0.5, 2.0, 4.0, 1.0, 3.0, 0.1], np.float32)
    ok = np.ones((6,), bool)
    return adj, adj_d, owners, cands, d_rev, ok


def _random_merge_case(seed, n=40, M_max=6, U=120):
    rng = np.random.RandomState(seed)
    adj = np.full((n, M_max), -1, np.int32)
    adj_d = np.full((n, M_max), np.inf, np.float32)
    for j in range(n):
        picks = rng.choice(np.setdiff1d(np.arange(n), [j]), size=rng.randint(0, M_max + 1),
                           replace=False)
        adj[j, :len(picks)] = picks
        adj_d[j, :len(picks)] = rng.rand(len(picks)).astype(np.float32) * 10
    owners = rng.randint(0, n, U).astype(np.int32)
    cands = rng.randint(0, n, U).astype(np.int32)
    # a few exact distance ties inside one owner's segment
    d_rev = (rng.randint(0, 20, U) / 2).astype(np.float32)
    ok = rng.rand(U) < 0.8
    return adj, adj_d, owners, cands, d_rev, ok


@pytest.mark.parametrize("case,rounds", [("fixed", 2), ("fixed", 3), ("random0", 1),
                                         ("random1", 3), ("random2", 6)])
def test_reverse_edge_merge_equals_jax(case, rounds):
    args = _merge_case() if case == "fixed" else _random_merge_case(int(case[-1]))
    want_adj, want_d = reverse_edge_merge(*(jnp.asarray(a) for a in args), rounds)
    tin = [_t(a) for a in args]
    got_adj, got_d = tbe.reverse_edge_merge(*tin, rounds)
    np.testing.assert_array_equal(got_adj.numpy(), np.asarray(want_adj))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    # functional, like the JAX version: the inputs are left as they were
    np.testing.assert_array_equal(tin[0].numpy(), args[0])
    if case == "fixed":
        a = got_adj.numpy()
        assert set(a[0].tolist()) == {1, 2, 3}
        assert set(x for x in a[1].tolist() if x >= 0) == ({2} if rounds == 2 else {2, 3})


def test_wave_connect_equals_jax(db):
    """One wave connected into a random graph: intra-wave links, forward rows,
    reverse edges; three padded wave slots write nothing."""
    from repro.core.build_engine import wave_connect

    rng = np.random.default_rng(4)
    n, M_max, W, ef = 120, 2 * NN, 16, 12
    X = db[:n]
    adj, adj_d, _, _, _, _ = _random_merge_case(4, n=n, M_max=M_max, U=1)
    pids = np.arange(100, 100 + W, dtype=np.int32)
    ok_pt = np.arange(W) < W - 3
    beam_i = np.stack([rng.choice(100, ef, replace=False) for _ in range(W)]).astype(np.int32)
    beam_d = np.sort(rng.random((W, ef)).astype(np.float32), axis=1)
    beam_i[:, -2:], beam_d[:, -2:] = -1, np.inf
    jd_, tdist = get_distance("kl"), td.get_distance("kl")
    jconsts, jqc = jd_.prep_scan(X), jax.vmap(jd_.prep_query)(X)
    tconsts = tdist.prep_scan(_t(X))
    tqc = {"rep": tdist.prep_right(_t(X)), "bias": tdist.bias_right(_t(X))}
    args = (adj, adj_d, pids, ok_pt, beam_i, beam_d)
    want = wave_connect(jd_, jconsts, jqc, *(jnp.asarray(a) for a in args), NN=NN, L=4, R=3)
    got = tbe.wave_connect(tdist, tconsts, tqc, *(_t(a) for a in args), NN=NN, L=4, R=3)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6, atol=1e-6)
    # the padded points 113..115 (and the rows past the wave) are left as they were
    assert (got[0][113:].numpy() == adj[113:]).all()


@pytest.mark.parametrize("name", ["kl", "itakura_saito", "renyi_0.25", "renyi_2", "l2", "negdot"])
def test_reverse_edge_scores_equals_jax(name, db):
    """The wave builder's reverse-edge scores, one (owner, candidate) pair per
    query with M = 1 (``gather_scores``' path on the card), against
    ``repro``'s at the tolerance of ``tests/test_kernels.py``."""
    from repro.core.build_engine import reverse_edge_scores

    rng = np.random.default_rng(5)
    U = 97
    flat_i = rng.integers(0, N, U).astype(np.int32)
    safe_j = rng.integers(0, N, U).astype(np.int32)
    jd_, tdist = get_distance(name), td.get_distance(name)
    want = reverse_edge_scores(jd_, jd_.prep_scan(db), jax.vmap(jd_.prep_query)(db),
                               jnp.asarray(flat_i), jnp.asarray(safe_j))
    X = _t(db)
    tqc = {"rep": tdist.prep_right(X), "bias": tdist.bias_right(X)}
    got = tbe.reverse_edge_scores(tdist, tdist.prep_scan(X), tqc, _t(flat_i), _t(safe_j))
    assert got.shape == (U,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
