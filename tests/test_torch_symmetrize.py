"""Port parity: ``repro_torch.core.symmetrize`` against ``repro.core.symmetrize``.

Every wrapper (reverse, avg, min, max, blend, rankblend, learned with a
Mahalanobis branch, and the viewed BM25 wrappers) over every base family
goes through every form of both packages on the same float32 inputs, made
with numpy from a seed: ``matrix``, ``query_matrix`` (left and right),
``pairwise_batch``, ``prep_scan`` + ``score``, and the branch lowering the
kernel sites run (``ops.query_distance_matrix``, ``ops.gathered_scores``,
``ops.row_scores``, ``ops.round_scores``, here on their plain versions).
Tolerance rtol = atol = 1e-5, the cases of ``tests/test_distance_conformance.py``.
``calibrate_tau`` is held to 1e-6; the exact lowerings of ``blend`` and
``Learned(alpha, beta=0)`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.core import spec as jspec
from repro.core import symmetrize as jsym
from repro.data.synthetic import text_collection
from repro_torch.core import distances as td
from repro_torch.core import spec as tspec
from repro_torch.core import symmetrize as tsym
from repro_torch.data.synthetic import TextCollection
from repro_torch.kernels import ops

TOL = dict(rtol=1e-5, atol=1e-5)
BASES = ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"]
POLICIES = ["reverse", "avg", "min", "max", "blend(0.25)", "rankblend(0.5,1.5)", "learned"]


def _hist(seed, n, m):
    x = np.random.default_rng(seed).dirichlet(np.full(m, 0.5), size=n).astype(np.float32)
    x = np.maximum(x, np.float32(1e-6))
    return x / x.sum(axis=1, keepdims=True)


def _weights(m, beta):
    """Learned weights with a Mahalanobis map of rank 4 (plain JSON)."""
    L = np.random.default_rng(99).normal(size=(m, 4)).astype(np.float32)
    return {"alpha": 0.75, "beta": beta, "tau": 0.8, "L": L.tolist() if beta else None}


def _pair(policy, base, m):
    """The same wrapper in both packages: (jax distance, torch distance)."""
    jb, tb = jd.get_distance(base), td.get_distance(base)
    if policy == "learned":
        w = _weights(m, 0.5)
        return jsym.LearnedDistance.from_weights(jb, w), tsym.LearnedDistance.from_weights(tb, w)
    return (jspec.DistancePolicy.parse(policy).bind(jb),
            tspec.DistancePolicy.parse(policy).bind(tb))


@pytest.fixture(scope="module")
def text():
    """A small BM25 collection: JAX's counts, both packages' collections."""
    tc = text_collection(jax.random.PRNGKey(0), n=72, vocab=256, mean_len=30)
    counts = np.array(tc.counts)
    return tc, TextCollection.from_counts(torch.from_numpy(counts)), counts


def _cases(text):
    """(id, jax distance, torch distance, U, V, X, Q) for every wrapper."""
    out = []
    m = 16
    U, V, X, Q = _hist(1, 6, m), _hist(2, 5, m), _hist(3, 40, m), _hist(4, 3, m)
    for base in BASES:
        for policy in POLICIES:
            j, t = _pair(policy, base, m)
            out.append((f"{policy}-{base}", j, t, U, V, X, Q))
    jt, tt, C = text
    for name, j, t in [("bm25", jt.bm25(), tt.bm25()), ("natural", jt.natural(), tt.natural()),
                       ("bm25-reverse", jsym.reverse_of(jt.bm25()), tsym.reverse_of(tt.bm25())),
                       ("bm25-avg", jsym.symmetrized(jt.bm25(), "avg"),
                        tsym.symmetrized(tt.bm25(), "avg")),
                       ("bm25-rankblend", jspec.RankBlend(0.5, 40.0).bind(jt.bm25()),
                        tspec.RankBlend(0.5, 40.0).bind(tt.bm25()))]:
        out.append((name, j, t, C[:6], C[6:11], C[11:51], C[51:54]))
    return out


CASE_IDS = [f"{p}-{b}" for b in BASES for p in POLICIES] + [
    "bm25", "natural", "bm25-reverse", "bm25-avg", "bm25-rankblend"]


@pytest.fixture(scope="module")
def cases(text):
    return {c[0]: c[1:] for c in _cases(text)}


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CASE_IDS)
def test_matrix_query_matrix_pairwise(case, cases):
    j, t, U, V, X, Q = cases[case]
    jU, jV, tU, tV = jnp.asarray(U), jnp.asarray(V), torch.from_numpy(U), torch.from_numpy(V)
    assert t.name == j.name
    _close(t.matrix(tU, tV), j.matrix(jU, jV))
    for mode in ("left", "right"):
        want = j.query_matrix(jV, jU, mode=mode)
        _close(t.query_matrix(tV, tU, mode=mode), want)
        # the kernel sites' lowering: one distance_matrix per branch, then the combine
        _close(ops.query_distance_matrix(t, tV, tU, mode=mode), want)
    _close(t.pairwise_batch(tU, torch.from_numpy(U[::-1].copy())),
           j.pairwise_batch(jU, jnp.asarray(U[::-1].copy())))


@pytest.mark.parametrize("case", CASE_IDS)
def test_prep_scan_and_score(case, cases):
    j, t, _, _, X, Q = cases[case]
    jX, tX = jnp.asarray(X), torch.from_numpy(X)
    cj, ct = j.prep_scan(jX), t.prep_scan(tX)
    # the same nested layout ({"f", "r", "m"} of {"rep", "bias"}), leaf by leaf
    leaves_j, leaves_t = jax.tree.leaves(cj), jax.tree.leaves(td.tree_map(np.asarray, ct))
    assert len(leaves_j) == len(leaves_t) == 2 * len(t.branches)
    for a, b in zip(leaves_t, leaves_j):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    rows = np.array([0, 3, 3, 39, 17], np.int64)  # repeated rows are legal
    want = []
    for b in range(Q.shape[0]):
        qj = j.prep_query(jnp.asarray(Q[b]))
        want.append(np.asarray(j.score(jax.tree.map(lambda a: a[rows], cj), qj)))
        got = t.score(td.tree_map(lambda a: a[torch.from_numpy(rows)], ct),
                      t.prep_query(torch.from_numpy(Q[b])))
        _close(got, want[-1])
    want = np.stack(want)
    # batched: prep_queries, and the gathered branch lowering of the search step
    qc = t.prep_queries(torch.from_numpy(Q))
    ids = torch.from_numpy(np.tile(rows, (Q.shape[0], 1)).astype(np.int32))
    _close(t.score(td.tree_map(lambda a: a[ids.long()], ct), qc), want)
    _close(ops.gathered_scores(t, ids, ops.prepped(qc), ops.prepped(ct)), want)
    _close(ops.row_scores(t, ids, ops.prepped(qc), ops.prepped(ct)), want)


@pytest.mark.parametrize("case", ["min-kl", "learned-itakura_saito", "rankblend(0.5,1.5)-l2",
                                  "bm25-avg"])
def test_round_scores_combine_in_place_into_a_column_range(case, cases):
    """ops.round_scores writes the combined (n, K*K + C) block into a column
    range of a wider one, equal to the wrapper's plain score."""
    _, t, _, _, X, _ = cases[case]
    tX = torch.from_numpy(X)
    n, K = tX.shape[0], 4
    rng = np.random.default_rng(7)
    safe = torch.from_numpy(rng.integers(0, n, (n, K)).astype(np.int32))
    rest = torch.from_numpy(rng.integers(-1, n, (n, 5)).astype(np.int32))
    consts, qc = ops.prepped(t.prep_scan(tX)), ops.prepped(t.prep_queries(tX))
    block = torch.full((n, 2 + K * K + 5), -7.0)
    before = ops.launch_counts()
    ops.round_scores(t, safe, rest, qc, consts, out=block[:, 2:])
    assert ops.launch_counts() == before
    assert bool((block[:, :2] == -7.0).all())
    cand = torch.cat([safe[safe.reshape(-1).long()].reshape(n, K * K), rest], dim=1)
    cand = torch.where(cand == torch.arange(n, dtype=torch.int32)[:, None], -1, cand)
    want = t.score(td.tree_map(lambda a: a[torch.where(cand >= 0, cand, 0).long()], consts), qc)
    valid = cand >= 0
    assert torch.equal(torch.isinf(block[:, 2:]) & valid, torch.zeros_like(valid))
    torch.testing.assert_close(block[:, 2:][valid], want[valid], **TOL)


@pytest.mark.parametrize("base", ["kl", "itakura_saito", "renyi_0.25", "negdot"])
def test_calibrate_tau_matches(base):
    X = _hist(5, 600, 16)  # strided by 2 to 256 rows: 65,280 pairs, an even count
    want = jsym.calibrate_tau(jd.get_distance(base), jnp.asarray(X))
    got = tsym.calibrate_tau(td.get_distance(base), torch.from_numpy(X))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert tsym.calibrate_tau(td.get_distance(base), torch.from_numpy(X[:1])) == 1.0
    # the auto-tau policy resolves to the same scale and prints alike
    tp = tspec.RankBlend(0.5, None).resolve(td.get_distance(base), torch.from_numpy(X))
    assert tp.tau == got and tp.alpha == 0.5


def test_calibrate_tau_over_a_viewed_distance(text):
    jt, tt, C = text
    np.testing.assert_allclose(tsym.calibrate_tau(tt.bm25(), torch.from_numpy(C)),
                               jsym.calibrate_tau(jt.bm25(), jnp.asarray(C)), rtol=1e-6)


@pytest.mark.parametrize("base", BASES)
def test_blend_lowerings_are_bit_identical(base):
    """blend(1), blend(0.5) and blend(0) bind to the original distance, avg
    and reverse, as in repro."""
    b = td.get_distance(base)
    U, V = torch.from_numpy(_hist(8, 7, 16)), torch.from_numpy(_hist(9, 5, 16))
    assert tspec.Blend(1.0).bind(b) is b
    for alpha, same in ((0.5, tsym.SymmetrizedDistance(b, "avg")),
                        (0.0, tsym.ReversedDistance(b))):
        got = tspec.Blend(alpha).bind(b)
        assert got == same
        assert type(jspec.Blend(alpha).bind(jd.get_distance(base))).__name__ == type(got).__name__
        assert torch.equal(got.matrix(U, V), same.matrix(U, V))


@pytest.mark.parametrize("alpha", [0.25, 0.75])
@pytest.mark.parametrize("base", ["kl", "negdot"])
def test_learned_without_mahalanobis_equals_blend_bit_for_bit(base, alpha):
    b = td.get_distance(base)
    learned = tsym.LearnedDistance.from_weights(
        b, {"alpha": alpha, "beta": 0.0, "tau": None, "L": None})
    blend = tspec.Blend(alpha).bind(b)
    assert isinstance(blend, tsym.CombinedDistance) and len(learned.branches) == 2
    U, V = torch.from_numpy(_hist(10, 7, 16)), torch.from_numpy(_hist(11, 5, 16))
    for form in (lambda d: d.matrix(U, V), lambda d: d.query_matrix(U, V),
                 lambda d: d.query_matrix(U, V, mode="right"),
                 lambda d: d.pairwise_batch(U[:5], V),
                 lambda d: ops.query_distance_matrix(d, U, V)):
        assert torch.equal(form(learned), form(blend))
    ids = torch.tensor([[0, 4, 4, -1], [2, 1, 0, 3]], dtype=torch.int32)
    scores = [ops.gathered_scores(d, ids, ops.prepped(d.prep_queries(U[:2])),
                                  ops.prepped(d.prep_scan(V))) for d in (learned, blend)]
    assert torch.equal(scores[0], scores[1])


def test_learned_branches_are_gated_statically():
    b = td.get_distance("kl")
    full = tsym.LearnedDistance.from_weights(b, _weights(16, 0.5))
    assert [br.query_left for br in full.branches] == [False, True, False]
    only_fwd = tsym.LearnedDistance.from_weights(
        b, {"alpha": 1.0, "beta": 0.0, "tau": None, "L": None})
    assert len(only_fwd.branches) == 1 and set(only_fwd.prep_scan(torch.ones(2, 16))) == {"f"}
    with pytest.raises(ValueError, match="requires a Mahalanobis map"):
        tsym.LearnedDistance.from_weights(b, {"alpha": 1.0, "beta": 1.0, "tau": None, "L": None})


def test_learned_weights_registry_and_fingerprint():
    w = _weights(16, 0.5)
    fp = tsym.register_learned_weights(w)
    assert fp == jsym.learned_weights_fingerprint(w) == tsym.learned_weights_fingerprint(w)
    assert tsym.get_learned_weights(fp) is w
    with pytest.raises(ValueError, match="mismatch"):
        tsym.register_learned_weights(w, fingerprint="0" * 12)
    with pytest.raises(ValueError, match="missing field"):
        tsym.register_learned_weights({"alpha": 1.0})
    with pytest.raises(KeyError, match="no learned weights"):
        tsym.get_learned_weights("ffffffffffff")


def test_reverse_of_and_symmetrized_factory(text):
    b = td.get_distance("kl")
    assert tsym.reverse_of(tsym.reverse_of(b)) is b
    assert tsym.symmetrized(b, "none") is b and tsym.symmetrized(b, "l2").name == "l2"
    assert tsym.SYM_MODES == jsym.SYM_MODES
    with pytest.raises(ValueError, match="natural"):
        tsym.symmetrized(b, "natural")
    with pytest.raises(ValueError, match="unknown symmetrization"):
        tsym.symmetrized(b, "cosine")
    _, tt, _ = text
    rev = tsym.reverse_of(tt.bm25())
    assert isinstance(rev, tsym.ViewedDistance) and rev.left_view == tt.query_view
    assert [br.query_left for br in rev.branches] == [True]


def test_text_collection_views_match(text):
    jt, tt, C = text
    np.testing.assert_allclose(tt.idf.numpy(), np.asarray(jt.idf), **TOL)
    assert tt.avg_len == jt.avg_len
    tC, jC = torch.from_numpy(C), jnp.asarray(C)
    for view in ("doc_view", "query_view", "natural_view"):
        _close(getattr(tt, view)(tC), getattr(jt, view)(jC))
    assert tt.bm25().name == jt.bm25().name and tt.natural().name == jt.natural().name
    N = tt.natural().matrix(tC[:8], tC[8:16])
    torch.testing.assert_close(N, tt.natural().matrix(tC[8:16], tC[:8]).T, rtol=1e-5, atol=1e-6)
