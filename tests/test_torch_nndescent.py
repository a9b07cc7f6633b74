"""Port parity: NN-descent against ``repro.core.nndescent``.

``_sampled_reverse`` and ``_dedup_topk`` must be exactly equal to the JAX
package's.  ``build_nndescent`` takes the JAX package's random draws,
replayed from its key splits, and must give the same adjacency: exactly
under ``kl`` and ``renyi_0.25``.  Under ``l2`` the post-combine
``|x|^2 - 2 x.q + |q|^2`` cancels, float32 near-ties break differently when
the two packages sum the dot product in another order, and a different
neighbor can win a slot; there the gate is >= 99% of adjacency entries equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_distance
from repro.core import nndescent as jnn
from repro.data.synthetic import lda_like_histograms
from repro_torch.core import distances as td
from repro_torch.core import nndescent as tnn

N, DIM, KNN, ITERS, N_RANDOM = 2048, 32, 15, 8, 8


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def replay_draws(key, n, K, iters, n_random, M_out) -> tnn.NNDescentDraws:
    """The draws ``repro``'s ``build_nndescent`` makes from ``key``, in its order."""
    key, k0 = jax.random.split(key)
    init = jax.random.randint(k0, (n, K), 0, n - 1)
    rev, rnd = [], []
    for key_r in jax.random.split(key, iters):
        k1, k2 = jax.random.split(key_r)
        rev.append(jax.random.randint(k1, (K,), 0, K))
        rnd.append(jax.random.randint(k2, (n, n_random), 0, n))
    final = jax.random.randint(jax.random.fold_in(key, 7), (K,), 0, M_out - K)
    return tnn.NNDescentDraws(_t(init), _t(jnp.stack(rev)), _t(jnp.stack(rnd)), _t(final))


@pytest.mark.parametrize("K_rev", [5, 15])
def test_sampled_reverse_exact(K_rev):
    rng = np.random.default_rng(K_rev)
    n, K = 50, 6
    adj = rng.integers(0, n, (n, K)).astype(np.int32)
    adj[rng.random((n, K)) < 0.2] = -1
    key = jax.random.PRNGKey(K_rev)
    want = np.asarray(jnn._sampled_reverse(jnp.asarray(adj), K_rev, key))
    slots = jax.random.randint(key, (K,), 0, K_rev)
    got = tnn._sampled_reverse(_t(adj), K_rev, _t(slots))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dedup_topk_exact():
    rng = np.random.default_rng(0)
    n, C, K = 40, 30, 8
    ids = rng.integers(-1, 12, (n, C)).astype(np.int32)  # many repeats and -1
    d = rng.integers(0, 5, (n, C)).astype(np.float32)  # many distance ties
    d[rng.random((n, C)) < 0.1] = np.inf
    want_d, want_i = jnn._dedup_topk(jnp.asarray(d), jnp.asarray(ids), K)
    got_d, got_i = tnn._dedup_topk(torch.from_numpy(d), _t(ids), K)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.fixture(scope="module")
def X():
    return lda_like_histograms(jax.random.PRNGKey(3), N, DIM)


@pytest.mark.parametrize("name", ["kl", "renyi_0.25", "l2"])
def test_build_with_replayed_draws(name, X):
    key = jax.random.PRNGKey(5)
    want_nb, want_deg = jnn.build_nndescent(get_distance(name), X, key, K=KNN, iters=ITERS)
    draws = replay_draws(key, N, KNN, ITERS, N_RANDOM, 2 * KNN)
    got_nb, got_deg = tnn.build_nndescent(td.get_distance(name), torch.from_numpy(np.array(X)),
                                          K=KNN, iters=ITERS, n_random=N_RANDOM, draws=draws)
    want_nb = np.asarray(want_nb)
    assert got_nb.dtype == torch.int32 and got_nb.shape == want_nb.shape == (N, 2 * KNN)
    if name == "l2":
        assert (got_nb.numpy() == want_nb).mean() >= 0.99
    else:
        np.testing.assert_array_equal(got_nb.numpy(), want_nb)
        np.testing.assert_array_equal(got_deg.numpy(), np.asarray(want_deg))


def test_build_from_generator_is_a_valid_graph(X):
    Xt = torch.from_numpy(np.array(X))[:300]
    g = torch.Generator().manual_seed(0)
    nb, deg = tnn.build_nndescent(td.get_distance("kl"), Xt, g, K=10, iters=4)
    nb = nb.numpy()
    assert nb.shape == (300, 20)
    assert ((nb >= -1) & (nb < 300)).all()
    assert not (nb == np.arange(300)[:, None]).any(), "self loop"
    assert (deg.numpy() == (nb >= 0).sum(1)).all()
    for row in nb:
        row = row[row >= 0]
        assert len(set(row.tolist())) == len(row), "duplicate neighbor"
    # the same seed gives the same graph
    nb2, _ = tnn.build_nndescent(td.get_distance("kl"), Xt,
                                 torch.Generator().manual_seed(0), K=10, iters=4)
    np.testing.assert_array_equal(nb2.numpy(), nb)
    # draws made for another K or round count are refused, not misread
    draws = tnn.draw_nndescent(300, 10, 4, 8, 20, torch.Generator().manual_seed(0))
    for K, iters in ((12, 4), (10, 5)):
        with pytest.raises(ValueError, match="draws"):
            tnn.build_nndescent(td.get_distance("kl"), Xt, K=K, iters=iters, draws=draws)


@pytest.mark.parametrize("name", ["kl", "l2"])
def test_round_scores_on_the_cpu_score_the_block_as_it_stands(name, X):
    """ops.nndescent_round_scores, given the adjacency and the candidates
    after the join, writes the plain scores of the materialised candidate
    block into a column range of a wider buffer, launching nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_scores_ref, two_hop_scores_ref

    n, K, extra = 200, 6, 9
    Xt = torch.from_numpy(np.array(X))[:n]
    dist = td.get_distance(name)
    rng = np.random.default_rng(4)
    safe = _t(rng.integers(0, n, (n, K)))
    cand = torch.cat([safe[safe.reshape(-1).long()].reshape(n, K * K),
                      _t(rng.integers(-1, n, (n, extra)))], dim=1)
    cand = torch.where(cand == torch.arange(n, dtype=torch.int32)[:, None], -1, cand)
    q_rep, q_bias = dist.prep_right(Xt), dist.bias_right(Xt)
    x_rep, x_bias = dist.prep_left(Xt), dist.bias_left(Xt)
    block = torch.full((n, 3 + cand.shape[1]), -7.0)
    before = ops.launch_counts()
    ops.nndescent_round_scores(dist, safe, cand[:, K * K:], q_rep, q_bias, x_rep, x_bias,
                               out=block[:, 3:])
    assert ops.launch_counts() == before
    assert bool((block[:, :3] == -7.0).all())
    want = gather_scores_ref(cand, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    torch.testing.assert_close(block[:, 3:], want, rtol=0, atol=0)
    assert torch.equal(torch.isinf(block[:, 3:]), cand < 0)
    torch.testing.assert_close(block[:, 3:3 + K * K],
                               two_hop_scores_ref(safe, q_rep, q_bias, x_rep, x_bias,
                                                  dist.post_id, dist.c0), rtol=0, atol=0)
