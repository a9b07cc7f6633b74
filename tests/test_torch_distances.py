"""Port parity: repro_torch.core.distances against repro.core.distances.

The same float32 inputs, made with numpy from a seed, go through every
evaluation form of both packages: matrix, query_matrix (left and right),
pairwise_batch and the prep_scan / prep_query / score gather contract.
Tolerance rtol = atol = 1e-5: the two packages sum float32 products in
different orders, nothing else differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro_torch.core import distances as td

NAMES = sorted(set(jd.available_distances()) | {"renyi_0.5", "renyi_4"})
TOL = dict(rtol=1e-5, atol=1e-5)


def _hist(seed, n, m):
    x = np.random.default_rng(seed).dirichlet(np.full(m, 0.5), size=n).astype(np.float32)
    x = np.maximum(x, np.float32(1e-6))
    return x / x.sum(axis=1, keepdims=True)


def _pair(a_np, fn_j, fn_t, *args_np):
    """Apply the JAX and torch forms to the same numpy arrays."""
    got_j = np.asarray(fn_j(*(jnp.asarray(a) for a in args_np)))
    got_t = fn_t(*(torch.from_numpy(a) for a in args_np)).numpy()
    return got_j, got_t


def test_registry_and_post_ids_match():
    assert td.available_distances() == jd.available_distances()
    assert (td.POST_LINEAR, td.POST_RENYI, td.POST_NEG, td.POST_L2) == (
        jd.POST_LINEAR, jd.POST_RENYI, jd.POST_NEG, jd.POST_L2)
    assert td._TINY == jd._TINY and td.EPS == jd.EPS
    with pytest.raises(ValueError):
        td.get_distance("cosine")


@pytest.mark.parametrize("name", NAMES)
def test_distance_fields_match(name):
    j, t = jd.get_distance(name), td.get_distance(name)
    for f in ("name", "post_id", "c0", "symmetric", "needs_simplex"):
        assert getattr(t, f) == getattr(j, f), f


@pytest.mark.parametrize("name", NAMES)
def test_matrix_and_query_matrix(name):
    j, t = jd.get_distance(name), td.get_distance(name)
    U, V = _hist(0, 24, 16), _hist(1, 20, 16)
    want, got = _pair(None, j.matrix, t.matrix, U, V)
    np.testing.assert_allclose(got, want, **TOL)
    for mode in ("left", "right"):
        want, got = _pair(None, lambda a, b: j.query_matrix(a, b, mode=mode),
                          lambda a, b: t.query_matrix(a, b, mode=mode), V, U)
        assert got.shape == (20, 24)
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_pairwise_batch(name):
    j, t = jd.get_distance(name), td.get_distance(name)
    U, V = _hist(2, 32, 16), _hist(3, 32, 16)
    want, got = _pair(None, j.pairwise_batch, t.pairwise_batch, U, V)
    assert got.shape == (32,)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prep_scan_prep_query_score(name):
    j, t = jd.get_distance(name), td.get_distance(name)
    X, q = _hist(4, 40, 16), _hist(5, 1, 16)[0]
    rows = np.array([3, 0, 39, 17, 17], np.int64)
    cj, ct = j.prep_scan(jnp.asarray(X)), t.prep_scan(torch.from_numpy(X))
    for key in ("rep", "bias"):
        np.testing.assert_allclose(ct[key].numpy(), np.asarray(cj[key]), **TOL)
    qj, qt = j.prep_query(jnp.asarray(q)), t.prep_query(torch.from_numpy(q))
    for key in ("rep", "bias"):
        np.testing.assert_allclose(qt[key].numpy(), np.asarray(qj[key]), **TOL)
    want = np.asarray(j.score({k: v[rows] for k, v in cj.items()}, qj))
    got = t.score({k: v[torch.from_numpy(rows)] for k, v in ct.items()}, qt).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the gather contract is the left-query matrix row
    np.testing.assert_allclose(
        got, t.query_matrix(torch.from_numpy(q[None]), torch.from_numpy(X[rows]))[0].numpy(),
        **TOL)


@pytest.mark.parametrize("post_id", [0, 1, 2, 3])
def test_apply_post(post_id):
    rng = np.random.default_rng(post_id)
    s = rng.uniform(-1.0, 3.0, (5, 7)).astype(np.float32)
    bl = rng.normal(size=(5, 1)).astype(np.float32)
    br = rng.normal(size=(1, 7)).astype(np.float32)
    want = np.asarray(jd.apply_post(post_id, jnp.asarray(s), jnp.asarray(bl),
                                    jnp.asarray(br), -4.0 / 3.0))
    got = td.apply_post(post_id, torch.from_numpy(s), torch.from_numpy(bl),
                        torch.from_numpy(br), -4.0 / 3.0).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        td.apply_post(9, torch.from_numpy(s), 0.0, 0.0)
