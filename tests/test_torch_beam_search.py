"""Port parity: the reference search engine against ``repro.core.beam_search``.

The graph is an SW-graph built by the JAX package and carried across as
numpy arrays.  ``make_batched_searcher`` must give exactly JAX's ids,
``n_evals`` and hops under kl, renyi_0.25 and l2, and distances within
rtol = atol = 1e-6 (float32 dot products summed in another order; under l2
the order does not flip a near-tie on these inputs, so l2 is exact too).
``beam_search_impl`` with the builder's prefix mask ``n_active`` must match
the JAX single-query loop under ``vmap`` on the whole state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam_search as jbs
from repro.core import build_swgraph_wave, get_distance
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch.core import beam_search as tbs
from repro_torch.core import distances as td

N_DB, N_Q, DIM, K, EF = 600, 24, 16, 10, 40
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    X = lda_like_histograms(jax.random.PRNGKey(3), N_DB + N_Q, DIM)
    Q, db = split_queries(X, N_Q, jax.random.PRNGKey(4))
    return Q, db


@pytest.fixture(scope="module")
def graphs(data):
    _, db = data
    return {name: build_swgraph_wave(get_distance(name), db, NN=10, ef_construction=48,
                                     wave=32)[0]
            for name in ("kl", "renyi_0.25", "l2")}


@pytest.mark.parametrize("entry", [0, 17])
@pytest.mark.parametrize("name", ["kl", "renyi_0.25", "l2"])
def test_reference_searcher_exact(name, entry, data, graphs):
    Q, db = data
    nbrs = graphs[name]
    want = [np.asarray(a) for a in jbs.make_batched_searcher(
        get_distance(name), nbrs, db, EF, K, entry=entry)(Q)]
    got = [a.numpy() for a in tbs.make_batched_searcher(
        td.get_distance(name), _t(nbrs), _t(db), EF, K, entry=entry)(_t(Q))]
    for label, g, w in zip(("ids", "n_evals", "hops"), got[1:], want[1:]):
        assert g.dtype == np.int32, label
        np.testing.assert_array_equal(g, w, err_msg=label)
    np.testing.assert_allclose(got[0], want[0], **TOL)


@pytest.mark.parametrize("n_active", [1, 250])
def test_beam_search_impl_prefix_mask_matches(n_active, data, graphs):
    Q, db = data
    dist, tdist = get_distance("kl"), td.get_distance("kl")
    nbrs = graphs["kl"]
    consts = dist.prep_scan(db)

    def single(q):
        return jbs.beam_search_impl(nbrs, consts, dist.prep_query(q), dist.score,
                                    jnp.int32(0), EF, n_active=jnp.int32(n_active))

    want = jax.jit(jax.vmap(single))(Q)
    tconsts = tdist.prep_scan(_t(db))
    qc = {"rep": tdist.prep_right(_t(Q)), "bias": tdist.bias_right(_t(Q))}
    got = tbs.beam_search_impl(_t(nbrs), tconsts, qc, tdist, 0, EF, n_active=n_active)
    for field in ("beam_i", "expanded", "visited", "n_evals", "steps"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.beam_d.numpy(), np.asarray(want.beam_d), **TOL)
    # nothing at or beyond the prefix is ever reached
    assert int(got.beam_i.max()) < n_active


def test_max_steps_caps_every_query(data, graphs):
    Q, db = data
    want = jbs.make_batched_searcher(get_distance("kl"), graphs["kl"], db, EF, K,
                                     max_steps=3)(Q)
    got = tbs.make_batched_searcher(td.get_distance("kl"), _t(graphs["kl"]), _t(db), EF, K,
                                    max_steps=3)(_t(Q))
    assert int(got[3].max()) == 3
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
