"""Port parity: the kernels' plain versions and their dispatch.

The port's ``gather_scores_ref`` is held to the JAX package's Pallas kernels
``frontier_scores`` and ``gather_scores``, and ``distance_matrix_ref`` to
its Pallas ``distance_matrix`` (interpret mode, as the JAX tests run them
on the CPU) and to the JAX oracles in ``repro.kernels.ref``, for every
post-combine id, with -1 padding, ragged shapes, m' above the TPU kernel's
``block_k`` of 2048, and bf16 reps.  Tolerance rtol = atol = 1e-5 (bf16:
2e-2), as ``tests/test_kernels.py`` holds the JAX kernels: float32 dot
products summed in different orders, nothing else differs.

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as jd
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.distance_matrix import distance_matrix as jax_distance_matrix
from repro.kernels.frontier_gather import frontier_scores as jax_frontier_scores
from repro.kernels.gather_topk import gather_scores as jax_gather_scores
from repro_torch.core import distances as td
from repro_torch.kernels import build, ops
from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import (EDGES_PER_ITEM, frontier_scores,
                                                 two_hop_scores, two_hop_work_list)
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref, two_hop_scores_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
# one distance per post-combine id: LINEAR, RENYI, NEG, L2 (+ a second LINEAR)
POST_DISTS = ["kl", "renyi_0.25", "negdot", "l2", "itakura_saito"]
# the distances of tests/test_kernels.py
DISTS = ["kl", "itakura_saito", "renyi_0.25", "renyi_2", "l2", "negdot"]


def _hist(rng, n, m):
    x = rng.dirichlet(np.full(m, 0.3), size=n).astype(np.float32)
    x = np.maximum(x, np.float32(1e-6))
    return x / x.sum(axis=1, keepdims=True)


def _inputs(name, B=5, R=12, n=40, m=16, seed=0):
    """Prepped numpy reps for ``name`` plus (B, R) ids with -1 padding."""
    rng = np.random.default_rng(seed)
    Q, X = _hist(rng, B, m), _hist(rng, n, m)
    dist = jd.get_distance(name)
    reps = dict(
        q_rep=np.asarray(dist.prep_right(jnp.asarray(Q))),
        q_bias=np.asarray(dist.bias_right(jnp.asarray(Q))),
        x_rep=np.asarray(dist.prep_left(jnp.asarray(X))),
        x_bias=np.asarray(dist.bias_left(jnp.asarray(X))),
    )
    ids = rng.integers(0, n, (B, R)).astype(np.int32)
    ids[rng.random((B, R)) < 0.25] = -1
    ids[0, :] = -1  # a fully padded row
    ids[1, :3] = ids[1, 3]  # repeated ids in one row
    return dist, ids, reps


def _torch(a):
    return torch.from_numpy(np.array(a))  # a writable copy of a JAX-owned buffer


@pytest.mark.parametrize("name", POST_DISTS)
def test_plain_version_matches_pallas_kernel_and_jax_oracle(name):
    dist, ids, r = _inputs(name)
    got = gather_scores_ref(_torch(ids), _torch(r["q_rep"]), _torch(r["x_rep"]),
                            _torch(r["q_bias"]), _torch(r["x_bias"]),
                            dist.post_id, dist.c0).numpy()
    pallas = np.asarray(jax_frontier_scores(
        jnp.asarray(ids), jnp.asarray(r["q_rep"]), jnp.asarray(r["q_bias"]),
        jnp.asarray(r["x_rep"]), jnp.asarray(r["x_bias"]), dist.post_id, dist.c0,
        interpret=True))
    oracle = np.asarray(jref.gather_scores_ref(
        jnp.asarray(ids), jnp.asarray(r["q_rep"]), jnp.asarray(r["x_rep"]),
        jnp.asarray(r["q_bias"]), jnp.asarray(r["x_bias"]), dist.post_id, dist.c0))
    assert got.dtype == np.float32 and got.shape == ids.shape
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("name", POST_DISTS)
def test_ops_takes_plain_path_on_cpu_without_launching(name):
    dist, ids, r = _inputs(name, seed=1)
    tdist = td.get_distance(name)
    before = ops.launch_counts()["frontier_scores"]
    got = ops.frontier_gather_scores(tdist, _torch(ids), _torch(r["q_rep"]),
                                     _torch(r["q_bias"]), _torch(r["x_rep"]),
                                     _torch(r["x_bias"]))
    assert ops.launch_counts()["frontier_scores"] == before
    want = gather_scores_ref(_torch(ids), _torch(r["q_rep"]), _torch(r["x_rep"]),
                             _torch(r["q_bias"]), _torch(r["x_bias"]),
                             tdist.post_id, tdist.c0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    dist, ids, r = _inputs("kl")
    with pytest.raises(ValueError, match="CUDA"):
        frontier_scores(_torch(ids), _torch(r["q_rep"]), _torch(r["q_bias"]),
                        _torch(r["x_rep"]), _torch(r["x_bias"]), dist.post_id)


def test_importing_the_kernel_modules_needs_no_nvcc(tmp_path):
    """Import + the CPU path with no nvcc anywhere: nothing is built."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import ops, build\n"
        "from repro_torch.kernels.frontier_gather import frontier_scores\n"
        "from repro_torch.core.distances import get_distance\n"
        "ids = torch.tensor([[0, -1]], dtype=torch.int32)\n"
        "q = torch.ones(1, 4); x = torch.ones(3, 4)\n"
        "d = ops.frontier_gather_scores(get_distance('negdot'), ids, q, torch.zeros(1),"
        " x, torch.zeros(3))\n"
        "assert d.tolist() == [[-4.0, float('inf')]], d\n"
        "assert ops.launch_counts()['frontier_scores'] == 0\n"
        "try:\n"
        "    build._nvcc()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc-ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no-nvcc-ok" in out.stdout


@pytest.mark.parametrize("name", ["frontier_gather", "distance_matrix", "gather_topk"])
def test_build_targets_hopper_and_writes_under_build(name):
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    lib = build.library_path(name)
    assert lib.parent == ROOT / "build" / "repro_torch"
    assert (build.CSRC / f"{name}.cu").is_file()


def _dm_inputs(name, B, N, m, seed=0, dtype=np.float32):
    """Prepped reps of random histograms, made by the JAX distance (as in
    tests/test_kernels.py), as JAX arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    dist = jd.get_distance(name)
    Q, X = jnp.asarray(_hist(rng, B, m)), jnp.asarray(_hist(rng, N, m))
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    return dist, (dist.prep_right(Q).astype(jdt), dist.prep_left(X).astype(jdt),
                  dist.bias_right(Q), dist.bias_left(X)), Q, X


def _to_torch(a):
    if a.dtype == jnp.bfloat16:  # numpy has no bf16: widen, then narrow exactly
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return _torch(a)


@pytest.mark.parametrize("shape", [(4, 16, 8), (33, 300, 64), (128, 512, 128), (16, 96, 512),
                                   (8, 40, 2100)])
@pytest.mark.parametrize("name", DISTS)
def test_distance_matrix_plain_matches_pallas_kernel_and_jax_oracle(name, shape):
    B, N, m = shape
    dist, (q_rep, x_rep, q_bias, x_bias), _, _ = _dm_inputs(name, B, N, m)
    got = distance_matrix_ref(*(_torch(a) for a in (q_rep, x_rep, q_bias, x_bias)),
                              dist.post_id, dist.c0)
    assert got.dtype == torch.float32 and got.shape == (B, N)
    # m' = 2100 > block_k = 2048 takes the TPU kernel's k-tiled variant
    pallas = jax_distance_matrix(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0,
                                 block_q=32, block_x=128, interpret=True)
    oracle = jref.distance_matrix_ref(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_distance_matrix_plain_dtypes(dtype):
    dist, reps, _, _ = _dm_inputs("kl", 16, 64, 32, seed=2, dtype=dtype)
    got = distance_matrix_ref(*(_to_torch(a) for a in reps), dist.post_id, dist.c0)
    want = jax_distance_matrix(*reps, dist.post_id, dist.c0, block_q=8, block_x=32,
                               interpret=True)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    assert got.dtype == torch.float32  # float32 out whatever the reps' type
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("name", DISTS)
def test_gather_scores_plain_matches_pallas_kernel(name):
    dist, ids, r = _inputs(name, B=6, R=10, n=40, m=16, seed=3)
    got = gather_scores_ref(_torch(ids), _torch(r["q_rep"]), _torch(r["x_rep"]),
                            _torch(r["q_bias"]), _torch(r["x_bias"]), dist.post_id,
                            dist.c0).numpy()
    pallas = np.asarray(jax_gather_scores(
        jnp.asarray(ids), jnp.asarray(r["q_rep"]), jnp.asarray(r["x_rep"]),
        jnp.asarray(r["q_bias"]), jnp.asarray(r["x_bias"]), dist.post_id, dist.c0,
        interpret=True))
    np.testing.assert_array_equal(np.isinf(got), ids < 0)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_ops_wrappers_match_distance_object_without_launching():
    """ops.query_distance_matrix == Distance.query_matrix; the CPU takes the
    plain versions and launches nothing."""
    rng = np.random.default_rng(5)
    Q, X = _hist(rng, 9, 24), _hist(rng, 31, 24)
    before = ops.launch_counts()
    for name in DISTS:
        tdist, jdist = td.get_distance(name), jd.get_distance(name)
        got = ops.query_distance_matrix(tdist, _torch(Q), _torch(X))
        np.testing.assert_allclose(got.numpy(), tdist.query_matrix(_torch(Q), _torch(X)).numpy(),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jops.query_distance_matrix(jdist, Q, X, use_pallas=False)),
            **TOL)
        ids = np.array([[0, 3, 30, -1], [5, 5, 1, 2]], np.int32)
        got_g = ops.beam_gather_scores(tdist, _torch(ids), _torch(Q[:2]), _torch(X))
        want_g = jops.beam_gather_scores(jdist, jnp.asarray(ids), Q[:2], X, use_pallas=False)
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), **TOL)
    assert ops.launch_counts() == before
    assert set(before) == {"frontier_scores", "two_hop_scores", "gather_scores",
                           "distance_matrix"}


def test_new_kernel_wrappers_refuse_cpu_tensors():
    dist, ids, r = _inputs("kl")
    with pytest.raises(ValueError, match="CUDA"):
        gather_scores(_torch(ids), _torch(r["q_rep"]), _torch(r["q_bias"]),
                      _torch(r["x_rep"]), _torch(r["x_bias"]), dist.post_id)
    with pytest.raises(ValueError, match="CUDA"):
        distance_matrix(_torch(r["q_rep"]), _torch(r["x_rep"]), _torch(r["q_bias"]),
                        _torch(r["x_bias"]), dist.post_id)


def _adj_with_hub(n, K, hub_degree, seed=0):
    """(n, K) int32 adjacency: random rows, node 0 named by ``hub_degree``
    edges (several work items), and a block of nodes no edge names."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(n // 4, n, (n, K)).astype(np.int32)  # nodes < n/4: in-degree 0 ...
    adj[rng.random((n, K)) < 0.05] = 1  # ... but for 1, a small hub
    adj[3, :] = 3  # a node whose every neighbour is itself: all self loops
    outside_row_3 = np.setdiff1d(np.arange(n * K), np.arange(3 * K, 4 * K))
    adj.reshape(-1)[rng.choice(outside_row_3, hub_degree, replace=False)] = 0  # and the hub
    return adj


@pytest.mark.parametrize("n,K,hub", [(200, 6, 5 * EDGES_PER_ITEM + 7), (64, 8, 3 * EDGES_PER_ITEM),
                                     (50, 1, 40)])
def test_two_hop_work_list_covers_every_edge_once(n, K, hub):
    adj = torch.from_numpy(_adj_with_hub(n, K, hub))
    edges, items = two_hop_work_list(adj)
    assert edges.dtype == items.dtype == torch.int32 and items.shape[1] == 3
    j, first, count = (items[:, c].long() for c in range(3))
    assert int(count.min()) >= 1 and int(count.max()) <= EDGES_PER_ITEM
    covered = torch.cat([edges[f:f + c].long() for f, c in zip(first.tolist(), count.tolist())])
    # every edge (i, a) exactly once, and each item's edges all name its j
    assert torch.equal(torch.sort(covered).values, torch.arange(n * K))
    for jj, f, c in zip(j.tolist(), first.tolist(), count.tolist()):
        assert bool((adj.reshape(-1)[edges[f:f + c].long()] == jj).all())
    indeg = torch.bincount(adj.reshape(-1).long(), minlength=n)
    items_per_node = torch.bincount(j, minlength=n)
    assert torch.equal(items_per_node, (indeg + EDGES_PER_ITEM - 1) // EDGES_PER_ITEM)
    assert int(indeg[0]) >= hub and int(items_per_node[0]) >= 2  # the hub is cut up
    assert bool((items_per_node[indeg == 0] == 0).all()) and int((indeg == 0).sum()) > 0


def _grouped_emulation(adj, q_rep, q_bias, x_rep, x_bias, post_id, c0):
    """The join kernel's data flow on the CPU: per work item, the K rows of
    its middle node against each of its edges' query rows."""
    n, K = adj.shape
    out = torch.full((n, K * K), float("nan"))
    edges, items = two_hop_work_list(adj)
    for j, f, c in items.tolist():
        cols = adj[j].long()
        rows, biases = x_rep[cols], x_bias[cols]
        for e in edges[f:f + c].tolist():
            i, a = divmod(e, K)
            s = torch.sum(rows * q_rep[i][None, :], dim=-1)
            d = td.apply_post(post_id, s, biases, q_bias[i], c0)
            out[i, a * K:(a + 1) * K] = torch.where((cols < 0) | (cols == i), torch.inf, d)
    return out


@pytest.mark.parametrize("name", DISTS)
def test_two_hop_grouped_scoring_matches_the_materialised_join(name):
    n, K, m = 120, 5, 16
    dist, _, r = _inputs(name, B=n, R=4, n=n, m=m, seed=7)
    adj = torch.from_numpy(_adj_with_hub(n, K, 2 * EDGES_PER_ITEM + 3, seed=1))
    reps = [_torch(r[k]) for k in ("q_rep", "q_bias", "x_rep", "x_bias")]
    got = _grouped_emulation(adj, *reps, dist.post_id, dist.c0)
    want = two_hop_scores_ref(adj, *reps, dist.post_id, dist.c0)
    # the plain version: the materialised join, self loops -1, scored row by row
    cand = adj[adj.reshape(-1).long()].reshape(n, K * K)
    cand = torch.where(cand == torch.arange(n)[:, None], -1, cand)
    torch.testing.assert_close(want, gather_scores_ref(cand, reps[0], reps[2], reps[1], reps[3],
                                                       dist.post_id, dist.c0), rtol=0, atol=0)
    assert torch.equal(torch.isinf(got), cand < 0) and bool(torch.isinf(got[3]).all())
    torch.testing.assert_close(got, want, **TOL)
    # and the JAX package's Pallas frontier_scores on the same join
    pallas = np.asarray(jax_frontier_scores(
        jnp.asarray(cand.numpy()), *(jnp.asarray(r[k]) for k in ("q_rep", "q_bias", "x_rep",
                                                                  "x_bias")),
        dist.post_id, dist.c0, interpret=True))
    np.testing.assert_allclose(want.numpy(), pallas, **TOL)


def test_two_hop_wrapper_refuses_cpu_tensors():
    dist, _, r = _inputs("kl", B=40, n=40)
    adj = torch.zeros((40, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        two_hop_scores(adj, _torch(r["q_rep"]), _torch(r["q_bias"]), _torch(r["x_rep"]),
                       _torch(r["x_bias"]), dist.post_id)


def test_query_distance_matrix_modes():
    """Right mode is the plain matmul of prep_left(Q) and prep_right(X) with
    the post-combine of Distance.query_matrix; an unknown mode is refused."""
    rng = np.random.default_rng(6)
    Q, X = _hist(rng, 9, 24), _hist(rng, 31, 24)
    for name in DISTS:
        tdist, jdist = td.get_distance(name), jd.get_distance(name)
        got = ops.query_distance_matrix(tdist, _torch(Q), _torch(X), mode="right")
        np.testing.assert_allclose(
            got.numpy(), np.asarray(jdist.query_matrix(jnp.asarray(Q), jnp.asarray(X),
                                                       mode="right")), **TOL)
        np.testing.assert_allclose(got.numpy(), tdist.query_matrix(
            _torch(Q), _torch(X), mode="right").numpy(), **TOL)
    with pytest.raises(ValueError, match="mode"):
        ops.query_distance_matrix(td.get_distance("kl"), _torch(Q), _torch(X), mode="both")
