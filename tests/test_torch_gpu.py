"""The port on the card: the CUDA kernels against their plain versions.

Every test here carries the ``gpu`` marker and skips where no NVIDIA card is
present (the CUDA kernel has no CPU mode).  The file imports neither JAX nor
``repro``, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance rtol = atol = 1e-5 (bf16 reps: 2e-2), as the JAX package holds
its kernels: a kernel sums the float32 dot products in another order than
its plain version.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.distances import get_distance
from repro_torch.kernels import ops
from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import frontier_scores
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref

TOL = dict(rtol=1e-5, atol=1e-5)
DISTS = ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(name, dev, B, R, n, m, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.dirichlet(np.full(m, 0.1), size=n).astype(np.float32))
    Q = torch.from_numpy(rng.dirichlet(np.full(m, 0.1), size=B).astype(np.float32))
    X, Q = X.clamp(min=1e-6).to(dev), Q.clamp(min=1e-6).to(dev)
    dist = get_distance(name)
    ids = torch.from_numpy(rng.integers(0, n, (B, R)).astype(np.int32))
    ids[torch.from_numpy(rng.random((B, R)) < 0.2)] = -1
    reps = [a.contiguous() for a in (dist.prep_right(Q), dist.bias_right(Q),
                                     dist.prep_left(X), dist.bias_left(X))]
    return dist, ids.to(dev), reps


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 120, 128), (512, 248, 128), (7, 33, 30)],
                         ids=["search", "nndescent", "ragged-scalar"])
@pytest.mark.parametrize("name", DISTS)
def test_kernel_matches_plain(name, shape, cuda):
    B, R, m = shape
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, R, 5000, m)
    before = frontier_scores.launches
    got = ops.frontier_gather_scores(dist, ids, q_rep, q_bias, x_rep, x_bias)
    torch.cuda.synchronize()
    assert frontier_scores.launches == before + 1
    want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), ids < 0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_wrapper_checks_its_inputs(cuda):
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case("kl", cuda, 4, 8, 50, 16)
    with pytest.raises(TypeError):
        frontier_scores(ids.long(), q_rep, q_bias, x_rep, x_bias, dist.post_id)
    with pytest.raises(ValueError):
        frontier_scores(ids, q_rep[:, :8], q_bias, x_rep, x_bias, dist.post_id)
    with pytest.raises(ValueError):
        frontier_scores(ids, q_rep.t().contiguous().t(), q_bias, x_rep, x_bias, dist.post_id)


@pytest.mark.gpu
def test_serve_on_the_card(cuda):
    from repro_torch.launch.serve import build_and_serve

    stats = build_and_serve(n_db=5000, dim=32, n_queries=128, batch=64, device="cuda",
                            verbose=False)
    assert stats["recall@k"] >= 0.9
    assert stats["build_kernel_launches"] > 0 and stats["search_kernel_launches"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(33, 300, 64), (128, 4096, 8), (64, 1000, 512),
                                   (16, 200, 2100)],
                         ids=["ragged", "narrow", "wide", "beyond-block-k"])
@pytest.mark.parametrize("name", DISTS + ["renyi_2"])
def test_distance_matrix_matches_plain(name, shape, cuda):
    B, N, m = shape
    rng = np.random.default_rng(1)
    dist = get_distance(name)
    Q = torch.from_numpy(rng.dirichlet(np.full(m, 0.1), size=B).astype(np.float32))
    X = torch.from_numpy(rng.dirichlet(np.full(m, 0.1), size=N).astype(np.float32))
    Q, X = Q.clamp(min=1e-6).to(cuda), X.clamp(min=1e-6).to(cuda)
    before = distance_matrix.launches
    got = ops.query_distance_matrix(dist, Q, X)
    torch.cuda.synchronize()
    assert distance_matrix.launches == before + 1
    want = distance_matrix_ref(dist.prep_right(Q), dist.prep_left(X), dist.bias_right(Q),
                               dist.bias_left(X), dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_distance_matrix_bf16_reps(cuda):
    dist = get_distance("kl")
    rng = np.random.default_rng(2)
    Q = torch.from_numpy(rng.dirichlet(np.full(32, 0.3), size=40).astype(np.float32)).to(cuda)
    X = torch.from_numpy(rng.dirichlet(np.full(32, 0.3), size=300).astype(np.float32)).to(cuda)
    reps = [dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(),
            dist.bias_right(Q), dist.bias_left(X)]
    got = distance_matrix(*reps, dist.post_id, dist.c0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, distance_matrix_ref(*reps, dist.post_id, dist.c0),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 30, 128), (64, 240, 128), (7, 33, 30)],
                         ids=["search", "frontier-block", "ragged-scalar"])
@pytest.mark.parametrize("name", DISTS)
def test_gather_scores_matches_plain(name, shape, cuda):
    B, M, m = shape
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, M, 5000, m)
    before = gather_scores.launches
    got = ops.pair_scores(dist, ids, q_rep, q_bias, x_rep, x_bias)
    torch.cuda.synchronize()
    assert gather_scores.launches == before + 1
    want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), ids < 0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_swgraph_wave_build_on_the_card(cuda):
    """The wave build launches both gather kernels and keeps the invariants."""
    from repro_torch.core.build_engine import build_swgraph_wave

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.dirichlet(np.full(16, 0.1), size=600).astype(np.float32))
    X = X.clamp(min=1e-6).to(cuda)
    before = ops.launch_counts()
    adj, deg = build_swgraph_wave(get_distance("kl"), X, NN=8, ef_construction=40, wave=32)
    after = ops.launch_counts()
    assert after["frontier_scores"] > before["frontier_scores"]
    assert after["gather_scores"] > before["gather_scores"]
    a = adj.cpu().numpy()
    assert a.max() < 600 and not (a == np.arange(600)[:, None]).any()
    assert int(deg[1:].min()) >= 1
