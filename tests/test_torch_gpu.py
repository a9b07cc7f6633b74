"""The port on the card: the CUDA kernels against their plain versions.

Every test here carries the ``gpu`` marker and skips where no NVIDIA card is
present (the CUDA kernel has no CPU mode).  The file imports neither JAX nor
``repro``, so it also runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance rtol = atol = 1e-5 (bf16 reps: 2e-2), as the JAX package holds
its kernels: a kernel sums the float32 dot products in another order than
its plain version.
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.core.distances import get_distance
from repro_torch.kernels import ops
from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import frontier_scores, two_hop_scores
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref, two_hop_scores_ref

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
@pytest.mark.parametrize("shape", [(64, 120, 128), (512, 248, 128), (7, 33, 30),
                                   (64, 240, 128)],
                         ids=["search", "nndescent", "ragged-scalar", "search-nn30"])
@pytest.mark.parametrize("name", DISTS)
def test_kernel_matches_plain(name, shape, cuda):
    B, R, m = shape
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, R, 5000, m)
    before = ops.launch_counts()["frontier_scores"]
    got = ops.frontier_gather_scores(dist, ids, q_rep, q_bias, x_rep, x_bias)
    torch.cuda.synchronize()
    assert ops.launch_counts()["frontier_scores"] == before + 1
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
    # the search step scores through the per-cell kernel
    searched = stats["kernel_launches"]["search"]
    assert searched["gather_scores"] > 0 and searched["frontier_scores"] == 0


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
    before = ops.launch_counts()["distance_matrix"]
    got = ops.query_distance_matrix(dist, Q, X)
    torch.cuda.synchronize()
    assert ops.launch_counts()["distance_matrix"] == before + 1
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
@pytest.mark.parametrize("shape", [(64, 30, 128), (64, 240, 128), (7, 33, 30), (960, 1, 32),
                                   (960, 1, 128), (64, 30, 2100), (5, 3, 16), (1, 1, 4),
                                   (960, 1, 512), (4, 3, 2100), (6, 5, 300)],
                         ids=["search", "frontier-block", "ragged-scalar", "reverse-edges-32",
                              "reverse-edges-128", "wide", "ragged-run", "one-cell",
                              "reverse-edges-wide", "wide-few-cells", "wide-ragged-run"])
@pytest.mark.parametrize("name", DISTS)
def test_gather_scores_matches_plain(name, shape, cuda):
    B, M, m = shape
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, M, 5000, m)
    before = ops.launch_counts()["gather_scores"]
    got = ops.pair_scores(dist, ids, q_rep, q_bias, x_rep, x_bias)
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_scores"] == before + 1
    want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), ids < 0)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["padding-row", "unaligned-base"])
@pytest.mark.parametrize("name", DISTS)
def test_gather_scores_padding_row_and_unaligned_base(name, case, cuda):
    """A row of ids that is all padding, and rows read from a base 4 bytes off
    a 16-byte word (scalar words), in the run kernel (M=40) and in the
    per-cell kernel (M=3)."""
    for B, M, m in [(8, 40, 128), (12, 3, 32)]:
        dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, M, 500, m)
        if case == "padding-row":
            ids[B // 2] = -1
            rows = x_rep
        else:
            rows = torch.empty(x_rep.numel() + 1, device=cuda)[1:].view(x_rep.shape)
            rows.copy_(x_rep)
        got = gather_scores(ids, q_rep, q_bias, rows, x_bias, dist.post_id, dist.c0)
        want = gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
        assert torch.equal(torch.isinf(got), ids < 0)
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 240, 128), (64, 120, 128), (64, 120, 32), (32, 32, 16),
                                   (1, 16, 16), (3, 40, 300)],
                         ids=["search-nn30", "search", "wave-d32", "wave-d16", "wave-w1",
                              "wide"])
@pytest.mark.parametrize("name", DISTS)
def test_gather_scores_equals_frontier_scores_bit_for_bit(name, shape, cuda):
    """The batched search step moved from frontier_scores to gather_scores:
    on aligned reps both give the same float32 sums, so the searches' and the
    wave builds' results do not change."""
    B, R, m = shape
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case(name, cuda, B, R, 5000, m)
    per_cell = gather_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    per_query = frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    assert torch.equal(per_cell, per_query)


@pytest.mark.gpu
def test_swgraph_wave_build_on_the_card(cuda):
    """The wave build scores its searches and its reverse edges with
    gather_scores and keeps the invariants."""
    from repro_torch.core.build_engine import build_swgraph_wave

    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.dirichlet(np.full(16, 0.1), size=600).astype(np.float32))
    X = X.clamp(min=1e-6).to(cuda)
    before = ops.launch_counts()
    adj, deg = build_swgraph_wave(get_distance("kl"), X, NN=8, ef_construction=40, wave=32)
    after = ops.launch_counts()
    assert after["frontier_scores"] == before["frontier_scores"]
    assert after["gather_scores"] > before["gather_scores"]
    a = adj.cpu().numpy()
    assert a.max() < 600 and not (a == np.arange(600)[:, None]).any()
    assert int(deg[1:].min()) >= 1


# chip_smoke.py's DM_CHECK_SHAPES: (B, N, m')
DM_SHAPES = [(128, 4096, 8), (128, 4096, 32), (128, 4096, 128), (512, 8192, 128),
             (33, 300, 64), (33, 300, 30), (64, 1000, 512), (64, 1000, 2100), (20_000, 64, 32)]


def _hist(rng, n, m, dev):
    x = torch.from_numpy(rng.dirichlet(np.full(m, 0.1), size=n).astype(np.float32))
    return x.clamp(min=1e-6).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", DM_SHAPES, ids=["x".join(map(str, s)) for s in DM_SHAPES])
@pytest.mark.parametrize("name", ["kl", "itakura_saito", "l2"])
def test_tensor_core_distance_matrix_at_the_smoke_shapes(name, shape, cuda):
    B, N, m = shape
    rng = np.random.default_rng(4)
    dist = get_distance(name)
    Q, X = _hist(rng, B, m, cuda), _hist(rng, N, m, cuda)
    before = ops.launch_counts()["distance_matrix"]
    got = ops.query_distance_matrix(dist, Q, X)
    torch.cuda.synchronize()
    assert ops.launch_counts()["distance_matrix"] == before + 1
    want = distance_matrix_ref(dist.prep_right(Q), dist.prep_left(X), dist.bias_right(Q),
                               dist.bias_left(X), dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("name", DISTS)
def test_distance_matrix_right_mode(name, cuda):
    rng = np.random.default_rng(5)
    dist = get_distance(name)
    Q, X = _hist(rng, 200, 64, cuda), _hist(rng, 1000, 64, cuda)
    got = ops.query_distance_matrix(dist, Q, X, mode="right")
    want = distance_matrix_ref(dist.prep_left(Q), dist.prep_right(X), dist.bias_left(Q),
                               dist.bias_right(X), dist.post_id, dist.c0)
    torch.testing.assert_close(got, want, **TOL)
    torch.testing.assert_close(got, dist.query_matrix(Q, X, mode="right"), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 4096, 128), (33, 300, 64), (20_000, 64, 32)],
                         ids=["chunk", "ragged", "stitch"])
def test_distance_matrix_bf16_at_the_smoke_shapes(shape, cuda):
    B, N, m = shape
    rng = np.random.default_rng(6)
    dist = get_distance("kl")
    Q, X = _hist(rng, B, m, cuda), _hist(rng, N, m, cuda)
    reps = [dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(),
            dist.bias_right(Q), dist.bias_left(X)]
    torch.testing.assert_close(distance_matrix(*reps, dist.post_id, dist.c0),
                               distance_matrix_ref(*reps, dist.post_id, dist.c0),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 9, 6), (130, 301, 30), (64, 1000, 130), (300, 64, 30)],
                         ids=["tiny", "ragged-30", "folded-130", "n64-30"])
@pytest.mark.parametrize("name", ["kl", "renyi_0.25", "l2"])
def test_distance_matrix_rows_tma_cannot_read(name, shape, cuda):
    """m' % 4 != 0 (bf16: m' % 8 != 0) and bases off a 16-byte boundary: the
    producer warp stages the tiles itself."""
    B, N, m = shape
    rng = np.random.default_rng(9)
    dist = get_distance(name)
    Q, X = _hist(rng, B, m, cuda), _hist(rng, N, m, cuda)
    got = ops.query_distance_matrix(dist, Q, X)
    want = distance_matrix_ref(dist.prep_right(Q), dist.prep_left(X), dist.bias_right(Q),
                               dist.bias_left(X), dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, **TOL)
    # 4 wide (16-byte rows), but the reps start one float past a 16-byte boundary
    q_rep = torch.empty(B * 4 + 1, device=cuda)[1:].view(B, 4)
    x_rep = torch.empty(N * 4 + 1, device=cuda)[1:].view(N, 4)
    q_rep.copy_(dist.prep_right(Q)[:, :4])
    x_rep.copy_(dist.prep_left(X)[:, :4])
    assert q_rep.data_ptr() % 16 and x_rep.data_ptr() % 16
    biases = (dist.bias_right(Q).contiguous(), dist.bias_left(X).contiguous())
    torch.testing.assert_close(distance_matrix(q_rep, x_rep, *biases, dist.post_id, dist.c0),
                               distance_matrix_ref(q_rep, x_rep, *biases, dist.post_id, dist.c0),
                               **TOL)
    reps = [dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(), *biases]
    torch.testing.assert_close(distance_matrix(*reps, dist.post_id, dist.c0),
                               distance_matrix_ref(*reps, dist.post_id, dist.c0),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("name", DISTS)
def test_knn_scan_at_a_width_tma_cannot_read(name, mode, cuda):
    """``serve --dim 30``'s ground truth: every chunk through the staged
    kernel, the same ids as the plain matmul on the CPU."""
    from repro_torch.core.brute_force import knn_scan

    rng = np.random.default_rng(10)
    dist = get_distance(name)
    Q, X = _hist(rng, 64, 30, cuda), _hist(rng, 3000, 30, cuda)
    before = ops.launch_counts()["distance_matrix"]
    got_d, got_i = knn_scan(dist, Q, X, 10, chunk=1024, mode=mode)
    torch.cuda.synchronize()
    assert ops.launch_counts()["distance_matrix"] == before + 3
    want_d, want_i = knn_scan(dist, Q.cpu(), X.cpu(), 10, chunk=1024, mode=mode)
    torch.testing.assert_close(got_d.cpu(), want_d, **TOL)
    assert float((got_i.cpu() == want_i).float().mean()) >= 0.99


def _round_block(dist, dev, n=3000, K=12, n_random=8, m=64, seed=7):
    """A real NN-descent round's inputs: the adjacency after a 2-round build
    with a padded row and a hub, made safe as the round makes it."""
    from repro_torch.core import nndescent as tnn

    rng = np.random.default_rng(seed)
    X = _hist(rng, n, m, dev)
    adj, _ = tnn.build_nndescent(dist, X, torch.Generator(device=dev).manual_seed(seed),
                                 K=K, iters=2, add_reverse=False)
    adj = adj.clone()
    adj[5, 4:] = -1  # a padded row: its -1 become 0, as in the round
    adj[torch.from_numpy(rng.random((n, K)) < 0.02).to(dev)] = 17  # a hub of ~700 edges
    safe = torch.where(adj >= 0, adj, 0).to(torch.int32).contiguous()
    cand = torch.cat([safe[safe.reshape(-1).long()].reshape(n, K * K),
                      torch.randint(-1, n, (n, K + n_random), device=dev, dtype=torch.int32)],
                     dim=1)
    cand = torch.where(cand == torch.arange(n, device=dev, dtype=torch.int32)[:, None], -1, cand)
    reps = [a.contiguous() for a in (dist.prep_right(X), dist.bias_right(X), dist.prep_left(X),
                                     dist.bias_left(X))]
    return safe, cand, reps


@pytest.mark.gpu
@pytest.mark.parametrize("name", DISTS)
def test_two_hop_join_matches_the_general_kernel_on_a_round(name, cuda):
    dist = get_distance(name)
    safe, cand, (q_rep, q_bias, x_rep, x_bias) = _round_block(dist, cuda)
    n, K = safe.shape
    general = frontier_scores(cand.contiguous(), q_rep, q_bias, x_rep, x_bias, dist.post_id,
                              dist.c0)
    block = torch.full((n, 3 + cand.shape[1]), -7.0, device=cuda)
    counts = ops.launch_counts()
    ops.nndescent_round_scores(dist, safe, cand[:, K * K:], q_rep, q_bias, x_rep, x_bias,
                               out=block[:, 3:])
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["two_hop_scores"] == counts["two_hop_scores"] + 1
    assert after["frontier_scores"] == counts["frontier_scores"] + 1
    assert bool((block[:, :3] == -7.0).all())
    got = block[:, 3:]
    assert torch.equal(torch.isinf(got), torch.isinf(general))
    assert torch.equal(torch.isinf(got), cand < 0)
    torch.testing.assert_close(got, general, **TOL)
    want = two_hop_scores_ref(safe, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    torch.testing.assert_close(two_hop_scores(safe, q_rep, q_bias, x_rep, x_bias, dist.post_id,
                                              dist.c0), want, **TOL)


@pytest.mark.gpu
def test_two_hop_join_scalar_path_and_wide_k(cuda):
    """m' % 4 != 0 takes the scalar staging; K > 32 the second template."""
    dist = get_distance("kl")
    safe, _, (q_rep, q_bias, x_rep, x_bias) = _round_block(dist, cuda, n=800, K=40, m=30)
    got = two_hop_scores(safe, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    want = two_hop_scores_ref(safe, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.gpu
def test_frontier_scores_into_a_column_range(cuda):
    dist, ids, (q_rep, q_bias, x_rep, x_bias) = _case("l2", cuda, 64, 240, 5000, 128)
    wide = torch.cat([ids, ids[:, :5]], dim=1)
    block = torch.full((64, 250), -7.0, device=cuda)
    frontier_scores(wide[:, :240], q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                    out=block[:, 10:])
    torch.cuda.synchronize()
    assert bool((block[:, :10] == -7.0).all())
    torch.testing.assert_close(block[:, 10:], gather_scores_ref(
        ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(130, 301, 64), (70, 130, 40), (257, 1000, 640)],
                         ids=["odd-n", "n-even-not-4", "folded-m"])
@pytest.mark.parametrize("name", ["kl", "renyi_0.25"])
def test_distance_matrix_epilogue_paths(name, shape, cuda):
    """N % 4 != 0 stores straight from the registers (no TMA box fits the
    rows); m' > 128 takes the kernel that adds fold groups in float32."""
    B, N, m = shape
    rng = np.random.default_rng(8)
    dist = get_distance(name)
    Q, X = _hist(rng, B, m, cuda), _hist(rng, N, m, cuda)
    got = ops.query_distance_matrix(dist, Q, X)
    want = distance_matrix_ref(dist.prep_right(Q), dist.prep_left(X), dist.bias_right(Q),
                               dist.bias_left(X), dist.post_id, dist.c0)
    torch.testing.assert_close(got, want, **TOL)
    reps = [dist.prep_right(Q).bfloat16(), dist.prep_left(X).bfloat16(),
            dist.bias_right(Q), dist.bias_left(X)]
    torch.testing.assert_close(distance_matrix(*reps, dist.post_id, dist.c0),
                               distance_matrix_ref(*reps, dist.post_id, dist.c0),
                               rtol=2e-2, atol=2e-2)


# -- the construction and search policies: every wrapper, branch by branch --------------

WRAPPERS = ["avg", "min", "reverse", "max", "blend(0.25)", "rankblend(0.5)", "learned", "bm25",
            "bm25-avg"]


def _wrapper(kind, dev):
    """(distance, database rows) for a wrapper kind, on the card."""
    from repro_torch.core.spec import DistancePolicy
    from repro_torch.core.symmetrize import LearnedDistance, symmetrized
    from repro_torch.data.synthetic import text_collection

    rng = np.random.default_rng(11)
    if kind.startswith("bm25"):
        tc = text_collection(rng, 5000, vocab=2048, device=dev)
        bm25 = tc.bm25()
        return (symmetrized(bm25, "avg") if kind == "bm25-avg" else bm25), tc.counts
    X = _hist(rng, 5000, 128, dev)
    kl = get_distance("kl")
    if kind == "learned":
        L = rng.normal(size=(128, 16)).astype(np.float32) * 0.1
        w = {"alpha": 0.75, "beta": 0.5, "tau": 0.8, "L": L.tolist()}
        return LearnedDistance.from_weights(kl, w), X
    return DistancePolicy.parse(kind).bind(kl, data=X), X


def _plain_scores(dist, ids, qc, consts):
    """The wrapper's own plain ``score`` of the gathered rows, +inf at ids < 0."""
    from repro_torch.core.distances import tree_map

    safe = torch.where(ids >= 0, ids, 0).long()
    return torch.where(ids >= 0, dist.score(tree_map(lambda a: a[safe], consts), qc), torch.inf)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", WRAPPERS)
def test_wrapper_branches_through_the_kernels_match_plain(kind, cuda):
    """One launch per branch of each kernel, the combine on the card, equal
    to the wrapper's plain forms to 1e-5: gather_scores at the search step
    (64, 240), the NN-descent round (two_hop_scores + frontier_scores) on a
    (4,096, 30) adjacency, distance_matrix at 512 x 4,096 in both modes."""
    from repro_torch.core.distances import tree_map

    dist, X = _wrapper(kind, cuda)
    nb = len(dist.branches)
    n = X.shape[0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    consts = ops.prepped(dist.prep_scan(X))
    qc = ops.prepped(dist.prep_queries(X[:64]))
    ids = torch.randint(0, n, (64, 240), generator=gen, device=cuda, dtype=torch.int32)
    ids[:, ::7] = -1
    before = ops.launch_counts()
    got = ops.gathered_scores(dist, ids, qc, consts)
    assert ops.launch_counts()["gather_scores"] == before["gather_scores"] + nb
    want = _plain_scores(dist, ids, qc, consts)
    assert torch.equal(torch.isinf(got), ids < 0)
    torch.testing.assert_close(got, want, **TOL)

    n_j, K = 4096, 30
    cj, qj = ops.prepped(dist.prep_scan(X[:n_j])), ops.prepped(dist.prep_queries(X[:n_j]))
    safe = torch.randint(0, n_j, (n_j, K), generator=gen, device=cuda, dtype=torch.int32)
    rest = torch.randint(-1, n_j, (n_j, K + 8), generator=gen, device=cuda, dtype=torch.int32)
    iota = torch.arange(n_j, device=cuda, dtype=torch.int32)[:, None]
    rest = torch.where(rest == iota, -1, rest)
    out = torch.empty((n_j, K * K + K + 8), device=cuda)
    before = ops.launch_counts()
    ops.round_scores(dist, safe, rest, qj, cj, out)
    after = ops.launch_counts()
    assert after["two_hop_scores"] - before["two_hop_scores"] == nb
    assert after["frontier_scores"] - before["frontier_scores"] == nb
    rows = 256  # the plain version materialises (rows, K*K + K + 8, m')
    cand = torch.cat([safe[safe[:rows].reshape(-1).long()].reshape(rows, K * K), rest[:rows]], 1)
    cand = torch.where(cand == iota[:rows], -1, cand)
    want = _plain_scores(dist, cand, tree_map(lambda a: a[:rows], qj), cj)
    assert torch.equal(torch.isinf(out[:rows]), cand < 0)
    torch.testing.assert_close(out[:rows], want, **TOL)

    Q, Xd = X[:512], X[512:512 + 4096]
    for mode in ("left", "right"):
        before = ops.launch_counts()["distance_matrix"]
        got = ops.query_distance_matrix(dist, Q, Xd, mode=mode)
        assert ops.launch_counts()["distance_matrix"] == before + nb
        torch.testing.assert_close(got, dist.query_matrix(Q, Xd, mode=mode), **TOL)


@pytest.mark.gpu
def test_no_wrapper_reaches_a_plain_version_on_the_card(cuda, monkeypatch, tmp_path):
    """Builds (NN-descent, SW-graph wave and sequential), both engines, the
    rerank and the ground truth under symmetrized and combined distances, the
    online index, the slot scheduler, the tuner and the learned distances, and
    the sharded paths: every score comes from a kernel, per branch, and no
    plain version runs."""
    from repro_torch.core import symmetrize
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.spec import RetrievalSpec

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    for name in ("gather_scores_ref", "distance_matrix_ref", "two_hop_scores_ref"):
        monkeypatch.setattr(ops, name, refuse)
    for form in ("score", "matrix", "query_matrix", "pairwise", "pairwise_batch"):
        monkeypatch.setattr(symmetrize._PartsDistance, form, refuse)
    rng = np.random.default_rng(12)
    X, Q = _hist(rng, 3000, 32, cuda), _hist(rng, 64, 32, cuda)
    for changes in (dict(build_policy="min", search_policy="min", k_c=40),
                    dict(build_policy="rankblend(0.5)", builder="swgraph", wave=32),
                    dict(build_policy="avg", builder="swgraph", build_engine="sequential",
                         NN=6, ef_construction=24)):
        spec = RetrievalSpec(NN=changes.pop("NN", 10), nnd_iters=3, ef_search=48, **changes)
        ops.reset_launch_counts()
        idx = ANNIndex.build(X[:1000] if spec.build_engine == "sequential" else X, spec=spec)
        built = ops.launch_counts()
        if spec.builder == "nndescent":
            # two branches: one launch pair per round and one init launch per branch
            assert built["two_hop_scores"] == 2 * spec.nnd_iters
            assert built["frontier_scores"] == 2 * (spec.nnd_iters + 1)
        else:
            assert built["gather_scores"] > 0 and built["gather_scores"] % 2 == 0
        for engine in ("batched", "reference"):
            ops.reset_launch_counts()
            d, ids, n_evals, hops = idx.searcher(engine=engine)(Q)
            torch.cuda.synchronize()
            searched = ops.launch_counts()
            assert bool(torch.isfinite(d).all()) and bool((ids >= 0).all())
            if spec.needs_rerank and engine == "batched":
                # seed + one step per lock-step, per branch, and one rerank launch
                assert searched["gather_scores"] == 2 * (int(hops.max()) + 2) + 1
            assert searched["gather_scores"] > 0
    ops.reset_launch_counts()
    knn_scan(symmetrize.SymmetrizedDistance(get_distance("kl"), "min"), Q, X, 10, chunk=1024)
    assert ops.launch_counts()["distance_matrix"] == 2 * 3

    # the online index under min / min + rerank: every mutation and the masked
    # search score per branch through gather_scores
    from repro_torch.core.online import OnlineIndex

    spec = RetrievalSpec(build_policy="min", search_policy="min", k_c=40, builder="swgraph",
                         wave=32, NN=10, ef_search=48, capacity=1200)
    idx = ANNIndex.build(X[:1000], spec=spec)
    launched = {}

    def counted(phase, fn):
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launched[phase] = ops.launch_counts()
        return out

    counted("from_graph", lambda: OnlineIndex.from_graph(X[:1000], idx.online.adj[:1000],
                                                         idx.build_dist, capacity=1200))
    assert launched["from_graph"]["gather_scores"] == 2  # one (capacity, M) launch per branch
    counted("insert", lambda: idx.insert(X[1000:1100]))
    counted("delete", lambda: idx.delete(np.arange(0, 1100, 9)))
    d, ids, _, _ = counted("search", lambda: idx.searcher()(Q))
    assert bool(torch.isfinite(d).all()) and not bool(torch.isin(
        ids, torch.arange(0, 1100, 9, device=cuda)).any())
    counted("compact_slice", lambda: [idx.online.compact_slice() for _ in range(3)])
    counted("compact", idx.compact)
    for phase in ("insert", "compact_slice", "compact"):
        n = launched[phase]["gather_scores"]
        assert n > 0 and n % 2 == 0, (phase, launched[phase])  # two branches
    # two per lock-step and one for the rerank
    assert launched["search"]["gather_scores"] % 2 == 1
    assert launched["delete"]["gather_scores"] == 0
    surv = torch.nonzero(idx.online.alive).squeeze(1)
    counted("audit", lambda: knn_scan(idx.dist, Q, idx.online.X[surv], 10))
    assert launched["audit"]["distance_matrix"] == 1

    # the slot scheduler under min / min + rerank, on the mutable index: per
    # branch one launch per admission and per lock-step, one per rerank
    sched = idx.scheduler(slots=16, steps_per_sync=2)
    calls = _count_scheduler_sites(sched)
    res = counted("scheduler", lambda: sched.run_stream(Q))
    assert calls["admit"] > 1 and calls["rerank"] == len(Q) + 1  # the warm-up's too
    assert launched["scheduler"]["gather_scores"] == (
        2 * (calls["admit"] + 2 * calls["step"]) + calls["rerank"])
    dead = set(range(0, 1100, 9))
    assert all(not dead.intersection(r.ids.tolist()) and (r.ids >= 0).all() for r in res)

    # tuning and learning (ROADMAP M15): the tuner's rungs, the metric learner's
    # ground truth and the learned candidates' builds and searches, and the
    # two-tower serve scores
    from repro_torch.core.autotune import autotune
    from repro_torch.core.learned import fit_construction_distance
    from repro_torch.core.metric_learning import true_neighbor_ids
    from repro_torch.core.spec import Blend
    from repro_torch.models.recsys import retrieval_scores

    kl = get_distance("kl")
    counted("true_neighbor_ids", lambda: true_neighbor_ids(kl, X, torch.arange(64), 5))
    assert launched["true_neighbor_ids"]["distance_matrix"] == 1
    base = RetrievalSpec(builder="swgraph", wave=32, NN=8, ef_construction=40, k=5,
                         ef_search=16, frontier=1)
    res = counted("learned", lambda: fit_construction_distance(
        X[:600], Q[:16], base=base, rank=4, steps=5, n_anchors=32, k_pos=5,
        alphas=(0.75, 1.0), betas=(0.5,), verbose=False))
    assert res.spec.build_policy.kind == "learned"
    assert launched["learned"]["gather_scores"] > 0 and launched["learned"]["distance_matrix"] > 0
    tuned = counted("autotune", lambda: autotune(
        X[:600], Q[:16], base=base, axes=dict(build_policy=[Blend(0.5), Blend(0.75)],
                                              ef_search=[16]), k=5, rungs=2, verbose=False))
    assert len(tuned.candidates) >= 1
    assert launched["autotune"]["gather_scores"] > 0 and launched["autotune"]["distance_matrix"] > 0
    counted("retrieval_scores", lambda: retrieval_scores(Q, X))
    assert launched["retrieval_scores"]["distance_matrix"] == 1

    # the sharded paths under min, in a one-rank gloo group on the card: the
    # local builds, the local scan, the shard searches of both engines, and the
    # sharded scheduler's admissions (seed_beams) and shard steps
    from repro_torch.core import distributed as tdd
    import torch.distributed as tdist

    mind = symmetrize.SymmetrizedDistance(get_distance("kl"), "min")
    Xs = X[:1000]
    tdd.init_group("gloo", f"file://{tmp_path / 'store'}", 0, 1)
    try:
        nbrs = counted("local nndescent", lambda: tdd.build_local_subgraphs(mind, Xs, NN=10,
                                                                            nnd_iters=3))
        assert launched["local nndescent"]["two_hop_scores"] == 2 * 3
        assert launched["local nndescent"]["frontier_scores"] == 2 * (3 + 1)
        counted("local wave", lambda: tdd.build_local_subgraphs(mind, Xs[:400], NN=8,
                                                                builder="wave", wave=32))
        n = launched["local wave"]["gather_scores"]
        assert n > 0 and n % 2 == 0
        counted("local scan", lambda: tdd.sharded_knn_scan(mind, Q, Xs, 10, 1000))
        assert launched["local scan"]["distance_matrix"] == 2
        for engine in ("batched", "reference"):
            d, ids, _ = counted(engine, lambda: tdd.sharded_graph_search(
                mind, Q, Xs, nbrs, 10, 48, 1000, engine=engine))
            assert bool(torch.isfinite(d).all()) and bool((ids >= 0).all())
            n = launched[engine]["gather_scores"]
            assert n > 0 and n % 2 == 0
        sched = tdd.ShardedSlotScheduler(mind, Xs, nbrs, 1000, slots=16, ef=48, k=10,
                                         steps_per_sync=2)
        calls = {"admit": 0, "step": 0}

        def site(name, fn):
            def call(*args):
                calls[name] += 1
                return fn(*args)
            return call

        sched._admit, sched._step = site("admit", sched._admit), site("step", sched._step)
        res = counted("sharded scheduler", lambda: sched.run_stream(Q))
        # per branch: one launch per admission, one per lock-step
        assert calls["admit"] > 1 and launched["sharded scheduler"]["gather_scores"] == (
            2 * (calls["admit"] + 2 * calls["step"]))
        assert all((r.ids >= 0).all() for r in res)
    finally:
        tdist.destroy_process_group()

    # the dry run's two-tower retrieval cell on rank 0 of the (16, 16) mesh
    # (a fake group of 256): its scan scores the rank's 3,908 rows in one launch
    from repro_torch.launch import cells, dryrun
    from repro_torch.sharding.api import use_mesh

    mesh = dryrun.make_mesh("single_pod_16x16")
    try:
        cell = next(c for c in cells.list_cells()
                    if c.cell_id == "two-tower-retrieval::retrieval_cand")
        built = cells.build_cell(cell, mesh, device=cuda)
        with use_mesh(mesh):
            d, ids = counted("retrieval cell", lambda: built["fn"](*built["args"]))
        assert launched["retrieval cell"]["distance_matrix"] == 1
        assert d.shape == ids.shape == (1, 100)
    finally:
        tdist.destroy_process_group()


def _count_scheduler_sites(sched):
    """Count the scheduler's device calls by site: admissions, ticks' steps
    and reranks (each wrapped on the instance)."""
    calls = {"admit": 0, "step": 0, "rerank": 0}

    def wrap(site, fn):
        def counted(*args, **kwargs):
            calls[site] += 1
            return fn(*args, **kwargs)
        return counted

    sched._admit = wrap("admit", sched._admit)
    sched._step = wrap("step", sched._step)
    if sched._rerank_fn is not None:
        sched._rerank_fn = wrap("rerank", sched._rerank_fn)
    return calls


def _online_state(o):
    """An ``OnlineIndex``'s state as the numpy arrays ``online_from_jax`` takes."""
    return {"X": o.X.cpu().numpy(), "adj": o.adj.cpu().numpy(), "adj_d": o.adj_d.cpu().numpy(),
            "alive": o.alive.cpu().numpy(), "entries": o.entries.cpu().numpy(),
            "n_total": o.n_total, "free": list(o._free), "killed_epoch": o.killed_epoch,
            "mutation_epoch": o.mutation_epoch, "repair_pending": list(o._repair_pending),
            "compact_dirty": o._compact_dirty, "rng_state": o._rng.bit_generator.state}


def _ids_or_recall(label, got, want, true_ids):
    """The card's ids against the CPU path's: equal, or recall@10 within 0.005
    (against ``true_ids``).  Prints which holds."""
    from repro_torch.core.metrics import recall_at_k

    same = float((got.cpu() == want.cpu()).float().mean())
    r_got, r_want = recall_at_k(got, true_ids), recall_at_k(want, true_ids)
    held = "ids equal" if same == 1.0 else f"recall@10 within 0.005 ({r_got} vs {r_want})"
    print(f"[card vs cpu] {label}: ids equal {same:.6f}, {held}")
    assert same == 1.0 or abs(r_got - r_want) <= 0.005, (label, same, r_got, r_want)


@pytest.mark.gpu
@pytest.mark.parametrize("builder", ["swgraph", "nndescent"])
def test_online_index_on_the_card_matches_the_cpu_path(builder, cuda):
    """One churn episode on the card and on the CPU from the same state: after
    insert, delete, compact, a drained compact_slice and an insert into
    recycled slots, the card's search gives the CPU path's ids, or recall@10
    within 0.005; every scoring phase launched gather_scores."""
    from repro_torch.convert import online_from_jax
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.spec import RetrievalSpec

    rng = np.random.default_rng(21)
    X = _hist(rng, 2000 + 256 + 64, 32, "cpu")
    db, pool, Q = X[:2000], X[2000:2256], X[2256:]
    spec = RetrievalSpec(builder=builder, NN=10, nnd_iters=4, wave=32, ef_search=64,
                         capacity=2300)
    state = _online_state(ANNIndex.build(db, spec=spec).online)
    pair = {dev: online_from_jax(state, spec.to_dict(), device=dev) for dev in ("cpu", "cuda")}
    kill = np.random.default_rng(5)

    def step(label, fn):
        ops.reset_launch_counts()
        for o in pair.values():
            fn(o)
        torch.cuda.synchronize()
        searched = {dev: o.searcher(10, 64, frontier=4)(Q.to(dev))[1]
                    for dev, o in pair.items()}
        o = pair["cpu"]
        surv = torch.nonzero(o.alive).squeeze(1)
        truth = surv[knn_scan(get_distance("kl"), Q, o.X[surv], 10)[1].long()]
        _ids_or_recall(f"{builder} {label}", searched["cuda"], searched["cpu"], truth)
        return ops.launch_counts()

    assert step("insert", lambda o: o.insert(pool[:128].to(o.X.device)))["gather_scores"] > 0
    victims = kill.choice(2000, size=150, replace=False)
    step("delete", lambda o: o.delete(victims))
    assert step("compact", lambda o: o.compact())["gather_scores"] > 0
    more = kill.choice(np.flatnonzero(pair["cpu"].alive.numpy()), size=60, replace=False)

    def drain(o):
        o.delete(more)
        while o.compact_slice()["remaining"]:
            pass

    assert step("compact_slice", drain)["gather_scores"] > 0
    step("insert into recycled slots", lambda o: o.insert(pool[128:].to(o.X.device)))
    assert pair["cuda"].n_total == pair["cpu"].n_total < 2000 + 256


@pytest.mark.gpu
def test_m9_gate_cell_on_the_card_matches_the_cpu_path(cuda):
    """ROADMAP M9's gate cell (KL, n = 4,096, d = 32, SW-graph wave 64, NN 15,
    frontier 1): the graph the CPU path builds (equal to repro's, held by
    ``tests/test_torch_index.py``), carried to the card by ``index_from_jax``
    and searched through the kernels, gives the CPU path's ids or recall@10
    within 0.005.  No JAX here: the data comes from the port's generator."""
    from repro_torch.convert import index_from_jax
    from repro_torch.core.brute_force import knn_scan
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.spec import RetrievalSpec
    from repro_torch.data.synthetic import lda_like_histograms, split_queries

    rng = np.random.default_rng(0)
    Q, X = split_queries(lda_like_histograms(rng, 4096 + 128, 32, device="cpu"), 128, rng)
    spec = RetrievalSpec(distance="kl", builder="swgraph", build_engine="wave", wave=64, NN=15,
                         ef_construction=100, k=10, frontier=1)
    cpu = ANNIndex.build(X, spec=spec)
    arrays = {"X": X.numpy(), "neighbors": cpu.neighbors.numpy(),
              "entries": cpu.entries.numpy()}
    card = index_from_jax(arrays, spec.to_dict(), device="cuda")
    ops.reset_launch_counts()
    got = card.searcher()(Q.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_scores"] > 0
    want = cpu.searcher()(Q)
    _ids_or_recall("M9 gate cell", got[1], want[1], knn_scan(get_distance("kl"), Q, X, 10)[1])


@pytest.mark.gpu
@pytest.mark.parametrize("mutable", [False, True])
def test_scheduler_at_the_serve_defaults_matches_the_cpu_path(mutable, cuda):
    """The slot scheduler at the serve defaults (n = 20,000, d = 32, KL,
    NN-descent NN 15, ef 96, 48 slots, frontier 12, 4 lock-steps per tick)
    over the CPU path's graph carried to the card: the retired ids equal
    the CPU path's, for a static index and for an online index after
    deletes; admissions and lock-steps launch gather_scores once each."""
    from repro_torch.convert import index_from_jax
    from repro_torch.core.index import ANNIndex
    from repro_torch.core.spec import RetrievalSpec
    from repro_torch.data.synthetic import lda_like_histograms, split_queries

    rng = np.random.default_rng(0)
    Q, X = split_queries(lda_like_histograms(rng, 20_000 + 256, 32, device="cpu"), 256, rng)
    spec = RetrievalSpec(NN=15, ef_search=96, slots=48, sched_frontier=12, steps_per_sync=4,
                         capacity=20_512 if mutable else None)
    cpu = ANNIndex.build(X, spec=spec)
    # a capacity spec makes both mutable the same way (from_graph)
    card = index_from_jax({"X": X.numpy(), "neighbors": cpu.neighbors.numpy(),
                           "entries": cpu.entries.numpy()}, spec.to_dict(), device="cuda")
    if mutable:
        victims = np.random.default_rng(3).choice(20_000, size=500, replace=False)
        for idx in (cpu, card):
            idx.delete(victims)
    want = cpu.scheduler().run_stream(Q)
    sched = card.scheduler()
    calls = _count_scheduler_sites(sched)
    ops.reset_launch_counts()
    got = sched.run_stream(Q.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["gather_scores"] == calls["admit"] + 4 * calls["step"]
    same = np.mean([np.array_equal(g.ids, w.ids) for g, w in zip(got, want)])
    print(f"[card vs cpu] scheduler, {'online' if mutable else 'static'}: "
          f"{same:.6f} of the requests retire the same ids")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.ids, w.ids)
        assert (g.n_evals, g.hops) == (w.n_evals, w.hops)
        np.testing.assert_allclose(g.dists, w.dists, **TOL)


def _sharded_rank(dev, out_dir):
    """One of 4 ranks at the serve defaults on ``dev``: the CPU ranks build
    the local subgraphs and save them, the card's ranks load them; both
    search one-shot and through the sharded scheduler."""
    from repro_torch.core import distributed as tdd
    from repro_torch.data.synthetic import lda_like_histograms, split_queries

    _, rank = tdd.world_and_rank()
    rng = np.random.default_rng(0)
    Q, X = split_queries(lda_like_histograms(rng, 20_000 + 256, 32, device="cpu"), 256, rng)
    X_local, n_real, _ = tdd.local_block(X[:20_000], rank, 4)
    kl = get_distance("kl")
    if dev.type == "cpu":
        nbrs = tdd.build_local_subgraphs(kl, X_local, NN=15, nnd_iters=8)
        np.save(f"{out_dir}/nbrs{rank}.npy", nbrs.numpy())
    nbrs = torch.from_numpy(np.load(f"{out_dir}/nbrs{rank}.npy")).to(dev)
    X_local = X_local.to(dev)
    ops.reset_launch_counts()
    _, ids, evals = tdd.sharded_graph_search(kl, Q.to(dev), X_local, nbrs, 10, 96, n_real,
                                             frontier=4)
    res = tdd.ShardedSlotScheduler(kl, X_local, nbrs, n_real, slots=32, ef=96,
                                   k=10).run_stream(Q.numpy())
    np.savez(f"{out_dir}/{dev.type}{rank}.npz", ids=ids.cpu().numpy(),
             evals=evals.cpu().numpy(), sched=np.stack([r.ids for r in res]),
             sched_evals=np.asarray([r.n_evals for r in res]),
             gather_scores=ops.launch_counts()["gather_scores"])


@pytest.mark.gpu
def test_sharded_serve_defaults_on_the_card_match_the_cpu_ranks(cuda, tmp_path):
    """4 ranks at the serve defaults (n = 20,000, d = 32, KL, NN 15, ef 96):
    on the card (gloo with CUDA tensors, 4 ranks on one card) they give the 4
    CPU ranks' ids and evals exactly, one-shot at frontier 4 and through the
    sharded scheduler (32 slots), over the CPU ranks' local subgraphs."""
    from repro_torch.launch.serve import run_ranks

    for device in ("cpu", "cuda"):  # run_ranks builds the kernels before the spawn
        run_ranks(_sharded_rank, 4, device, str(tmp_path))
    for r in range(4):
        cpu, card = np.load(tmp_path / f"cpu{r}.npz"), np.load(tmp_path / f"cuda{r}.npz")
        assert int(cpu["gather_scores"]) == 0 and int(card["gather_scores"]) > 0
        for key in ("ids", "evals", "sched", "sched_evals"):
            same = float((cpu[key] == card[key]).mean())
            print(f"[card vs cpu] sharded rank {r} {key}: equal {same:.6f}")
            np.testing.assert_array_equal(card[key], cpu[key])


@pytest.mark.gpu
def test_tuner_quick_grid_on_the_card_matches_the_cpu_path(cuda):
    """``core.autotune`` at ``bench_autotune.py``'s quick grid (KL, n = 1,024,
    d = 32, 48 calibration queries, SW-graph wave 64, NN 15, 2 rungs, the hand
    anchor blend(0.75)/ef 32) on the card and on the CPU, with the same rung
    permutation and the same entry points per build (the CPU path's draws):
    the same history, objectives and choice."""
    from repro_torch.core.autotune import TuneDraws, _build_key, autotune, default_axes
    from repro_torch.core.batched_beam import select_entries
    from repro_torch.core.spec import Blend, RetrievalSpec
    from repro_torch.data.synthetic import lda_like_histograms, split_queries

    rng = np.random.default_rng(0)
    Q, X = split_queries(lda_like_histograms(rng, 1024 + 48, 32, device="cpu"), 48, rng)
    base = RetrievalSpec(distance="kl", builder="swgraph", build_engine="wave", wave=64, NN=15,
                         ef_construction=100, k=10, frontier=1)
    hand = base.replace(build_policy=Blend(0.75), ef_search=32)
    kl = get_distance("kl")
    cache = {}

    def entries(rung, spec, X_r):
        key = (rung, _build_key(spec))
        if key not in cache:
            gen = torch.Generator().manual_seed(len(cache))
            cache[key] = select_entries(kl, X_r.cpu(), spec.n_entries, generator=gen)
        return cache[key]

    draws = TuneDraws(perm=torch.randperm(1024, generator=torch.Generator().manual_seed(1)),
                      entries=entries)
    runs = {}
    for dev in ("cpu", "cuda"):
        ops.reset_launch_counts()
        runs[dev] = autotune(X.to(dev), Q.to(dev), base=base, axes=default_axes(quick=True),
                             anchors=[hand], k=10, rungs=2, verbose=False, draws=draws)
        launched = ops.launch_counts()
        if dev == "cuda":
            assert launched["gather_scores"] > 0 and launched["distance_matrix"] > 0
    cpu, card = runs["cpu"], runs["cuda"]
    assert card.history == cpu.history
    assert [c.objectives for c in card.candidates] == [c.objectives for c in cpu.candidates]
    budget = cpu.lookup(hand).objectives["evals_per_query"]
    assert card.pick(max_evals=budget).fingerprint == cpu.pick(max_evals=budget).fingerprint


@pytest.mark.gpu
def test_two_tower_embeddings_on_the_card_match_the_cpu_path(cuda):
    """The SMOKE two-tower model trained 10 steps on the CPU, carried to the
    card: the card's tower embeddings of 4,096 candidates agree with the CPU
    path's within 1e-5; one more train step from equal weights gives the same
    loss and gradient norm (rtol 1e-5); the retrieval scores go through
    ``distance_matrix``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.launch.train import train_recsys
    from repro_torch.models.recsys import retrieval_scores, tower_embeddings
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step, recsys_loss

    cfg = get_smoke_config("two-tower-retrieval")
    model, _ = train_recsys(cfg, steps=10, batch=256, log_every=100, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    batch = recsys_batch(np.random.default_rng(7), 4096, cfg.vocab_sizes, device="cpu")
    with torch.no_grad():
        want = tower_embeddings(model, batch, cfg)
        got = tower_embeddings(card, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5, atol=1e-5)
    ops.reset_launch_counts()
    scores = retrieval_scores(got[0][:64].contiguous(), got[1].contiguous())
    torch.cuda.synchronize()
    assert ops.launch_counts()["distance_matrix"] == 1
    torch.testing.assert_close(scores.cpu(), retrieval_scores(want[0][:64], want[1]),
                               rtol=1e-5, atol=1e-5)
    metrics = {}
    for label, m in (("cpu", model), ("cuda", card)):
        opt = adamw(warmup_cosine(1e-3, 10, 60))
        step = make_train_step(lambda mm, b: recsys_loss(mm, b, cfg), opt)
        b = recsys_batch(np.random.default_rng((1, 10)), 256, cfg.vocab_sizes, device=label)
        _, _, metrics[label] = step(m, opt.init(dict(m.named_parameters())), b)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics["cuda"][key]), float(metrics["cpu"][key]),
                                   rtol=1e-5)


# -- the recsys ranking models (no kernel of their own) ------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["autoint", "din", "dcn-v2"])
def test_recsys_ranking_models_on_the_card_match_the_cpu(arch, cuda):
    """The SMOKE model trained 5 steps on the CPU, carried to the card: its
    logits over 4,096 rows within 1e-5 of the CPU path's; one more train step
    from equal weights gives the same loss and gradient norm (rtol 1e-5; the
    table's gradient sums with atomics on the card)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.launch.train import train_recsys
    from repro_torch.models.recsys import forward
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step, recsys_loss

    cfg = get_smoke_config(arch)
    model, _ = train_recsys(cfg, steps=5, batch=256, log_every=100, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    batch = recsys_batch(np.random.default_rng(7), 4096, cfg.vocab_sizes, device="cpu",
                         n_dense=cfg.n_dense, seq_len=cfg.seq_len)
    with torch.no_grad():
        want = forward(model, batch, cfg)
        got = forward(card, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    metrics = {}
    for label, m in (("cpu", model), ("cuda", card)):
        opt = adamw(warmup_cosine(1e-3, 10, 60))
        step = make_train_step(lambda mm, b: recsys_loss(mm, b, cfg), opt)
        b = recsys_batch(np.random.default_rng((1, 10)), 256, cfg.vocab_sizes, device=label,
                         n_dense=cfg.n_dense, seq_len=cfg.seq_len)
        _, _, metrics[label] = step(m, opt.init(dict(m.named_parameters())), b)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics["cuda"][key]), float(metrics["cpu"][key]),
                                   rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_on_the_card_matches_the_cpu(mode, cuda):
    """4,096 ragged bags of 1-40 ids (a twentieth -1, per-id weights) over a
    (100,000, 16) table, within rtol = atol = 1e-5 of the CPU path."""
    from repro_torch.models.embedding import embedding_bag

    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.standard_normal((100_000, 16)).astype(np.float32))
    seg = np.repeat(np.arange(4096), rng.integers(1, 41, 4096)).astype(np.int32)
    ids = rng.integers(0, 100_000, seg.shape[0]).astype(np.int32)
    ids[rng.random(seg.shape[0]) < 0.05] = -1
    w = torch.from_numpy(rng.uniform(0.5, 1.5, seg.shape[0]).astype(np.float32))
    args = [torch.from_numpy(ids), torch.from_numpy(seg)]
    want = embedding_bag(table, *args, 4096, mode=mode, weights=w)
    got = embedding_bag(table.to(cuda), *(a.to(cuda) for a in args), 4096, mode=mode,
                        weights=w.to(cuda))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


# -- the dense LM (no kernel of its own: the card runs the same PyTorch code) --------


@pytest.mark.gpu
@pytest.mark.parametrize("window,q_offset", [(0, 0), (7, 0), (0, 5)])
def test_lm_blockwise_attention_on_the_card_matches_the_cpu(window, q_offset, cuda):
    from repro_torch.models.layers import blockwise_attention

    g = torch.Generator().manual_seed(window + q_offset)
    q = torch.randn((2, 33, 8, 16), generator=g)
    k, v = (torch.randn((2, 33, 2, 16), generator=g) for _ in range(2))
    dout = torch.randn((2, 33, 8, 16), generator=g)
    res = {}
    for dev in ("cpu", cuda):
        qq, kk, vv = (t.to(dev).requires_grad_() for t in (q, k, v))
        out = blockwise_attention(qq, kk, vv, window=window, block_q=8, block_kv=16,
                                  q_offset=q_offset)
        res[str(dev)] = [out] + list(torch.autograd.grad(out, (qq, kk, vv), dout.to(dev)))
    for got, want in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b", "yi-34b"])
def test_lm_decode_equals_forward_on_the_card(arch, cuda):
    """Decode-by-steps against forward on the card (gemma's window 8 bites at
    T = 12), and both against the CPU's."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tt

    cfg = get_smoke_config(arch)
    model = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    card = copy.deepcopy(model).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        full, _ = tt.forward(card, toks.to(cuda), cfg, block_q=8, block_kv=8)
        want, _ = tt.forward(model, toks, cfg, block_q=8, block_kv=8)
    torch.testing.assert_close(full.cpu(), want, rtol=1e-5, atol=1e-5)
    cache = tt.init_kv_cache(cfg, 2, 16, device=cuda)
    for t in range(toks.shape[1]):
        logits, cache = tt.decode_step(card, cache, toks[:, t].to(cuda), cfg)
        torch.testing.assert_close(logits, full[:, t], rtol=2e-4, atol=2e-4)
    assert cache["length"].tolist() == [12, 12] and cache["k"].device.type == "cuda"


@pytest.mark.gpu
def test_lm_train_steps_on_the_card_match_the_cpu(cuda):
    """Three AdamW steps of llama3.2-1b SMOKE (f32, remat on, two microbatches)
    on the card and the CPU give the same losses and gradient norms (rtol
    1e-5); the embedding gather's backward sums with atomics on the card."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models import transformer as tt
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import lm_loss, make_train_step

    cfg = dataclasses.replace(get_smoke_config("llama3.2-1b"), remat=True)
    model = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    losses = {}
    for dev, m in (("cpu", model), ("cuda", copy.deepcopy(model).to(cuda))):
        opt = adamw(warmup_cosine(3e-4, 1, 3))
        step = make_train_step(lambda mm, b: lm_loss(mm, b, cfg, block_q=8, block_kv=8), opt,
                               accum_steps=2)
        state = opt.init(dict(m.named_parameters()))
        losses[dev] = []
        for s in range(3):
            b = {k: v.to(dev) for k, v in lm_batch_fn(cfg, 4, 16)(s).items()}
            m, state, metrics = step(m, state, b)
            losses[dev].append((float(metrics["loss"]), float(metrics["grad_norm"])))
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)


@pytest.mark.gpu
def test_lm_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tt
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import adamw, warmup_cosine

    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"), dtype="bfloat16")
    params = dict(tt.init_params(cfg, device=cuda).named_parameters())
    tree = {"params": params, "opt": adamw(warmup_cosine(1e-3, 1, 2)).init(params)}
    ckpt.save(str(tmp_path), 3, tree, chunk_mb=0)
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 3 and restored["opt"]["step"] == 0
    for name, p in params.items():
        r = restored["params"][name]
        assert r.device.type == "cuda" and r.dtype == torch.bfloat16
        assert torch.equal(r, p.detach()), name


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"])
def test_moe_smoke_forward_and_gradients_on_the_card_match_the_cpu(arch, cuda):
    """The MoE SMOKE archs' logits, aux and ``lm_loss`` gradients on the card
    against the CPU's (the routing plan's sorts are stable on both), and
    decode on the card against forward at a dropless capacity."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import lm_batch_fn
    from repro_torch.models import transformer as tt
    from repro_torch.train.train_step import lm_loss

    cfg = get_smoke_config(arch)
    model = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    card = copy.deepcopy(model).to(cuda)
    batch = lm_batch_fn(cfg, 4, 16)(0)
    res = {}
    for dev, m in (("cpu", model), (cuda, card)):
        loss, aux = lm_loss(m, {k: v.to(dev) for k, v in batch.items()}, cfg, block_q=8,
                            block_kv=8)
        grads = torch.autograd.grad(loss, list(m.parameters()))
        res[str(dev)] = [loss.detach(), aux["aux"]] + [g.detach() for g in grads]
    for got, want in zip(res[str(cuda)], res["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)

    dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    toks = batch["tokens"][:2, :12].to(cuda)
    with torch.no_grad():
        full, _ = tt.forward(card, toks, dropless, block_q=8, block_kv=8)
    cache = tt.init_kv_cache(dropless, 2, 16, device=cuda)
    for t in range(toks.shape[1]):
        logits, cache = tt.decode_step(card, cache, toks[:, t], dropless)
        torch.testing.assert_close(logits, full[:, t], rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("norm,aggregator", [("sym", "mean"), ("none", "mean"),
                                             ("none", "max"), ("none", "sum")])
def test_gcn_aggregate_on_the_card_matches_the_cpu(norm, aggregator, cuda):
    """``index_add_`` adds with atomics on the card: equal to float32 rounding."""
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models import gnn

    g = random_graph(np.random.default_rng(0), 5000, 60_000, 24, device="cpu")
    want = gnn.gcn_aggregate(g["features"], g["senders"], g["receivers"], 5000, norm=norm,
                             aggregator=aggregator)
    got = gnn.gcn_aggregate(g["features"].to(cuda), g["senders"].to(cuda),
                            g["receivers"].to(cuda), 5000, norm=norm, aggregator=aggregator)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_gcn_sampler_and_train_steps_on_the_card_match_the_cpu(cuda):
    """``build_csr`` (overflowing rows included) and ``sample_subgraph`` with
    given picks are equal on the card and the CPU; three AdamW steps of the
    full-batch GCN agree in loss and gradient norm."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import gnn_loss, make_train_step

    cfg = get_smoke_config("gcn-cora")
    g = random_graph(np.random.default_rng(1), 2000, 40_000, cfg.d_feat,
                     n_classes=cfg.n_classes, device="cpu")
    table = gnn.build_csr(g["senders"], g["receivers"], 2000, 16)
    card_table = gnn.build_csr(g["senders"].to(cuda), g["receivers"].to(cuda), 2000, 16)
    assert torch.equal(card_table.cpu(), table) and bool((table[:, -1] == -1).any())
    seeds = torch.arange(64, dtype=torch.int32)
    gen = torch.Generator().manual_seed(2)
    picks = [torch.randint(0, 16, (64, 15), generator=gen),
             torch.randint(0, 16, (64 * 15, 10), generator=gen)]
    sub = gnn.sample_subgraph(None, table, seeds, (15, 10), picks=picks)
    card_sub = gnn.sample_subgraph(None, card_table, seeds.to(cuda), (15, 10), picks=picks)
    assert all(torch.equal(card_sub[k].cpu(), sub[k]) for k in sub)

    model = gnn.init_params(cfg, device="cpu")
    losses = {}
    for dev, m in (("cpu", model), (cuda, copy.deepcopy(model).to(cuda))):
        opt = adamw(warmup_cosine(1e-2, 1, 3))
        step = make_train_step(lambda mm, b: gnn_loss(mm, b, cfg), opt)
        state = opt.init(dict(m.named_parameters()))
        batch = {k: v.to(dev) for k, v in g.items()}
        losses[str(dev)] = []
        for _ in range(3):
            m, state, metrics = step(m, state, batch)
            losses[str(dev)].append((float(metrics["loss"]), float(metrics["grad_norm"])))
    np.testing.assert_allclose(losses[str(cuda)], losses["cpu"], rtol=1e-5)


# the on-mesh paths (tests/test_torch_mesh.py's ranks) on 8 ranks that share the
# card (gloo with CUDA tensors) against the same ranks on the CPU; card tolerances
# as the CPU tests hold the paths to repro (index_add_'s atomics: the GCN 1e-4)
# (ids that no other -k selection of this file matches)
MESH_PATHS = {"embedding_lookup": ("emb_", 1e-6, 1e-6), "vocab_xent": ("xent", 1e-4, 1e-6),
              "expert_parallel": ("moe_", 2e-4, 2e-5), "sp_decode": ("dec_", 2e-4, 2e-4),
              "edge_sharded": ("gcn_", 1e-4, 1e-4), "loss_on_mesh": ("lm_", 1e-4, 1e-5)}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ranks share it")
    from repro_torch.launch.serve import run_ranks
    from test_torch_mesh import RANKS, _inputs, _rank

    tmp = tmp_path_factory.mktemp("mesh_card")
    np.savez(tmp / "inputs.npz", **_inputs())
    out = {}
    for device in ("cpu", "cuda"):
        (tmp / device).mkdir()
        run_ranks(_rank, RANKS, device, str(tmp / "inputs.npz"), str(tmp / device))
        out[device] = [dict(np.load(tmp / device / f"rank{r}.npz")) for r in range(RANKS)]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(MESH_PATHS))
def test_mesh_path_on_the_card_matches_the_cpu_ranks(path, mesh_runs, cuda):
    """Each on-mesh path at SMOKE, every rank's results on the card against
    the same rank's on the CPU."""
    prefix, rtol, atol = MESH_PATHS[path]
    for r, (card, cpu) in enumerate(zip(mesh_runs["cuda"], mesh_runs["cpu"])):
        keys = [k for k in cpu if k.startswith(prefix) and cpu[k].dtype.kind == "f"]
        assert keys
        for k in keys:
            np.testing.assert_allclose(card[k], cpu[k], rtol=rtol, atol=atol,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.gpu
@pytest.mark.parametrize("cell_id", ["llama3.2-1b::decode_32k", "gemma3-12b::decode_32k",
                                     "two-tower-retrieval::retrieval_cand", "autoint::serve_p99",
                                     "gcn-cora::molecule"])
def test_dryrun_cell_executes_one_rank_on_the_card(cell_id, cuda, tmp_path):
    """One rank of the (16, 16) production mesh (a fake group of 256), the
    cell's step executed on the card: ``ok``, its measured peak within 80 GB
    and within a factor 2 of the meta pass's reckoned peak."""
    import torch.distributed as tdist

    from repro_torch.launch import cells, dryrun

    mesh = dryrun.make_mesh("single_pod_16x16")
    try:
        cell = next(c for c in cells.list_cells() if c.cell_id == cell_id)
        rec = dryrun.run_cell(cell, mesh, "single_pod_16x16", str(tmp_path), cuda)
    finally:
        tdist.destroy_process_group()
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    print(f"[dry run] {cell_id}: measured {mem['measured_peak_bytes']} reckoned "
          f"{mem['reckoned_peak_bytes']} step {mem['step_ms']:.2f} ms")
    assert mem["fits"] and mem["measured_peak_bytes"] <= 2 * mem["reckoned_peak_bytes"] + 2**30


@pytest.mark.gpu
def test_strict_mode_and_the_recompile_guard_on_the_card(cuda):
    """The card's torch has both counterparts of the runtime checks: under
    ``REPRO_STRICT_TRANSFER=disallow`` a host read raises, under the default
    ``log`` it warns, and ``disable_strict_mode`` lifts both; a
    ``torch.compile``d function's dynamo cache holds one graph per shape."""
    from repro_torch.core.runtime_checks import (RecompileError, disable_strict_mode,
                                                 dispatch_cache_size, enable_strict_mode,
                                                 recompile_guard)

    x = torch.ones(4, device=cuda)
    try:
        applied = enable_strict_mode({"REPRO_STRICT": "1", "REPRO_STRICT_TRANSFER": "disallow"})
        assert applied["sync_debug_mode"] == "error" and torch.cuda.get_sync_debug_mode() == 2
        with pytest.raises(RuntimeError, match="synchronizing"):
            x.sum().item()
        assert enable_strict_mode({"REPRO_STRICT": "1"})["sync_debug_mode"] == "warn"
        with pytest.warns(UserWarning, match="synchronizing"):
            x.sum().item()
    finally:
        off = disable_strict_mode()
    assert off["sync_debug_mode"] == "default" and torch.cuda.get_sync_debug_mode() == 0
    assert x.sum().item() == 4.0

    def double(t):
        return t * 2

    f = torch.compile(double, backend="eager", dynamic=False)
    f(x)
    with recompile_guard(f):
        f(x + 1)
    assert dispatch_cache_size(f) == 1
    with pytest.raises(RecompileError, match="double: 2 executables"):
        with recompile_guard(f):
            f(torch.ones(5, device=cuda))
