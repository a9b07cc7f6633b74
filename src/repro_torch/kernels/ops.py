"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule is the tensor's device, nothing else: a CUDA tensor launches the
kernel (or the kernel wrapper raises), a CPU tensor takes the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.core.distances import Distance
from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import frontier_scores, two_hop_scores
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref, two_hop_scores_ref


def _device_type(t) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type


def query_distance_matrix(dist: Distance, Q, X, mode: str = "left"):
    """(B, N) distances between queries Q and database rows X for a
    single-matmul Distance: d(X[i], Q[b]) for ``mode="left"`` (the paper's
    convention), d(Q[b], X[i]) for ``mode="right"``.

    ``knn_scan`` scores every database chunk with it, and ``build_sharded``
    its local rows against the gathered samples of every shard.  The plain
    version is ``Distance.query_matrix``'s matmul and post-combine; in right
    mode the two biases are added in the other order.
    """
    if mode == "left":
        q_rep, x_rep = dist.prep_right(Q), dist.prep_left(X)
        q_bias, x_bias = dist.bias_right(Q), dist.bias_left(X)
    elif mode == "right":
        q_rep, x_rep = dist.prep_left(Q), dist.prep_right(X)
        q_bias, x_bias = dist.bias_left(Q), dist.bias_right(X)
    else:
        raise ValueError(f"unknown query mode {mode!r}")
    q_rep, x_rep = q_rep.contiguous(), x_rep.contiguous()
    q_bias, x_bias = q_bias.float().contiguous(), x_bias.float().contiguous()
    if _device_type(Q) == "cuda":
        return distance_matrix(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    return distance_matrix_ref(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)


def pair_scores(dist: Distance, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, M) distances of gathered rows from ALREADY-PREPPED reps, through
    the per-cell gather kernel ``gather_scores``.

    The batched beam engine calls this once per lock-step with the full
    (B, frontier*M) candidate block, in search and in the wave builder; the
    wave builder also scores its reverse-edge candidates with it, every
    (owner, candidate) pair its own query with M = 1.
    """
    if _device_type(ids) == "cuda":
        return gather_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)


def beam_gather_scores(dist: Distance, ids, Q, X):
    """(B, M) distances of neighbor rows ``ids`` under the left-query convention."""
    return pair_scores(dist, ids.contiguous(), dist.prep_right(Q).contiguous(),
                       dist.bias_right(Q).float().contiguous(),
                       dist.prep_left(X).contiguous(), dist.bias_left(X).float().contiguous())


def frontier_gather_scores(dist: Distance, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, R) distances of candidate rows from ALREADY-PREPPED reps, through
    the per-query kernel ``frontier_scores``.

    NN-descent calls it with its (n, C) candidate blocks, every database row
    acting as its own query.
    """
    if _device_type(ids) == "cuda":
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)


def nndescent_round_scores(dist: Distance, safe_adj, rest, q_rep, q_bias, x_rep, x_bias, out):
    """Score an NN-descent round's (n, K*K + C) candidate block into ``out``.

    The first K*K columns are the two-hop join ``safe_adj[safe_adj]`` with
    self loops scored +inf; ``rest`` (n, C) holds the remaining candidates
    (-1 padding).  ``out`` is an (n, K*K + C) float32 block, possibly a
    column range of a wider one.  On the card the join columns go through
    the grouped ``two_hop_scores`` kernel and ``rest`` through
    ``frontier_scores``, both writing into ``out``; on the CPU their plain
    versions, the join materialised from ``safe_adj`` as the kernel reads it.
    """
    KK = safe_adj.shape[1] ** 2
    if _device_type(safe_adj) == "cuda":
        two_hop_scores(safe_adj, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                       out=out[:, :KK])
        frontier_scores(rest, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                        out=out[:, KK:])
        return out
    out[:, :KK] = two_hop_scores_ref(safe_adj, q_rep, q_bias, x_rep, x_bias, dist.post_id,
                                     dist.c0)
    out[:, KK:] = gather_scores_ref(rest, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    return out


KERNELS = {"frontier_scores": frontier_scores, "two_hop_scores": two_hop_scores,
           "gather_scores": gather_scores, "distance_matrix": distance_matrix}


def launch_counts() -> dict:
    """Launches of each CUDA kernel wrapper so far in this process, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
