"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule is the tensor's device, nothing else: a CUDA tensor launches the
kernel (or the kernel wrapper raises), a CPU tensor takes the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.core.distances import Distance
from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import frontier_scores
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref


def _device_type(t) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type


def query_distance_matrix(dist: Distance, Q, X):
    """(B, N) left-query distances d(X[i], Q[b]) for a single-matmul Distance.

    ``build_sharded`` scores its local rows against the gathered samples of
    every shard with it.
    """
    q_rep = dist.prep_right(Q).contiguous()
    x_rep = dist.prep_left(X).contiguous()
    q_bias = dist.bias_right(Q).float().contiguous()
    x_bias = dist.bias_left(X).float().contiguous()
    if _device_type(Q) == "cuda":
        return distance_matrix(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    return distance_matrix_ref(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)


def pair_scores(dist: Distance, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, M) distances of gathered rows from ALREADY-PREPPED reps, through
    the per-cell gather kernel (one warp per (b, j)).

    The wave builder scores its reverse-edge candidates with it: every
    (owner, candidate) pair is its own query with M = 1.
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
    """(B, R) distances of frontier rows from ALREADY-PREPPED reps.

    The batched beam engine calls this once per lock-step with the full
    (B, frontier*M) candidate block; NN-descent calls it once per refinement
    round with the (n, C) candidate join, every database row acting as its
    own query.
    """
    if _device_type(ids) == "cuda":
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)


KERNELS = {"frontier_scores": frontier_scores, "gather_scores": gather_scores,
           "distance_matrix": distance_matrix}


def launch_counts() -> dict:
    """Launches of each CUDA kernel wrapper so far in this process, by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in KERNELS.values():
        fn.launches = 0
