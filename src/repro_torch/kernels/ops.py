"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule is the tensor's device, nothing else: a CUDA tensor launches the
kernel (or the kernel wrapper raises), a CPU tensor takes the plain version.
There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.core.distances import Distance
from repro_torch.kernels.frontier_gather import frontier_scores
from repro_torch.kernels.ref import gather_scores_ref


def frontier_gather_scores(dist: Distance, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, R) distances of frontier rows from ALREADY-PREPPED reps.

    The batched beam engine calls this once per lock-step with the full
    (B, frontier*M) candidate block; NN-descent calls it once per refinement
    round with the (n, C) candidate join, every database row acting as its
    own query.
    """
    if ids.device.type == "cuda":
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    if ids.device.type == "cpu":
        return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    raise ValueError(f"no frontier_gather_scores path for device {ids.device}")
