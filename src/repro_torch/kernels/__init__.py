"""Hand-written Hopper kernels and their plain PyTorch versions.

Importing this package needs no ``nvcc`` and no card: a kernel is built by
``repro_torch.kernels.build`` the first time a CUDA tensor reaches it.

distance_matrix: tiled (B, N) distance block with the fused post-combine
gather_topk:     per-(query, candidate) gather + score: the beam engine's lock-step
frontier_gather: per-query gather + score and the two-hop join, for NN-descent
ops:             dispatch by the tensor's device
ref:             the plain PyTorch versions every kernel is held to
"""

from repro_torch.kernels.ops import (beam_gather_scores, frontier_gather_scores,
                                     query_distance_matrix)

__all__ = ["beam_gather_scores", "frontier_gather_scores", "query_distance_matrix"]
