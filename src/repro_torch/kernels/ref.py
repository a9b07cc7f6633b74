"""Plain PyTorch versions of the kernels (the oracles the kernels are held to).

Contract note: kernels operate on ALREADY-PREPPED representations; the
elementwise pre-transforms of each distance are applied once, outside the
kernel, and the kernel computes the gathered dot product + post-combine.
"""

from __future__ import annotations

import torch

from repro_torch.core.distances import apply_post


def gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, post_id: int, c0: float = 0.0):
    """Distances of gathered rows per query: the plain ``frontier_scores``.

    ids (B, R) int row indices into x_rep (n, m'); -1 = padding -> +inf.
    Returns (B, R) float32 left-query distances d(x[ids[b, r]], q[b]).
    Materialises the (B, R, m') gather, so only the CPU path and row subsets
    on the card run it.
    """
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    rows = x_rep[safe]  # (B, R, m')
    # a product and a sum, not einsum: on the CPU einsum goes to a BLAS batched
    # matmul whose rounding changed with the process's allocation history
    s = torch.sum(rows.float() * q_rep.float()[:, None, :], dim=-1)
    d = apply_post(post_id, s, x_bias[safe].float(), q_bias[:, None].float(), c0)
    return torch.where(valid, d, torch.inf)
