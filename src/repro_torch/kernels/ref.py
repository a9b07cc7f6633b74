"""Plain PyTorch versions of the kernels (the oracles the kernels are held to).

Contract note: kernels operate on ALREADY-PREPPED representations; the
elementwise pre-transforms of each distance are applied once, outside the
kernel, and the kernel computes the gathered dot product + post-combine.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def exact_float32_matmul():
    """Full float32 matmuls (no TF32) inside the block; the caller's setting after.

    TF32 keeps about three decimal digits, too few for an oracle held to 1e-5.
    """
    tf32 = torch.backends.cuda.matmul.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _post(post_id, s, x_bias, q_bias, c0, query_left):
    """The post-combine with the row's bias first, or with the query's first
    for a reversed branch (``query_left``), as the JAX package orders them."""
    # imported here: the core package imports the kernels
    from repro_torch.core.distances import apply_post

    if query_left:
        return apply_post(post_id, s, q_bias, x_bias, c0)
    return apply_post(post_id, s, x_bias, q_bias, c0)


def distance_matrix_ref(q_rep, x_rep, q_bias, x_bias, post_id: int, c0: float = 0.0,
                        query_left: bool = False):
    """(B, N) float32 left-query distances from prepped reps: the plain
    ``distance_matrix``.

    q_rep (B, m') = prep_right(Q); x_rep (N, m') = prep_left(X); q_bias (B,),
    x_bias (N,) the matching biases.  D[b, i] = post(q_rep[b] . x_rep[i],
    bias_l=x_bias[i], bias_r=q_bias[b]); the biases swap places for a
    reversed branch (``query_left``).  bf16 reps are widened to float32
    first; the output is always float32.
    """
    with exact_float32_matmul():
        s = q_rep.float() @ x_rep.float().T
    return _post(post_id, s, x_bias[None, :].float(), q_bias[:, None].float(), c0, query_left)


def gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, post_id: int, c0: float = 0.0,
                      query_left: bool = False):
    """Distances of gathered rows per query: the plain ``frontier_scores``
    and the plain ``gather_scores`` (one function, two kernels).

    ids (B, R) int row indices into x_rep (n, m'); -1 = padding -> +inf.
    Returns (B, R) float32 left-query distances d(x[ids[b, r]], q[b]) (the
    biases swap places for a reversed branch, ``query_left``).
    Materialises the (B, R, m') gather, so only the CPU path and row subsets
    on the card run it.
    """
    valid = ids >= 0
    safe = torch.where(valid, ids, 0).long()
    rows = x_rep[safe]  # (B, R, m')
    # a product and a sum, not einsum: on the CPU einsum goes to a BLAS batched
    # matmul whose rounding changed with the process's allocation history
    s = torch.sum(rows.float() * q_rep.float()[:, None, :], dim=-1)
    d = _post(post_id, s, x_bias[safe].float(), q_bias[:, None].float(), c0, query_left)
    return torch.where(valid, d, torch.inf)


def two_hop_scores_ref(safe_adj, q_rep, q_bias, x_rep, x_bias, post_id: int, c0: float = 0.0,
                       query_left: bool = False):
    """The plain ``two_hop_scores``: materialise the join ``safe_adj[safe_adj]``
    (n, K*K), set self loops to -1 and score it row by row.
    """
    n, K = safe_adj.shape
    cand = safe_adj[safe_adj.reshape(-1).long()].reshape(n, K * K)
    self_loop = cand == torch.arange(n, dtype=cand.dtype, device=cand.device)[:, None]
    cand = torch.where(self_loop, -1, cand)
    return gather_scores_ref(cand, q_rep, x_rep, q_bias, x_bias, post_id, c0, query_left)
