"""Exact brute-force k-NN scan (the paper's baseline and the ground truth).

Chunked over the database so the (B, N) distance matrix never materialises:
each chunk is one matmul-form distance block merged into a running top-k.
The chunk goes through ``ops.query_distance_matrix``: on the card the
tensor-core ``distance_matrix`` kernel (3xTF32), on the CPU the plain
matmul and post-combine of ``dist.query_matrix``.  Plain matmuls run with
TF32 off inside the scan (it keeps about three decimal digits and would
corrupt the ground truth), and the caller's setting is restored after.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import query_distance_matrix
from repro_torch.kernels.ref import exact_float32_matmul


def _merge_topk(best_d, best_i, new_d, new_i, k: int):
    """Merge a (B, C) block of candidates into the running (B, k) best.

    A stable ascending sort keeps the lower position first on equal
    distances, the tie rule of ``jax.lax.top_k``.
    """
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    d_s, pos = torch.sort(d, dim=1, stable=True)
    return d_s[:, :k], torch.gather(i, 1, pos[:, :k])


def knn_scan(dist, Q, X, k: int, chunk: int = 8192, mode: str = "left"):
    """Exact k-NN of each query in Q against database X.

    Returns (dists (B, k) ascending float32, ids (B, k) int32).  ``mode="left"``
    is the paper's convention d(x, q) with the data point on the left.
    """
    B, n = Q.shape[0], X.shape[0]
    k = min(k, n)
    best_d = torch.full((B, k), torch.inf, dtype=torch.float32, device=Q.device)
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=Q.device)
    with exact_float32_matmul():
        for base in range(0, n, chunk):
            xblk = X[base:base + chunk]
            d = query_distance_matrix(dist, Q, xblk, mode=mode)
            ids = torch.arange(base, base + xblk.shape[0], dtype=torch.int32, device=Q.device)
            best_d, best_i = _merge_topk(best_d, best_i, d, ids.expand(B, -1), k)
    return best_d, best_i


def ground_truth(dist, Q, X, k: int, chunk: int = 8192, mode: str = "left"):
    """Alias used by tests/benchmarks: exact neighbors under ``dist``."""
    return knn_scan(dist, Q, X, k, chunk=chunk, mode=mode)
