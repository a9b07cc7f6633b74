"""Neighbor gather + distance per (query, candidate) cell on the card (CUDA
C++ for ``sm_90a``).

Replaces the TPU kernel ``src/repro/kernels/gather_topk.py::gather_scores``
(Pallas ``_kernel``, ``pallas_call`` at :79).  Two CUDA kernels, chosen by
the shape: where a row is 17 or more 16-byte words (m' >= 68) and a row of
ids holds a run of cells (8; 4 for rows over 32 words), a warp scores a run
of consecutive cells of one row, staging their rows with ``cp.async``
before any product; otherwise (the wave builder's reverse edges, M = 1)
each cell gets G = min(32, pow2 >= m'/4) lanes and loads its id, row and
query row in one batch.  The sums equal the first (one warp per cell)
design's bit for bit.  +inf where the id is < 0.

It computes the same function as ``frontier_scores`` with another
decomposition (per cell, not per query) and scores every batched search
step (the searcher's and the wave builder's candidate blocks, where it
beats the per-query kernel) and the wave builder's reverse edges;
``frontier_scores`` is left to NN-descent, where every row is its own query.

Bound: device-memory bytes.  Design and source: ``csrc/gather_topk.cu``.

The wrapper launches on the current stream and does not synchronise; it
counts its launches (``ops.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, count_launch, load


def _lib():
    fn = load("gather_topk").gather_scores_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def gather_scores(ids, q_rep, q_bias, x_rep, x_bias, post_id: int, c0: float = 0.0):
    """(B, M) float32 left-query distances of the gathered rows (inf where id < 0).

    ids (B, M) int32 with -1 padding; q_rep (B, m') and q_bias (B,) the
    prepped queries; x_rep (n, m') and x_bias (n,) the prepped database; all
    float32, contiguous and on one CUDA device.  Ids must be < n.
    """
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"gather_scores launches a CUDA kernel; ids are on {device}")
    if ids.dim() != 2 or x_rep.dim() != 2:
        raise ValueError("ids and x_rep must be 2-D")
    B, M = ids.shape
    n, m = x_rep.shape
    check_tensor("ids", ids, torch.int32, (B, M), device)
    check_tensor("q_rep", q_rep, torch.float32, (B, m), device)
    check_tensor("q_bias", q_bias, torch.float32, (B,), device)
    check_tensor("x_rep", x_rep, torch.float32, (n, m), device)
    check_tensor("x_bias", x_bias, torch.float32, (n,), device)
    if post_id not in (0, 1, 2, 3):
        raise ValueError(f"unknown post id {post_id}")
    out = torch.empty((B, M), dtype=torch.float32, device=device)
    if B == 0 or M == 0:
        return out
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(), q_rep.data_ptr(), q_bias.data_ptr(), x_rep.data_ptr(),
                 x_bias.data_ptr(), out.data_ptr(), B, M, m, post_id, c0, stream)
    if err != 0:
        raise RuntimeError(f"gather_scores launch failed: cudaError_t {err}")
    count_launch("gather_scores")
    return out
