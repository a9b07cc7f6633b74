"""Fused frontier gather + distance on the card (CUDA C++ for ``sm_90a``).

Replaces the TPU kernel ``src/repro/kernels/frontier_gather.py::frontier_scores``
(Pallas ``_kernel``, ``pallas_call`` at :95).  One block per query gathers its
R candidate rows of the prepped database, dots each with the query rep in
float32 and applies the distance's post-combine; ids < 0 score +inf.

Bound: device-memory bytes.  A search step at B=64, R=120, m'=128 gathers
about 4 MB (about 1.2 us at 3.35 TB/s, below the launch overhead, and only 64
blocks for 132 SMs); an NN-descent round at n=1e6, R=248 gathers about 127 GB
of rows (about 38 ms).  Design and source: ``csrc/frontier_gather.cu``.

The wrapper launches on the current stream and does not synchronise; it
counts its launches in ``frontier_scores.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import load


def _lib():
    lib = load("frontier_gather")
    fn = lib.frontier_scores_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, post_id: int, c0: float = 0.0):
    """(B, R) float32 left-query distances of the gathered rows (inf where id < 0).

    ids (B, R) int32 with -1 padding; q_rep (B, m') and q_bias (B,) the prepped
    queries; x_rep (n, m') and x_bias (n,) the prepped database; all float32,
    contiguous and on one CUDA device.  Ids must be < n.
    """
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"frontier_scores launches a CUDA kernel; ids are on {device}")
    if ids.dim() != 2 or x_rep.dim() != 2:
        raise ValueError("ids and x_rep must be 2-D")
    B, R = ids.shape
    n, m = x_rep.shape
    _check("ids", ids, torch.int32, (B, R), device)
    _check("q_rep", q_rep, torch.float32, (B, m), device)
    _check("q_bias", q_bias, torch.float32, (B,), device)
    _check("x_rep", x_rep, torch.float32, (n, m), device)
    _check("x_bias", x_bias, torch.float32, (n,), device)
    if post_id not in (0, 1, 2, 3):
        raise ValueError(f"unknown post id {post_id}")
    out = torch.empty((B, R), dtype=torch.float32, device=device)
    if B == 0 or R == 0:
        return out
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ids.data_ptr(), q_rep.data_ptr(), q_bias.data_ptr(), x_rep.data_ptr(),
                 x_bias.data_ptr(), out.data_ptr(), B, R, m, post_id, c0, stream)
    if err != 0:
        raise RuntimeError(f"frontier_scores launch failed: cudaError_t {err}")
    frontier_scores.launches += 1
    return out


frontier_scores.launches = 0
