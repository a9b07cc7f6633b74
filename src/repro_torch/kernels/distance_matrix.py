"""Distance matrix with the fused post-combine on Hopper tensor cores (CUDA
C++ for ``sm_90a``).

Replaces the TPU kernel ``src/repro/kernels/distance_matrix.py::distance_matrix``
(Pallas ``_kernel_whole_k`` / ``_kernel_tiled_k``, ``pallas_call`` at :119
and :138).  ``wgmma`` from TMA-staged, 128-byte-swizzled shared memory:
persistent blocks of one producer warp and two consumer warpgroups walk
128 x 128 (for N <= 64, 128 x 64) output tiles; float32 reps run as
3xTF32 (hi/lo split, three products), bf16 reps as one bf16 pass; the
post-combine in the epilogue; ragged B, N and m' through TMA's zero fill
and a masked store.  Reps whose rows or bases are not whole 16-byte words
(m' % 4 != 0, bf16: m' % 8 != 0), which TMA cannot read, are staged by the
producer warp with plain loads into the same layout.

Bound: tensor-core operations (3 x 2 B N m' at 495 TFLOP/s) or bytes,
whichever is larger at the shape.  ``knn_scan`` scores every chunk with it
on the card, and ``build_sharded``'s stitch.  Design and source:
``csrc/distance_matrix.cu``.

The wrapper launches on the current stream and does not synchronise; it
counts its launches (``ops.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor, count_launch, load

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    fn = load("distance_matrix").distance_matrix_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def distance_matrix(q_rep, x_rep, q_bias, x_bias, post_id: int, c0: float = 0.0):
    """(B, N) float32 left-query distances D[b, i] = post(q_rep[b] . x_rep[i]).

    q_rep (B, m') and x_rep (N, m') both float32 or both bfloat16; q_bias (B,)
    and x_bias (N,) float32; all contiguous and on one CUDA device; m' >= 1.
    """
    device = q_rep.device
    if device.type != "cuda":
        raise ValueError(f"distance_matrix launches a CUDA kernel; q_rep is on {device}")
    if q_rep.dim() != 2 or x_rep.dim() != 2:
        raise ValueError("q_rep and x_rep must be 2-D")
    B, m = q_rep.shape
    N = x_rep.shape[0]
    check_tensor("q_rep", q_rep, tuple(_DTYPES), (B, m), device)
    check_tensor("x_rep", x_rep, q_rep.dtype, (N, m), device)
    check_tensor("q_bias", q_bias, torch.float32, (B,), device)
    check_tensor("x_bias", x_bias, torch.float32, (N,), device)
    if post_id not in (0, 1, 2, 3):
        raise ValueError(f"unknown post id {post_id}")
    if m == 0:
        raise ValueError("distance_matrix needs m' >= 1")
    out = torch.empty((B, N), dtype=torch.float32, device=device)
    if B == 0 or N == 0:
        return out
    fn = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q_rep.data_ptr(), x_rep.data_ptr(), q_bias.data_ptr(), x_bias.data_ptr(),
                 out.data_ptr(), B, N, m, _DTYPES[q_rep.dtype], post_id, c0, stream)
    if err != 0:
        raise RuntimeError(f"distance_matrix launch failed: cudaError_t {err}")
    count_launch("distance_matrix")
    return out
