"""Fused frontier gather + distance on the card (CUDA C++ for ``sm_90a``).

Replaces the TPU kernel ``src/repro/kernels/frontier_gather.py::frontier_scores``
(Pallas ``_kernel``, ``pallas_call`` at :95) with two entries:

* ``frontier_scores``: per query, gather its R candidate rows of the prepped
  database, dot each with the query rep in float32 and apply the distance's
  post-combine; ids < 0 score +inf.  One block per query: its caller is
  NN-descent, where every database row is a query (B = n), and which may
  write into a column range of a wider block.  The batched search step goes
  through ``gather_scores``, which computes the same function per cell.
* ``two_hop_scores``: the NN-descent round's join ``adj[adj[i]]``, grouped by
  the middle node so that each block of K rows ``x_rep[adj[j]]`` is read
  once per round instead of once for every node that lists ``j``.  The work
  list (``two_hop_work_list``) is plain PyTorch on the device.

Bound: device-memory bytes.  The NN-descent round's join at
n=1e6, K=30 reads each (K, m') block once and each query row once per edge,
about 31 GB (about 10 ms).  Design and source: ``csrc/frontier_gather.cu``.

The wrappers launch on the current stream and do not synchronise; each
counts its launches (``ops.launch_counts``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check_tensor as _check
from repro_torch.kernels.build import count_launch, load

EDGES_PER_ITEM = 32  # edges of one middle node scored by one block (kEdges)
MAX_K = 64  # rows per middle node the join kernel stages


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entries' parameters, in order (csrc/frontier_gather.cu)
_ARGTYPES = {"frontier_scores_launch": [_P] * 6 + [_I] * 6 + [_F, _P],
             "two_hop_scores_launch": [_P] * 3 + [_I] + [_P] * 5 + [_I] * 4 + [_F, _P]}


def _fn(name):
    fn = getattr(load("frontier_gather"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_rows(name, t, dtype, shape, device):
    """A 2-D tensor whose rows may be strided but whose columns are contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} must have contiguous columns")


def _out(out, shape, device):
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    _check_rows("out", out, torch.float32, shape, device)
    return out


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, post_id: int, c0: float = 0.0,
                    out=None):
    """(B, R) float32 left-query distances of the gathered rows (inf where id < 0).

    ids (B, R) int32 with -1 padding; q_rep (B, m') and q_bias (B,) the prepped
    queries; x_rep (n, m') and x_bias (n,) the prepped database; all float32,
    contiguous and on one CUDA device, except that ids may be a column range
    of a wider block (strided rows).  Ids must be < n.  ``out`` (B, R), if
    given, may also be a column range; the scores are written into it.
    """
    device = ids.device
    if device.type != "cuda":
        raise ValueError(f"frontier_scores launches a CUDA kernel; ids are on {device}")
    if ids.dim() != 2 or x_rep.dim() != 2:
        raise ValueError("ids and x_rep must be 2-D")
    B, R = ids.shape
    n, m = x_rep.shape
    _check_rows("ids", ids, torch.int32, (B, R), device)
    _check("q_rep", q_rep, torch.float32, (B, m), device)
    _check("q_bias", q_bias, torch.float32, (B,), device)
    _check("x_rep", x_rep, torch.float32, (n, m), device)
    _check("x_bias", x_bias, torch.float32, (n,), device)
    if post_id not in (0, 1, 2, 3):
        raise ValueError(f"unknown post id {post_id}")
    out = _out(out, (B, R), device)
    if B == 0 or R == 0:
        return out
    fn = _fn("frontier_scores_launch")
    with torch.cuda.device(device):
        err = fn(ids.data_ptr(), q_rep.data_ptr(), q_bias.data_ptr(), x_rep.data_ptr(),
                 x_bias.data_ptr(), out.data_ptr(), B, R, m, ids.stride(0), out.stride(0),
                 post_id, c0, _stream(device))
    if err != 0:
        raise RuntimeError(f"frontier_scores launch failed: cudaError_t {err}")
    count_launch("frontier_scores")
    return out


def two_hop_work_list(safe_adj):
    """The join's work list: ``(edges (n K,) int32, items (n_items, 3) int32)``.

    ``edges`` holds the edge ids ``i K + a`` sorted (stably) by their middle
    node ``j = safe_adj[i, a]``; each row ``(j, first, count)`` of ``items``
    names ``count <= EDGES_PER_ITEM`` consecutive edges of one ``j``, starting
    at ``edges[first]``.  A node of in-degree d gets ceil(d / EDGES_PER_ITEM)
    items, a node no edge names gets none.  Plain PyTorch on the tensor's device; one
    host sync for the item count.
    """
    n, K = safe_adj.shape
    dev = safe_adj.device
    chunk = EDGES_PER_ITEM
    j = safe_adj.reshape(-1)
    edges = torch.sort(j, stable=True).indices.to(torch.int32)
    counts = torch.bincount(j, minlength=n)
    pieces = (counts + chunk - 1) // chunk
    piece_start = torch.cumsum(pieces, 0) - pieces
    total = int(piece_start[-1] + pieces[-1]) if n else 0
    item_j = torch.repeat_interleave(torch.arange(n, device=dev), pieces, output_size=total)
    within = torch.arange(total, device=dev) - piece_start[item_j]
    first = (torch.cumsum(counts, 0) - counts)[item_j] + within * chunk
    count = torch.clamp(counts[item_j] - within * chunk, max=chunk)
    items = torch.stack([item_j, first, count], dim=1).to(torch.int32).contiguous()
    return edges, items


def two_hop_scores(safe_adj, q_rep, q_bias, x_rep, x_bias, post_id: int, c0: float = 0.0,
                   out=None):
    """(n, K*K) scores of the two-hop join, grouped by the middle node.

    ``out[i, a*K + b]`` is the left-query distance of ``x[c]`` from query
    ``i`` with ``j = safe_adj[i, a]``, ``c = safe_adj[j, b]``; +inf where
    ``c < 0`` or ``c == i``.  safe_adj (n, K) int32 with middle nodes in
    [0, n) (K <= 64); q_rep (n, m') and q_bias (n,) the rows prepped as
    queries; x_rep (n, m') and x_bias (n,) as database rows; float32,
    contiguous, one CUDA device.  ``out`` may be a column range of a wider
    block.
    """
    device = safe_adj.device
    if device.type != "cuda":
        raise ValueError(f"two_hop_scores launches a CUDA kernel; safe_adj is on {device}")
    if safe_adj.dim() != 2 or x_rep.dim() != 2:
        raise ValueError("safe_adj and x_rep must be 2-D")
    n, K = safe_adj.shape
    m = x_rep.shape[1]
    _check("safe_adj", safe_adj, torch.int32, (n, K), device)
    _check("q_rep", q_rep, torch.float32, (n, m), device)
    _check("q_bias", q_bias, torch.float32, (n,), device)
    _check("x_rep", x_rep, torch.float32, (n, m), device)
    _check("x_bias", x_bias, torch.float32, (n,), device)
    if post_id not in (0, 1, 2, 3):
        raise ValueError(f"unknown post id {post_id}")
    if K > MAX_K:
        raise ValueError(f"two_hop_scores stages at most {MAX_K} rows per node; K={K}")
    if n * K >= 2**31:
        raise ValueError(f"n*K={n * K} edges exceed the kernel's int32 edge ids")
    out = _out(out, (n, K * K), device)
    if n == 0 or K == 0:
        return out
    edges, items = two_hop_work_list(safe_adj)
    fn = _fn("two_hop_scores_launch")
    with torch.cuda.device(device):
        err = fn(safe_adj.data_ptr(), edges.data_ptr(), items.data_ptr(), items.shape[0],
                 q_rep.data_ptr(), q_bias.data_ptr(), x_rep.data_ptr(), x_bias.data_ptr(),
                 out.data_ptr(), K, m, out.stride(0), post_id, c0, _stream(device))
    if err != 0:
        raise RuntimeError(f"two_hop_scores launch failed: cudaError_t {err}")
    count_launch("two_hop_scores")
    return out
