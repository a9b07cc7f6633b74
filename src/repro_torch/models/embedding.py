"""Sparse embedding tables (PyTorch port of ``repro.models.embedding``).

All per-field tables are concatenated into one (sum(vocab), dim) matrix with
per-field row offsets, so one gather serves every field.  ``embedding_bag``
reduces ragged multi-hot bags with ``index_add_`` (sum, mean) and
``scatter_reduce_`` (max).

On a mesh the table is row-sharded (``table_spec``) and ``embedding_lookup``
is ``repro``'s ``shard_map`` region in the local view (``sharding/api.py``):
each rank takes the replicated ids that fall in its rows (zeros elsewhere)
and one collective combines the partial lookups, moving (B, F, dim), never
the table.  Its backward scatter-adds into the rank's own rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.sharding.api import P, all_gather, current_mesh, psum, psum_scatter


def field_offsets(vocab_sizes: Sequence[int], device="cpu") -> torch.Tensor:
    """(F,) int64 row offset of each field in the concatenated table."""
    off = np.cumsum((0,) + tuple(vocab_sizes[:-1]), dtype=np.int64)
    if off[-1] + vocab_sizes[-1] >= 2 ** 31:
        raise ValueError("concatenated table exceeds int32")
    return torch.from_numpy(off).to(device)


def init_table(generator, vocab_sizes: Sequence[int], dim: int, device="cpu",
               dtype=torch.float32) -> torch.Tensor:
    """(sum(vocab_sizes), dim) table, N(0, 1) x dim^-1/2 drawn in float32,
    then cast to ``dtype``."""
    total = int(sum(vocab_sizes))
    return (torch.randn((total, dim), generator=generator, device=device)
            * dim ** -0.5).to(dtype)


def table_spec(tp_axis: str = "model", fsdp_axis: str = None):
    """Rows sharded over the TP axis, and over the FSDP axis too when given."""
    if fsdp_axis:
        return P((tp_axis, fsdp_axis), None)
    return P(tp_axis, None)


def embedding_lookup(table, ids, offsets, *, row_axes=("model", "data")) -> torch.Tensor:
    """ids: (B, F) per-field local ids -> (B, F, dim): ``table[ids + offsets]``.

    Under a mesh with any of ``row_axes``: ``table`` is this rank's row block
    (``P(axes, None)``, the shard index row-major over the axes present) and
    ``ids`` the replicated batch.  A masked local take, then, when B splits
    over the shards, a ``psum_scatter`` in the order ``(axes[-1],) +
    axes[:-1]`` and a re-gather over ``axes[:-1]``: the rank's block
    ``P((axes[-1],), None, None)`` of the rows; else one ``psum``: all rows.
    """
    flat = ids.long() + offsets.to(ids.device)[None, :]
    mesh = current_mesh()
    axes = tuple(a for a in row_axes if mesh is not None and a in mesh.axis_names)
    if not axes:
        return table[flat]
    n_row_shards = mesh.size_of(axes)
    B = flat.shape[0]
    use_scatter = B % n_row_shards == 0 and B >= n_row_shards
    rows_local = table.shape[0]
    rel = flat - mesh.index(axes) * rows_local
    inside = (rel >= 0) & (rel < rows_local)
    emb = table[rel.clamp(0, rows_local - 1)] * inside[..., None].to(table.dtype)
    if use_scatter:
        # the batch axis first: after the re-gather each rank's rows are contiguous
        part = psum_scatter(emb, (axes[-1],) + axes[:-1], 0)
        return all_gather(part, axes[:-1], 0, tiled=True)
    return psum(emb, axes)


def embedding_bag(table, ids, segment_ids, n_bags: int, mode: str = "sum",
                  weights=None) -> torch.Tensor:
    """EmbeddingBag: ragged multi-hot ids -> per-bag reduced embeddings.

    ids: (nnz,) rows, a negative id contributes nothing; segment_ids: (nnz,)
    bag index in [0, n_bags); weights: optional (nnz,) per-id factors.
    -> (n_bags, dim).  ``mode`` sum | mean (over the bag's valid ids) | max;
    an empty bag gives zeros, and a non-finite max maps to 0.
    """
    valid = ids >= 0
    emb = table[torch.where(valid, ids, 0).long()]
    if weights is not None:
        emb = emb * weights[:, None]
    emb = torch.where(valid[:, None], emb, 0.0)
    seg = segment_ids.long()
    s = torch.zeros((n_bags, table.shape[1]), dtype=emb.dtype, device=emb.device)
    s.index_add_(0, seg, emb)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.zeros(n_bags, dtype=emb.dtype, device=emb.device)
        cnt.index_add_(0, seg, valid.to(emb.dtype))
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if mode == "max":
        m = torch.full((n_bags, table.shape[1]), -torch.inf, dtype=emb.dtype, device=emb.device)
        m.scatter_reduce_(0, seg[:, None].expand(emb.shape),
                          torch.where(valid[:, None], emb, -torch.inf), "amax")
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(mode)
