"""Sparse embedding tables (PyTorch port of ``repro.models.embedding``, off-mesh).

All per-field tables are concatenated into one (sum(vocab), dim) matrix with
per-field row offsets, so one gather serves every field.  ``embedding_bag``
reduces ragged multi-hot bags with ``index_add_`` (sum, mean) and
``scatter_reduce_`` (max).  The row-sharded lookup over a device mesh waits
for ROADMAP M17.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def field_offsets(vocab_sizes: Sequence[int], device="cpu") -> torch.Tensor:
    """(F,) int64 row offset of each field in the concatenated table."""
    off = np.cumsum((0,) + tuple(vocab_sizes[:-1]), dtype=np.int64)
    if off[-1] + vocab_sizes[-1] >= 2 ** 31:
        raise ValueError("concatenated table exceeds int32")
    return torch.from_numpy(off).to(device)


def init_table(generator, vocab_sizes: Sequence[int], dim: int, device="cpu") -> torch.Tensor:
    """(sum(vocab_sizes), dim) float32 table, N(0, 1) x dim^-1/2."""
    total = int(sum(vocab_sizes))
    return torch.randn((total, dim), generator=generator, device=device) * dim ** -0.5


def embedding_lookup(table, ids, offsets) -> torch.Tensor:
    """ids: (B, F) per-field local ids -> (B, F, dim): ``table[ids + offsets]``."""
    return table[ids.long() + offsets.to(ids.device)[None, :]]


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
