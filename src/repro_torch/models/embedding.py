"""Sparse embedding tables (PyTorch port of ``repro.models.embedding``, off-mesh).

All per-field tables are concatenated into one (sum(vocab), dim) matrix with
per-field row offsets, so one gather serves every field.  The row-sharded
lookup over a device mesh waits for ROADMAP M17.
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
