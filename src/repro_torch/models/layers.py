"""Shared layers (PyTorch port of ``repro.models.layers``: ``dense_init``).

Attention, norms and the rest wait for ROADMAP M17.
"""

from __future__ import annotations

from typing import Optional

import torch


def dense_init(generator, d_in: int, d_out: int, scale: Optional[float] = None,
               device="cpu") -> torch.Tensor:
    """(d_in, d_out) float32 weights, N(0, 1) x ``scale`` (default d_in^-1/2)."""
    scale = scale if scale is not None else d_in ** -0.5
    return torch.randn((d_in, d_out), generator=generator, device=device) * scale
