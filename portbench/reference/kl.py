"""KL divergence, written from the paper's definitions (Boytsov & Nyberg,
arXiv:1910.03534, §2): histograms floored at 1e-6,

    KL(u || v) = sum_i u_i (log u_i - log v_i)

with the data point on the left, ``d(x, q) = KL(x || q)``.  The matrices are
one matrix product each (``portbench.reference`` describes the interface).
"""

from __future__ import annotations

import torch

from portbench.reference import round_tf32

EPS = 1e-6


def safe(x: torch.Tensor) -> torch.Tensor:
    return x.clamp_min(EPS)


def _prep(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    return round_tf32(x) if tf32 else x


def pairs(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """KL(U[..] || V[..]) over the last axis, in float64."""
    u, v = safe(U).double(), safe(V).double()
    return (u * (u.log() - v.log())).sum(-1)


def left_matrix(Q: torch.Tensor, Xb: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """D[b, i] = KL(Xb[i] || Q[b]), float32."""
    x = safe(Xb)
    bias = (x * x.log()).sum(-1)
    s = _prep(-safe(Q).log(), tf32) @ _prep(x, tf32).T
    return s + bias[None, :]


def right_matrix(Q: torch.Tensor, Xb: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """D[b, i] = KL(Q[b] || Xb[i]), float32."""
    q = safe(Q)
    bias = (q * q.log()).sum(-1)
    s = _prep(q, tf32) @ _prep(-safe(Xb).log(), tf32).T
    return s + bias[:, None]
