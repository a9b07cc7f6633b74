"""Hand-rolled AdamW and its schedule (PyTorch port of ``repro.train.optimizer``).

The update follows ``repro``'s order of operations, not ``torch.optim.AdamW``'s:

    m <- b1 m + (1 - b1) g        v <- b2 v + (1 - b2) g g
    u  = (m / bc1) / (sqrt(v / bc2) + eps) + wd p        p <- p - lr_t u

with the step counted from 1 and bc_i = 1 - b_i^step.  Parameters, gradients
and moments are dicts of tensors keyed by parameter name; reductions over
them run in sorted-key order (the JAX package's tree order for the two-tower
params).  Adafactor waits for ROADMAP M17.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to ``floor`` x peak;
    ``lr(step)`` is a float32 0-d tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(tree: dict):
    """sqrt of the sum of squares of every tensor of ``tree`` (float32)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree)))


def clip_by_global_norm(grads: dict, max_norm: float):
    """``grads`` scaled by min(1, max_norm / norm); also returns the norm."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def adamw(lr: Callable, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    """AdamW in ``repro``'s order (module docstring); ``lr(step)`` the schedule."""
    def init(params: dict) -> dict:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"step": 0, "mu": zeros, "nu": {k: z.clone() for k, z in zeros.items()}}

    def update(grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr_t = lr(step)
        step_f = torch.tensor(step, dtype=torch.float32)
        bc1 = 1 - b1 ** step_f
        bc2 = 1 - b2 ** step_f
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            p = params[k]
            g = g.float()
            m = b1 * state["mu"][k] + (1 - b1) * g
            v = b2 * state["nu"][k] + (1 - b2) * g * g
            u = (m / bc1.to(g.device)) / (torch.sqrt(v / bc2.to(g.device)) + eps)
            u = u + weight_decay * p.detach().float()
            updates[k] = (-lr_t.to(g.device) * u).to(p.dtype)
            mu[k], nu[k] = m, v
        return updates, {"step": step, "mu": mu, "nu": nu}

    return Optimizer(init, update)
