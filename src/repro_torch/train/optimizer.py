"""Hand-rolled AdamW and Adafactor and their schedule (PyTorch port of
``repro.train.optimizer``).

The update follows ``repro``'s order of operations, not ``torch.optim.AdamW``'s:

    m <- b1 m + (1 - b1) g        v <- b2 v + (1 - b2) g g
    u  = (m / bc1) / (sqrt(v / bc2) + eps) + wd p        p <- p - lr_t u

with the step counted from 1 and bc_i = 1 - b_i^step.  Parameters, gradients
and moments are dicts of tensors keyed by parameter name; reductions over
them run in sorted-key order (the JAX package's tree order for the two-tower
params and the LM's).  Adafactor (Shazeer & Stern 2018) factors its second
moment over the trailing two axes and keeps the leading (layer) axis.
Optimizer states inherit the parameters' partition specs (``state_specs``;
Adafactor's drop the factored axis: ``adafactor_state_specs``).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.sharding.api import P, current_mesh, flatten, global_shape, pmean, psum, spec_axes


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)
    state_specs: Callable  # param_specs -> state specs


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


def global_norm(tree: dict, specs=None):
    """sqrt of the sum of squares of every tensor of ``tree`` (float32).

    ``specs`` ({name: ``P``}) under a mesh: ``tree`` holds this rank's
    blocks, and the norm is the global tensors': each block's sum of squares
    is ``psum``med over the axes its spec names (one ``psum`` per set of
    axes), so a replicated tensor counts once."""
    mesh = current_mesh()
    if specs is None or mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(tree[k].float())) for k in sorted(tree)))
    by_axes = {}
    for k in sorted(tree):
        axes = tuple(sorted(spec_axes(specs.get(k, P()))))
        by_axes[axes] = by_axes.get(axes, 0.0) + torch.sum(torch.square(tree[k].float()))
    return torch.sqrt(sum(psum(v, axes, mesh) for axes, v in sorted(by_axes.items())))


def clip_by_global_norm(grads: dict, max_norm: float, specs=None):
    """``grads`` scaled by min(1, max_norm / norm), in float32 as ``repro``'s
    product with its float32 scale is (a bfloat16 gradient is not rounded
    again); also returns the norm (``global_norm``'s, of the global
    gradient when ``specs`` is given)."""
    norm = global_norm(grads, specs)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.float() * scale for k, g in grads.items()}, norm


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

    def state_specs(param_specs):
        return {"step": P(), "mu": param_specs, "nu": param_specs}

    return Optimizer(init, update, state_specs)


# a stacked tensor (ndim >= 3) of at least this many elements is updated per
# leading slice, with a per-slice RMS clip (repro's threshold, optimizer.py:157)
PER_SLICE_MIN_SIZE = 1 << 28
# repro's Adafactor defaults: beta = 1 - (step + 1)^-decay, the floor added
# to g^2, the RMS the update is clipped to
ADAFACTOR_DECAY, ADAFACTOR_EPS, ADAFACTOR_CLIP = 0.8, 1e-30, 1.0


def adafactor(lr: Callable, decay: float = ADAFACTOR_DECAY, eps: float = ADAFACTOR_EPS,
              clip_threshold: float = ADAFACTOR_CLIP, weight_decay: float = 0.0,
              min_dim_factored: int = 128, specs=None) -> Optimizer:
    """Adafactor in ``repro``'s order: factored (row ``vr`` and column ``vc``
    statistics) where both trailing dims are >= ``min_dim_factored``, no first
    moment, beta = 1 - (step + 1)^-decay, ``eps`` added to g^2 (and the floor
    of the row statistics' mean), the update clipped to RMS
    ``clip_threshold``, optional weight decay.

    ``specs`` ({name: ``P``} or ``param_specs``' tree): the parameters are
    this rank's blocks on the current mesh (``init`` and ``update`` run
    under it).  Each mean over a dim split over mesh axes (a row or column
    statistic, the row statistic's mean, the update's RMS) is the local mean
    ``pmean``ed over those axes, as the global mean of equal blocks; whether
    a tensor is factored, or updated per slice, follows its global shape."""
    flat = None if specs is None else flatten(specs)

    def entries(k, p):
        """The spec entries of parameter ``k``, padded to its rank (None: whole)."""
        if flat is None or current_mesh() is None:
            return [None] * p.ndim
        spec = list(flat[k])
        return spec + [None] * (p.ndim - len(spec))

    def full_shape(k, p):
        return global_shape(p.shape, entries(k, p), current_mesh()) if flat else tuple(p.shape)

    def use_factored(shape):
        return len(shape) >= 2 and min(shape[-1], shape[-2]) >= min_dim_factored

    def mean(x, dim, axes):
        """The mean over ``dim`` of the global tensor whose block is ``x``."""
        return pmean(torch.mean(x, dim=dim, keepdim=True), spec_axes(P(axes)),
                     current_mesh() if axes else None)

    def init(params: dict) -> dict:
        def one(k, p):
            z = functools.partial(torch.zeros, dtype=torch.float32, device=p.device)
            if use_factored(full_shape(k, p)):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"step": 0, "v": {k: one(k, p) for k, p in params.items()}}

    def update(grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr_t = lr(step)
        beta = 1.0 - (torch.tensor(step, dtype=torch.float32) + 1.0) ** -decay

        def one_small(g, s, p, ent):
            g = g.float()
            b = beta.to(g.device)
            g2 = g * g + eps
            if "vr" in s:
                vr = b * s["vr"] + (1 - b) * mean(g2, -1, ent[-1])[..., 0]
                vc = b * s["vc"] + (1 - b) * mean(g2, -2, ent[-2])[..., 0, :]
                r = vr / torch.clamp(mean(vr, -1, ent[-2]), min=eps)
                u = g / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :])
                new_s = {"vr": vr, "vc": vc}
            else:
                v = b * s["v"] + (1 - b) * g2
                u = g / torch.sqrt(v)
                new_s = {"v": v}
            sq = torch.mean(u * u)
            axes = spec_axes(P(*ent))
            if axes:
                sq = pmean(sq, axes, current_mesh())
            rms = torch.sqrt(sq + 1e-30)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.detach().float()
            return (-lr_t.to(g.device) * u).to(p.dtype), new_s

        def one(k, g, s, p):
            # a huge stacked tensor updates slice by slice: bounds the f32
            # temporaries to one layer; the RMS clip is then per layer
            ent = entries(k, p)
            if p.ndim >= 3 and math.prod(full_shape(k, p)) >= PER_SLICE_MIN_SIZE:
                outs = [one_small(g[i], {n: t[i] for n, t in s.items()}, p[i], ent[1:])
                        for i in range(p.shape[0])]
                return (torch.stack([o[0] for o in outs]),
                        {n: torch.stack([o[1][n] for o in outs]) for n in s})
            return one_small(g, s, p, ent)

        updates, v = {}, {}
        for k, g in grads.items():
            updates[k], v[k] = one(k, g, state["v"][k], params[k])
        return updates, {"step": step, "v": v}

    def state_specs(param_specs):
        # the factored statistics drop an axis, which the specs alone cannot show
        raise NotImplementedError("use adafactor_state_specs(params, param_specs) for adafactor")

    return Optimizer(init, update, state_specs)


def adafactor_state_specs(params: dict, param_specs, min_dim_factored: int = 128) -> dict:
    """Adafactor's state specs: per parameter name of ``params``, the
    factored ``vr`` (the last axis dropped) and ``vc`` (the second to last)
    or the unfactored ``v``, from its spec in ``param_specs`` (a flat dict
    or ``repro``'s nested tree, padded with None to the parameter's rank)."""
    specs = flatten(param_specs)

    def one(p, spec):
        entries = list(spec) + [None] * (p.ndim - len(spec))
        if p.ndim >= 2 and min(p.shape[-1], p.shape[-2]) >= min_dim_factored:
            return {"vr": P(*entries[:-1]), "vc": P(*(entries[:-2] + entries[-1:]))}
        return {"v": P(*entries)}

    return {"step": P(), "v": {k: one(p, specs[k]) for k, p in params.items()}}
