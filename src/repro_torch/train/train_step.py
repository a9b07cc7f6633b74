"""Train-step factory and losses (PyTorch port of ``repro.train.train_step``).

``make_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients (``torch.autograd``),
accumulated over ``accum_steps`` microbatches when asked, a global-norm
clip, the optimizer's update added to the parameters in place.  Losses: the
LM's next-token cross-entropy with the MoE aux (off the mesh:
``sharded_xent`` waits for ROADMAP M17's sharding item), the GCN's node
cross-entropy, the two-tower in-batch softmax and the ranking models' binary
cross-entropy.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.gnn import loss_fn as gnn_loss_fn
from repro_torch.models.recsys import bce_loss, inbatch_softmax_loss
from repro_torch.models.transformer import forward
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm

GRAD_CLIP = 1.0  # repro's make_train_step default
ACCUM_DTYPE = torch.float32  # its microbatch gradient accumulator
AUX_WEIGHT = 0.01  # its lm_loss weight of the MoE aux loss


def lm_loss(model, batch, cfg, **fwd_kw):
    """Next-token cross-entropy (+ MoE aux, 0 for a dense model) in float32;
    batch: ``tokens`` and ``labels`` (B, T).  ``fwd_kw``: the attention blocks."""
    logits, aux = forward(model, batch["tokens"], cfg, **fwd_kw)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
    nll = torch.mean(lse - ll)
    return nll + AUX_WEIGHT * aux, {"nll": nll.detach(), "aux": aux.detach()}


def gnn_loss(model, batch, cfg, **kw):
    """(loss, {"nll": loss}): the GCN's node cross-entropy over ``batch`` (a
    graph dict), masked by ``batch["mask"]`` when it has one."""
    loss = gnn_loss_fn(model, batch, cfg, mask=batch.get("mask"), **kw)
    return loss, {"nll": loss.detach()}


def recsys_loss(model, batch, cfg):
    """(loss, {"nll": loss}): the in-batch softmax for the two-tower ``dot``
    model, the binary cross-entropy for every other interaction."""
    if cfg.interaction == "dot":
        loss = inbatch_softmax_loss(model, batch, cfg)
    else:
        loss = bce_loss(model, batch, cfg)
    return loss, {"nll": loss.detach()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *, accum_steps: int = 1):
    """``step(model, opt_state, batch)``; ``loss_fn(model, batch) -> (loss, aux)``.

    ``opt_state`` is ``optimizer.init`` of ``dict(model.named_parameters())``.
    With ``accum_steps > 1`` the batch's leading axis is split into
    microbatches; each microbatch's loss and gradient is divided by
    ``accum_steps`` and summed (gradients in ``ACCUM_DTYPE``); aux is the last
    microbatch's.  Metrics: ``loss`` and ``grad_norm`` (the norm before
    clipping), plus aux.
    """
    def grads_of(model, params, batch):
        loss, aux = loss_fn(model, batch)
        return loss, aux, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    def compute_grads(model, params, batch):
        if accum_steps == 1:
            loss, aux, grads = grads_of(model, params, batch)
            return loss.detach(), aux, grads
        split = {k: v.reshape((accum_steps, v.shape[0] // accum_steps) + v.shape[1:])
                 for k, v in batch.items()}
        acc_loss = 0.0
        acc = {k: torch.zeros(p.shape, dtype=ACCUM_DTYPE, device=p.device)
               for k, p in params.items()}
        for i in range(accum_steps):
            loss, aux, grads = grads_of(model, params, {k: v[i] for k, v in split.items()})
            acc_loss = acc_loss + loss.detach() / accum_steps
            acc = {k: a + (grads[k] / accum_steps).to(ACCUM_DTYPE) for k, a in acc.items()}
        return acc_loss, aux, acc

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux, grads = compute_grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k].to(p.dtype))
        return model, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    return step
