"""Train-step factory (PyTorch port of ``repro.train.train_step``, recsys).

``make_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients (``torch.autograd``), a
global-norm clip, the optimizer's update added to the parameters in place.
Gradient accumulation and the LM and GNN losses wait for ROADMAP M17.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.recsys import _check_interaction, inbatch_softmax_loss
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm

GRAD_CLIP = 1.0  # repro's make_train_step default


def recsys_loss(model, batch, cfg):
    """(loss, {"nll": loss}): the two-tower in-batch softmax."""
    _check_interaction(cfg)
    loss = inbatch_softmax_loss(model, batch, cfg)
    return loss, {"nll": loss.detach()}


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *, accum_steps: int = 1):
    """``step(model, opt_state, batch)``; ``loss_fn(model, batch) -> (loss, aux)``.

    ``opt_state`` is ``optimizer.init`` of ``dict(model.named_parameters())``.
    Metrics: ``loss`` and ``grad_norm`` (the norm before clipping), plus aux.
    """
    if accum_steps != 1:
        raise NotImplementedError("gradient accumulation (accum_steps > 1) is not ported to "
                                  "repro_torch yet (ROADMAP M17)")

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux = loss_fn(model, batch)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        grads, gnorm = clip_by_global_norm(grads, GRAD_CLIP)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k])
        return model, opt_state, {"loss": loss.detach(), "grad_norm": gnorm, **aux}

    return step
