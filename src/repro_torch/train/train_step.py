"""Train-step factory and losses (PyTorch port of ``repro.train.train_step``).

``make_train_step`` returns ``step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients (``torch.autograd``),
accumulated over ``accum_steps`` microbatches when asked (in
``accum_dtype``), a global-norm clip at ``grad_clip``, the optimizer's
update added to the parameters in place.  A model that carries ``specs``
(its blocks' layout on the current mesh) is clipped by the norm of the
global gradient: each block's squares summed over its spec's axes.
Losses: the LM's next-token cross-entropy with the MoE aux (on a mesh with
a "model" axis through ``sharded_xent``), the GCN's node cross-entropy, the
two-tower in-batch softmax and the ranking models' binary cross-entropy.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.gnn import loss_fn as gnn_loss_fn
from repro_torch.models.recsys import bce_loss, inbatch_softmax_loss
from repro_torch.models.transformer import forward, forward_hidden, lm_head, sharded_head
from repro_torch.sharding.api import (P, all_gather, batch_axes, current_mesh, pmean, psum,
                                      pvary, shard)
from repro_torch.train.optimizer import Optimizer, clip_by_global_norm

AUX_WEIGHT = 0.01  # repro's default lm_loss weight of the MoE aux loss


def sharded_xent(hidden, head, labels, mesh, *, tp_axis: str = "model", t_chunk: int = 512,
                 gathered: bool = False):
    """Cross-entropy with the LM head fused inside ``repro``'s ``shard_map``
    region, in the local view: ``hidden`` (B_local, T, d) and ``labels``
    (B_local, T) are this rank's blocks over the data axes, ``head`` (d,
    V_local) its vocab block over ``tp_axis``; returns the replicated mean
    over the global B x T.  ``gathered``: ``head`` comes from an FSDP gather
    over the data axes, whose backward already sums its gradient there.

    Logits exist only as (B_local, t_chunk, V_local) float32 chunks, each
    recomputed in the backward (``torch.utils.checkpoint``, whose recompute
    runs the chunk's collectives again, in the same order on every rank).
    The max is an all-gather of the detached chunk maxima; the sums are
    ``psum``s over ``tp_axis``, then over the data axes.
    """
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    Bl, T, d = hidden.shape
    B = Bl * mesh.size_of(dp)
    V_local = head.shape[1]
    tc = min(t_chunk, T)
    n_chunks = max(T // tc, 1)
    v_lo = mesh.axis_index(tp_axis) * V_local
    # hidden is replicated over tp_axis and head over the data axes, and each
    # rank uses its copy with its own vocab block or tokens
    x = pvary(hidden, tp_axis, mesh)
    head_l = head if gathered else pvary(head, dp, mesh)
    cols = torch.arange(V_local, device=hidden.device)

    def chunk_nll(xc, lc):
        logits = (xc @ head_l).float()  # (Bl, tc, V_local)
        m = all_gather(logits.amax(dim=-1).detach(), tp_axis, mesh=mesh).amax(dim=0)
        se = psum(torch.sum(torch.exp(logits - m[..., None]), dim=-1), tp_axis, mesh)
        lse = torch.log(se) + m
        pick = torch.where(cols == (lc - v_lo)[..., None], logits, 0.0)
        ll = psum(torch.sum(pick, dim=-1), tp_axis, mesh)
        return torch.sum(lse - ll)

    xs = x.reshape(Bl, n_chunks, tc, d)
    ls = labels.long().reshape(Bl, n_chunks, tc)
    total = sum(checkpoint(chunk_nll, xs[:, i], ls[:, i], use_reentrant=False)
                for i in range(n_chunks))
    return psum(total, dp, mesh) / (B * T)


def lm_loss(model, batch, cfg, aux_weight: float = AUX_WEIGHT, **fwd_kw):
    """Next-token cross-entropy (+ ``aux_weight`` x the MoE aux, 0 for a dense
    model) in float32; batch: ``tokens`` and ``labels`` (B, T).  ``fwd_kw``:
    the attention blocks.

    On a mesh (the local view: the batch is this rank's block over the data
    axes, the weights replicated or FSDP x TP blocks) the loss is the mean
    over the global batch: with a "model" axis through ``sharded_xent`` on
    this rank's vocab block of the head, else the ``pmean`` of the blocks'
    means over the data axes."""
    mesh = current_mesh()
    if mesh is not None and "model" in mesh.axis_names:
        hidden, aux = forward_hidden(model, batch["tokens"], cfg, **fwd_kw)
        if model.specs is not None:
            head = sharded_head(model, cfg)
            nll = sharded_xent(hidden, head, batch["labels"], mesh, gathered=True)
        else:
            head = shard(lm_head(model, cfg), P(None, "model"), mesh)
            nll = sharded_xent(hidden, head, batch["labels"], mesh)
    else:
        logits, aux = forward(model, batch["tokens"], cfg, **fwd_kw)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, batch["labels"].long()[..., None])[..., 0]
        nll = pmean(torch.mean(lse - ll), batch_axes())
    return nll + aux_weight * aux, {"nll": nll.detach(), "aux": aux.detach()}


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


def make_train_step(loss_fn: Callable, optimizer: Optimizer, *, grad_clip: float = 1.0,
                    accum_steps: int = 1, accum_dtype=torch.float32):
    """``step(model, opt_state, batch)``; ``loss_fn(model, batch) -> (loss, aux)``.

    ``opt_state`` is ``optimizer.init`` of ``dict(model.named_parameters())``.
    With ``accum_steps > 1`` the batch's leading axis is split into
    microbatches; each microbatch's loss and gradient is divided by
    ``accum_steps`` and summed (gradients in ``accum_dtype``: bfloat16 halves
    the accumulator, as ``repro`` does for models over 10^11 parameters); aux
    is the last microbatch's.  The gradients are clipped to global norm
    ``grad_clip`` (of the global gradient when ``model.specs`` lays out its
    blocks).  Metrics: ``loss`` and ``grad_norm`` (the norm before
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
        acc = {k: torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
               for k, p in params.items()}
        for i in range(accum_steps):
            loss, aux, grads = grads_of(model, params, {k: v[i] for k, v in split.items()})
            acc_loss = acc_loss + loss.detach() / accum_steps
            acc = {k: a + (grads[k] / accum_steps).to(accum_dtype) for k, a in acc.items()}
        return acc_loss, aux, acc

    def step(model, opt_state, batch):
        params = dict(model.named_parameters())
        loss, aux, grads = compute_grads(model, params, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip, getattr(model, "specs", None))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        with torch.no_grad():
            for k, p in params.items():
                p.add_(updates[k].to(p.dtype))
        return model, opt_state, {"loss": loss, "grad_norm": gnorm, **aux}

    return step
