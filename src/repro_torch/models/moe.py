"""Mixture-of-Experts FFN: top-k routing with sort-based capacity dispatch
(PyTorch port of ``repro.models.moe``, the off-mesh path).

Tokens are sorted by their assigned expert (a stable sort, as ``jnp.argsort``)
and ranked within the expert with ``searchsorted``; an assignment whose rank
reaches the capacity C is dropped.  Dispatch gathers the kept tokens into an
(E*C, d) buffer, the experts run as batched products over E, and combine
gathers each assignment's slot back.  No (N, E) one-hot and no scatter: both
maps are injective on their kept entries, so their backwards are gathers too
(``_DispatchGather`` and ``_CombineGather``, ``repro``'s two custom VJPs).

``repro``'s dispatch backward sums the buffer's cotangents in SORTED
assignment order, token ``j // K`` for sorted position j, which is not the
token that position came from; its gradient with respect to the MoE input is
therefore not the derivative of its forward (ROADMAP §3).  ``_DispatchGather``
takes each assignment's slot through ``inv_order`` first, so its gradient is
the forward's derivative: what ``jax.grad`` gives for the same forward
without the custom VJP.

Routing runs in float32 (the router is a float32 weight in a bf16 model);
top-k breaks ties toward the lower expert id, as ``jax.lax.top_k`` does.

Under a mesh with a "model" axis that divides the experts, ``moe_ffn`` runs
``repro``'s expert-parallel region (``_moe_ffn_ep``) in the local view of
``sharding/api.py``: each rank routes its batch block, dispatches locally
into the slots of its own experts, all-gathers their weights over the data
axes, and one ``psum`` over "model" combines.  Its backward is autograd of
that local code (the dispatch is a plain gather there, as in ``repro``).
Under any other mesh the gather path runs on the rank's block with the MoE
weights replicated: their gradients sum over the data axes and the aux is
the ``pmean`` of the blocks'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding.api import (P, all_gather, batch_axes, current_mesh, pmean, psum,
                                      pvary)


# ---------------------------------------------------------------------------
# the two routing maps, gather-only both ways
# ---------------------------------------------------------------------------


def _take_rows(x, idx):
    """x (G, M, d), idx (G, R) -> (G, R, d): row idx[g, r] of x[g]."""
    g = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[g, idx]


class _DispatchGather(torch.autograd.Function):
    """tokens (G, Ng, d) -> buf (G, E*C, d) via the slot -> token gather.

    Backward: each token's cotangent is the sum over its K assignments of
    their buffer slots' cotangents (0 for a dropped assignment), a gather
    through ``dest`` taken in the tokens' own order (``inv_order``).
    """

    @staticmethod
    def forward(ctx, tokens, src, buf_valid, dest, inv_order):
        ctx.save_for_backward(dest, inv_order)
        ctx.n_tokens = tokens.shape[1]
        return _take_rows(tokens, src) * buf_valid[..., None].to(tokens.dtype)

    @staticmethod
    def backward(ctx, d_buf):
        dest, inv_order = ctx.saved_tensors
        G, EC, d = d_buf.shape
        K = dest.shape[1] // ctx.n_tokens
        slot = torch.gather(dest, 1, inv_order)  # assignment i's buffer slot (or E*C)
        picked = _take_rows(d_buf, slot.clamp(max=EC - 1))
        picked = picked * (slot < EC)[..., None].to(d_buf.dtype)
        return picked.reshape(G, ctx.n_tokens, K, d).sum(dim=2), None, None, None, None


class _CombineGather(torch.autograd.Function):
    """out_buf (G, E*C, d) -> per-assignment slots (G, Ng*K, d), in the
    tokens' order; 0 for a dropped assignment.

    Backward: buffer slot b's cotangent is that of the assignment it holds
    (sorted position ``s_safe[b]``, assignment ``order[s_safe[b]]``), 0 for
    an unfilled slot.
    """

    @staticmethod
    def forward(ctx, out_buf, dest, order, inv_order, s_safe, buf_valid):
        ctx.save_for_backward(order, s_safe, buf_valid)
        EC = out_buf.shape[1]
        slot = torch.gather(dest, 1, inv_order)
        picked = _take_rows(out_buf, slot.clamp(max=EC - 1))
        return picked * (slot < EC)[..., None].to(out_buf.dtype)

    @staticmethod
    def backward(ctx, d_slot):
        order, s_safe, buf_valid = ctx.saved_tensors
        d_out_buf = _take_rows(d_slot, torch.gather(order, 1, s_safe))
        d_out_buf = d_out_buf * buf_valid[..., None].to(d_slot.dtype)
        return d_out_buf, None, None, None, None, None


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def moe_layer_shapes(cfg: LMConfig) -> dict:
    """name -> (shape, dtype) of the MoE layer weights, stacked over L; the
    router is float32 whatever ``cfg.dtype``."""
    d, L, m = cfg.d_model, cfg.n_layers, cfg.moe
    dt = getattr(torch, cfg.dtype)
    E, ff = m.n_experts, m.d_ff_expert
    shapes = {"router": ((L, d, E), torch.float32), "e_gate": ((L, E, d, ff), dt),
              "e_up": ((L, E, d, ff), dt), "e_down": ((L, E, ff, d), dt)}
    if m.n_shared:
        ff_sh = ff * m.n_shared
        shapes.update({"sh_gate": ((L, d, ff_sh), dt), "sh_up": ((L, d, ff_sh), dt),
                       "sh_down": ((L, ff_sh, d), dt)})
    return shapes


def init_moe_layer(cfg: LMConfig, generator, device) -> dict:
    """The MoE layer weights at ``repro``'s scales: an expert's (d_in, d_out)
    block is N(0, 1) / sqrt(E * d_in), since ``repro`` draws all experts as
    one (E * d_in, d_out) matrix; drawn per layer and expert from
    ``generator``, cast to the weight's dtype on ``device``."""
    m = cfg.moe
    E = m.n_experts
    out = {}
    for name, (shape, dt) in moe_layer_shapes(cfg).items():
        w = torch.empty(shape, dtype=dt, device=device)
        d_in, d_out = shape[-2], shape[-1]
        expert = name.startswith("e_")
        scale = (E * d_in) ** -0.5 if expert else None
        for i in range(shape[0]):
            for e in range(E if expert else 1):
                block = dense_init(generator, d_in, d_out, scale, device=generator.device)
                (w[i, e] if expert else w[i]).copy_(block)
        out[name] = w
    return out


def moe_layer_specs(cfg: LMConfig, fsdp_axis: str = "data", tp_axis: str = "model"):
    """``repro``'s specs of the stacked MoE weights: experts over the TP/EP
    axis, d over the FSDP axis (all-gathered at use), the router replicated."""
    specs = {"router": P(None, None, None), "e_gate": P(None, tp_axis, fsdp_axis, None),
             "e_up": P(None, tp_axis, fsdp_axis, None),
             "e_down": P(None, tp_axis, None, fsdp_axis)}
    if cfg.moe.n_shared:
        specs.update({"sh_gate": P(None, fsdp_axis, tp_axis), "sh_up": P(None, fsdp_axis, tp_axis),
                      "sh_down": P(None, tp_axis, fsdp_axis)})
    return specs


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def _capacity(n_tokens: int, cfg: LMConfig) -> int:
    """Slots per expert: int(N K cf / E) + 1, rounded up to a multiple of 8, >= 8."""
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts) + 1
    return max(8, -(-c // 8) * 8)


def _group_count(batch: int) -> int:
    """Dispatch groups of the ``batch`` rows the gather path is given: 1.
    ``repro``'s GSPMD path splits its global batch into one group per data
    shard; in the local view a rank holds one data shard's block, which is
    that group (and off the mesh the batch is one group)."""
    return 1


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, descending, ties
    to the lower index (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _routing_plan(idx, E: int, C: int) -> dict:
    """Sort-based routing plan over groups, gather-only.

    idx: (G, Ng, K) expert assignments.  Returns int64 index tensors (bool
    ``buf_valid``), ``repro``'s six:
      src       (G, E*C)  token of each buffer slot (clipped; see buf_valid)
      buf_valid (G, E*C)  buffer slot actually filled
      dest      (G, Ng*K) buffer slot of each SORTED assignment (or E*C: dropped)
      order     (G, Ng*K) stable argsort of the flat assignments, inv_order its inverse
      s_safe    (G, E*C)  sorted position each buffer slot reads (clipped)
    """
    G, Ng, K = idx.shape
    NK = Ng * K
    dev = idx.device
    flat_e = idx.reshape(G, NK).long()
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # start offset of each expert's run inside the sorted assignments
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start_e = torch.searchsorted(sorted_e.contiguous(), experts, side="left")  # (G, E)
    rank = torch.arange(NK, device=dev)[None, :] - torch.gather(start_e, 1, sorted_e)
    dest = torch.where(rank < C, sorted_e * C + rank, E * C)

    # buffer slot -> sorted position
    s = (start_e[:, :, None] + torch.arange(C, device=dev)[None, None, :]).reshape(G, E * C)
    s_safe = s.clamp(0, NK - 1)
    buf_valid = (s < NK) & (torch.gather(sorted_e, 1, s_safe)
                            == torch.arange(E * C, device=dev)[None, :] // C)
    src = torch.gather(order, 1, s_safe) // K  # token ids
    inv_order = torch.argsort(order, dim=1, stable=True)
    return {"src": src, "buf_valid": buf_valid, "dest": dest, "order": order,
            "inv_order": inv_order, "s_safe": s_safe}


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------


def moe_ffn(h, lp: dict, cfg: LMConfig):
    """h: (B, T, d) -> (B, T, d), and the aux load-balance loss (f32 scalar):
    the Switch term E * sum(assign_frac * prob_frac).  ``lp``: one layer's
    weights (``router``, ``e_gate``, ``e_up``, ``e_down``, the ``sh_*``).

    Under a mesh with a "model" axis that divides the experts: the
    expert-parallel region ``_moe_ffn_ep`` (``h`` and the weights are this
    rank's blocks).  Otherwise the gather path over ``h`` as given, one
    dispatch group (``repro``'s GSPMD path, whose groups are the data shards
    of its global batch); under such a mesh ``h`` is this rank's block over
    the data axes and the MoE weights are whole and replicated, so their
    gradients sum over the data axes and the aux is the ``pmean`` of the
    blocks', as in the expert-parallel region."""
    mesh = current_mesh()
    if mesh is None:
        return _moe_ffn_gather(h, lp, cfg)
    if "model" in mesh.axis_names and cfg.moe.n_experts % mesh.shape["model"] == 0:
        return _moe_ffn_ep(h, lp, cfg, mesh)
    dp = batch_axes()
    lp = {k: pvary(w, dp, mesh) if k in moe_layer_shapes(cfg) else w for k, w in lp.items()}
    out, aux = _moe_ffn_gather(h, lp, cfg)
    return out, pmean(aux, dp, mesh)


def _route(tokens, router, K: int):
    """(probs (.., E) f32, renormalised top-K gate values, their expert ids)."""
    probs = torch.softmax(tokens.float() @ router, dim=-1)
    gate_vals, idx = _top_k(probs, K)
    return probs, gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9), idx


def _assign_frac(idx, E: int, n: int):
    """The share of the ``n`` assignments in ``idx`` that each expert got (an
    ``index_add_`` of ones, not ``bincount``, which reads a maximum back to
    the host; no gradient through the counts)."""
    flat = idx.reshape(-1)
    ones = torch.ones(flat.shape[0], dtype=torch.float32, device=idx.device)
    return torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(0, flat, ones) / n


def _moe_ffn_ep(h, lp: dict, cfg: LMConfig, mesh):
    """``repro``'s expert-parallel region in the local view.

    ``h`` (B_loc, T, d) is this rank's block over the data axes (replicated
    over "model"); ``router`` is replicated; ``e_gate``, ``e_up`` (E_loc,
    d / dp, ff), ``e_down`` (E_loc, ff, d / dp) are its block over ("model",
    data axes) and the shared experts' ``sh_gate``, ``sh_up`` (d / dp,
    ff_sh / tp), ``sh_down`` (ff_sh / tp, d / dp).  Routing and the aux are
    computed alike on every "model" rank from its block's N_loc tokens (C
    from N_loc); each rank fills and runs only its E_loc experts' slots, so
    the expert outputs, and the shared experts' over its ff block, are
    partial sums: one ``psum`` over "model" combines them.  The aux is the
    ``pmean`` over the data axes.  Returns the block's (B_loc, T, d) output.
    """
    m = cfg.moe
    B_loc, T, d = h.shape
    E, K = m.n_experts, m.top_k
    tp = mesh.shape["model"]
    E_loc = E // tp
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    N_loc = B_loc * T
    C = _capacity(N_loc, cfg)
    tokens = h.reshape(N_loc, d)
    # the router, and the tokens' and gates' expert-side uses, are replicated
    # inputs that each rank uses with its own tokens or experts
    router = pvary(lp["router"], dp, mesh)
    probs, gate_vals, idx = _route(tokens, router, K)
    aux = E * torch.sum(_assign_frac(idx, E, N_loc * K) * probs.mean(dim=0))

    plan = _routing_plan(idx[None], E, C)
    lo = mesh.axis_index("model") * E_loc * C
    tok_ep = pvary(tokens, "model", mesh)

    # local dispatch: this rank's experts' slots
    src = plan["src"][0, lo:lo + E_loc * C]
    valid = plan["buf_valid"][0, lo:lo + E_loc * C]
    buf = (tok_ep[src] * valid[:, None].to(h.dtype)).reshape(E_loc, C, d)

    # the experts' weights gathered over the data axes (ZeRO-3), local matmuls
    e_gate = all_gather(lp["e_gate"], dp, 1, tiled=True, varying=True, mesh=mesh)
    e_up = all_gather(lp["e_up"], dp, 1, tiled=True, varying=True, mesh=mesh)
    e_down = all_gather(lp["e_down"], dp, 2, tiled=True, varying=True, mesh=mesh)
    act = F.silu(buf @ e_gate) * (buf @ e_up)
    out_buf = (act @ e_down).reshape(E_loc * C, d)

    # partial combine: the assignments routed to this rank's experts
    rel = plan["dest"][0] - lo
    mine = (rel >= 0) & (rel < E_loc * C)
    picked = out_buf[rel.clamp(0, E_loc * C - 1)] * mine[:, None].to(h.dtype)
    slot = picked[plan["inv_order"][0]]  # unsorted: (N_loc * K, d)
    gates = pvary(gate_vals, "model", mesh).to(h.dtype)
    partial = torch.sum(slot.reshape(N_loc, K, d) * gates[..., None], dim=1)

    if m.n_shared:  # the shared experts, ff over "model": a partial too
        sh_gate = all_gather(lp["sh_gate"], dp, 0, tiled=True, varying=True, mesh=mesh)
        sh_up = all_gather(lp["sh_up"], dp, 0, tiled=True, varying=True, mesh=mesh)
        sh_down = all_gather(lp["sh_down"], dp, 1, tiled=True, varying=True, mesh=mesh)
        partial = partial + (F.silu(tok_ep @ sh_gate) * (tok_ep @ sh_up)) @ sh_down

    out = psum(partial, "model", mesh)
    return out.reshape(B_loc, T, d), pmean(aux, dp, mesh).float()


def _moe_ffn_gather(h, lp: dict, cfg: LMConfig):
    m = cfg.moe
    B, T, d = h.shape
    N = B * T
    E, K = m.n_experts, m.top_k
    G = _group_count(B)
    Ng = N // G
    C = _capacity(Ng, cfg)
    tokens = h.reshape(G, Ng, d)

    # routing, f32 for a stable softmax; the Switch-style aux over the assignments
    probs, gate_vals, idx = _route(tokens, lp["router"], K)  # (G, Ng, E), (G, Ng, K) x2
    aux = E * torch.sum(_assign_frac(idx, E, N * K) * probs.mean(dim=(0, 1)))

    plan = _routing_plan(idx, E, C)
    buf = _DispatchGather.apply(tokens, plan["src"], plan["buf_valid"], plan["dest"],
                                plan["inv_order"]).reshape(G, E, C, d)

    # the experts, batched over E and the groups
    act = F.silu(buf @ lp["e_gate"]) * (buf @ lp["e_up"])
    out_buf = (act @ lp["e_down"]).reshape(G, E * C, d)

    slot = _CombineGather.apply(out_buf, plan["dest"], plan["order"], plan["inv_order"],
                                plan["s_safe"], plan["buf_valid"])
    out = torch.sum(slot.reshape(G, Ng, K, d) * gate_vals[..., None].to(h.dtype), dim=2)

    if m.n_shared:
        out = out + (F.silu(tokens @ lp["sh_gate"]) * (tokens @ lp["sh_up"])) @ lp["sh_down"]
    return out.reshape(B, T, d), aux.float()
