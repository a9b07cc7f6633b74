"""Decoder-only transformer LM, dense and MoE (PyTorch port of
``repro.models.transformer``).

Parameters keep ``repro``'s STACKED layout: each per-layer weight is one
(L, d_in, d_out) parameter (``layers.wq`` ... ``layers.w_down``, the norms
(L, d)), beside ``embed`` (V, d), ``ln_f`` (d,) and, when the embeddings are
not tied, ``lm_head`` (d, V).  An MoE model holds ``repro``'s MoE names in
place of ``w_gate``, ``w_up`` and ``w_down``: ``router`` (L, d, E) in
float32, ``e_gate``, ``e_up`` (L, E, d, ff), ``e_down`` (L, E, ff, d) and,
with shared experts, ``sh_gate``, ``sh_up``, ``sh_down``
(``layer_shapes``).  So ``convert.lm_params_from_jax`` is a copy,
checkpoint names follow ``repro``'s tree, and Adafactor's RMS clip runs over
the whole stacked tensor as ``repro``'s does.  The layer loop is Python; one
``torch.unbind`` per stacked parameter hands each layer its views, so the
backward stacks each gradient once.

``prefill`` and ``decode_step`` serve: the KV cache is (L, B, max_len, Hkv,
dh) per k and v plus ``length`` (B,) int32, and ``decode_step`` writes the
new token's k and v into it in place.  gemma3's local:global pattern picks
each layer's window in Python (``layer_locality``).

Each layer's FFN is the SwiGLU MLP or ``models/moe.py``'s ``moe_ffn``,
whose load-balance aux ``forward`` sums over the layers.

On a mesh (the local view of ``sharding/api.py``) the batch is this rank's
block over the data axes and the dense weights are replicated: under
``use_mesh`` each dense weight's gradient is summed over the data axes
(``pvary``), the MoE FFN runs expert-parallel, and ``decode_step(mesh=)``
attends sequence-parallel over its block of the cache (``kv_cache_specs``)
with an exact log-sum-exp combine.  ``param_specs`` is ``repro``'s
FSDP x TP layout, the layout a dry run reckons with.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import (
    apply_rope,
    blockwise_attention,
    decode_attention_local,
    dense_init,
    lse_combine,
    rms_norm,
    swiglu,
)
from repro_torch.models.moe import init_moe_layer, moe_ffn, moe_layer_shapes, moe_layer_specs
from repro_torch.sharding.api import P, batch_axes, current_mesh, pmax, psum, pvary


def _dt(cfg: LMConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def layer_shapes(cfg: LMConfig) -> dict:
    """name -> (shape, dtype) of the stacked per-layer weights: attention and
    norms, then the dense MLP's or the MoE layer's."""
    d, L, dt = cfg.d_model, cfg.n_layers, _dt(cfg)
    hq = cfg.n_heads_padded * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head
    shapes = {"ln_attn": ((L, d), dt), "ln_mlp": ((L, d), dt), "wq": ((L, d, hq), dt),
              "wk": ((L, d, hkv), dt), "wv": ((L, d, hkv), dt), "wo": ((L, hq, d), dt)}
    if cfg.is_moe:
        shapes.update(moe_layer_shapes(cfg))
    else:
        shapes.update({"w_gate": ((L, d, cfg.d_ff), dt), "w_up": ((L, d, cfg.d_ff), dt),
                       "w_down": ((L, cfg.d_ff, d), dt)})
    return shapes


class LMParams(nn.Module):
    """``repro``'s param dict as module attributes: ``embed``, ``ln_f``,
    ``layers.<name>`` (stacked over L) and ``lm_head`` (None when tied)."""

    def __init__(self, embed, ln_f, layers: dict, lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.ln_f = nn.Parameter(ln_f)
        self.layers = nn.ParameterDict({k: nn.Parameter(w) for k, w in layers.items()})
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: LMConfig, generator=None, device="cuda") -> LMParams:
    """Random weights of ``cfg``'s shapes and dtypes: ``repro``'s scales, drawn
    from ``generator`` (default: seed 0 on ``device``) layer by layer."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    dt = _dt(cfg)
    d, L = cfg.d_model, cfg.n_layers
    hq = cfg.n_heads_padded * cfg.d_head
    hkv = cfg.n_kv_heads * cfg.d_head

    def draw(d_in, d_out, scale=None):
        return dense_init(gen, d_in, d_out, scale, device=gen.device).to(dev, dt)

    def stacked(d_in, d_out):
        w = torch.empty((L, d_in, d_out), dtype=dt, device=dev)
        for i in range(L):
            w[i] = draw(d_in, d_out)
        return w

    layers = {"ln_attn": torch.ones((L, d), dtype=dt, device=dev),
              "ln_mlp": torch.ones((L, d), dtype=dt, device=dev),
              "wq": stacked(d, hq), "wk": stacked(d, hkv), "wv": stacked(d, hkv),
              "wo": stacked(hq, d)}
    if cfg.is_moe:
        layers.update(init_moe_layer(cfg, gen, dev))
    else:
        layers.update({"w_gate": stacked(d, cfg.d_ff), "w_up": stacked(d, cfg.d_ff),
                       "w_down": stacked(cfg.d_ff, d)})
    embed = draw(cfg.vocab_size, d, scale=1.0)
    head = None if cfg.tie_embeddings else draw(d, cfg.vocab_size)
    return LMParams(embed, torch.ones((d,), dtype=dt, device=dev), layers, head)


def param_specs(cfg: LMConfig, fsdp_axis: str = "data", tp_axis: str = "model"):
    """``repro``'s spec tree matching ``init_params``: (L, d_in, d_out)
    weights ``P(None, fsdp, tp)``, the out-projections ``P(None, tp,
    fsdp)``, the vocab-sharded embedding, the MoE layer's specs.
    ``fsdp_axis=None`` gives TP-only sharding (serving)."""
    w2 = P(None, fsdp_axis, tp_axis)
    layer = {"ln_attn": P(None, None), "ln_mlp": P(None, None), "wq": w2, "wk": w2, "wv": w2,
             "wo": P(None, tp_axis, fsdp_axis)}
    if cfg.is_moe:
        layer.update(moe_layer_specs(cfg, fsdp_axis, tp_axis))
    else:
        layer.update({"w_gate": w2, "w_up": w2, "w_down": P(None, tp_axis, fsdp_axis)})
    specs = {"embed": P(tp_axis, fsdp_axis), "ln_f": P(None), "layers": layer}
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(fsdp_axis, tp_axis)
    return specs


def kv_cache_specs(seq_axes=("model",), batch_axes=("data",)):
    """The KV cache sharded along the sequence over ``seq_axes`` and along the
    batch over the DP axes (batch-1 cells pass ``batch_axes=()`` and widen
    ``seq_axes`` to ("data", "model"))."""
    ba = tuple(batch_axes) or None
    kv = P(None, ba, tuple(seq_axes), None, None)
    return {"k": kv, "v": kv, "length": P(ba)}


def _wo_masked(wo, cfg: LMConfig):
    """o-proj with hard-zeroed rows for padded heads: the padded model is
    exactly the unpadded one."""
    if cfg.n_heads_padded == cfg.n_heads:
        return wo
    mask = torch.arange(cfg.n_heads_padded, device=wo.device) < cfg.n_heads
    mask = torch.repeat_interleave(mask, cfg.d_head).to(wo.dtype)
    return wo * mask[:, None]


def layer_locality(cfg: LMConfig) -> torch.Tensor:
    """(L,) bool: True = sliding-window (local) layer (gemma3's 5:1 pattern)."""
    n_local, n_global = cfg.local_global
    period = max(n_local + n_global, 1)
    return (torch.arange(cfg.n_layers) % period) < n_local


def _replicated(w):
    """A dense weight under a mesh: replicated, used on this rank's batch
    block, so its gradient sums over the data axes."""
    return pvary(w, batch_axes()) if current_mesh() is not None else w


def _layer_views(params: LMParams, cfg: LMConfig):
    """Per layer: a dict of its weights (views), and its window (0 = none).
    The MoE weights enter the expert-parallel region as they are."""
    moe = moe_layer_shapes(cfg) if cfg.is_moe else {}
    per_name = {k: torch.unbind(w if k in moe else _replicated(w), 0)
                for k, w in params.layers.items()}
    windows = [cfg.sliding_window if loc else 0 for loc in layer_locality(cfg).tolist()]
    return [({k: w[i] for k, w in per_name.items()}, windows[i])
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------


def _attention_block(x, lp, cfg: LMConfig, positions, window: int, *, block_q, block_kv):
    """The residual stream after attention, and this layer's k and v."""
    B, T, _ = x.shape
    h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
    q = (h @ lp["wq"]).reshape(B, T, cfg.n_heads_padded, cfg.d_head)
    k = (h @ lp["wk"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    v = (h @ lp["wv"]).reshape(B, T, cfg.n_kv_heads, cfg.d_head)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = blockwise_attention(q, k, v, window=window, block_q=block_q,
                              block_kv=block_kv)
    return x + out.reshape(B, T, -1) @ _wo_masked(lp["wo"], cfg), k, v


def _ffn_block(x, lp, cfg: LMConfig):
    """The residual stream after the FFN, and its aux (an f32 0-d tensor, 0
    for the dense MLP)."""
    h = rms_norm(x, lp["ln_mlp"], cfg.norm_eps)
    if cfg.is_moe:
        out, aux = moe_ffn(h, lp, cfg)
    else:
        out = swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _layer(x, lp, cfg, positions, window, block_q, block_kv):
    x, _, _ = _attention_block(x, lp, cfg, positions, window, block_q=block_q,
                               block_kv=block_kv)
    return _ffn_block(x, lp, cfg)


def _embed(params: LMParams, tokens, cfg: LMConfig):
    tokens = tokens.long()
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    return _replicated(params.embed)[tokens].to(_dt(cfg)), positions


def forward_hidden(params: LMParams, tokens, cfg: LMConfig, *, block_q: int = 512,
                   block_kv: int = 512):
    """tokens (B, T) -> final-norm hidden states (B, T, d), and the MoE aux
    summed over the layers (0 for a dense model).  ``cfg.remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``)."""
    x, positions = _embed(params, tokens, cfg)
    auxes = []
    for lp, window in _layer_views(params, cfg):
        fn = functools.partial(_layer, lp=lp, cfg=cfg, positions=positions, window=window,
                               block_q=block_q, block_kv=block_kv)
        x, aux = checkpoint(fn, x, use_reentrant=False) if cfg.remat else fn(x)
        auxes.append(aux)
    return rms_norm(x, _replicated(params.ln_f), cfg.norm_eps), torch.stack(auxes).sum()


def lm_head(params: LMParams, cfg: LMConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def forward(params: LMParams, tokens, cfg: LMConfig, *, block_q: int = 512,
            block_kv: int = 512):
    """tokens (B, T) -> logits (B, T, V) in the param dtype, and aux."""
    x, aux = forward_hidden(params, tokens, cfg, block_q=block_q, block_kv=block_kv)
    return x @ _replicated(lm_head(params, cfg)), aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda"):
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = _dt(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


@torch.no_grad()
def prefill(params: LMParams, tokens, cfg: LMConfig, *, max_len: int | None = None,
            block_q: int = 512, block_kv: int = 512):
    """Forward over the prompt, materialising the KV cache.

    Returns (last-position logits (B, V), cache); the cache's sequence axis
    is padded to ``max_len`` (decode continues into the padding).
    """
    B, T = tokens.shape
    x, positions = _embed(params, tokens, cfg)
    cache = init_kv_cache(cfg, B, max_len or T, device=x.device)
    for i, (lp, window) in enumerate(_layer_views(params, cfg)):
        x, k, v = _attention_block(x, lp, cfg, positions, window, block_q=block_q,
                                   block_kv=block_kv)
        x, _ = _ffn_block(x, lp, cfg)
        cache["k"][i, :, :T] = k
        cache["v"][i, :, :T] = v
    cache["length"].fill_(T)
    x = rms_norm(x[:, -1], params.ln_f, cfg.norm_eps)
    return x @ lm_head(params, cfg), cache


@torch.no_grad()
def decode_step(params: LMParams, cache, tokens, cfg: LMConfig, *, mesh=None,
                seq_axes=("model",), dp=None):
    """One decode step: tokens (B,) -> logits (B, V), and the cache with the
    new token's k and v written in place at ``length`` and ``length`` + 1.

    With ``mesh``, attention runs sequence-parallel over ``seq_axes``
    (``_sp_decode_attention``): ``cache`` is this rank's block
    (``kv_cache_specs(seq_axes, dp)``) and ``tokens`` its batch block over
    ``dp`` (None: the data axes not in ``seq_axes``; () for a batch
    replicated on every rank); the logits are the block's, replicated over
    ``seq_axes``."""
    if mesh is not None:
        seq_axes = tuple(seq_axes)
        if dp is None:
            dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names and a not in seq_axes)
        if set(dp) & set(seq_axes) or not set(dp) | set(seq_axes) <= set(mesh.axis_names):
            raise ValueError(f"batch axes {dp} and sequence axes {seq_axes} must be disjoint "
                             f"axes of the mesh {mesh.axis_names}")
    tokens = tokens.long()
    B = tokens.shape[0]
    x = params.embed[tokens].to(_dt(cfg))[:, None, :]  # (B, 1, d)
    length = cache["length"]
    positions = length[:, None].long()
    for i, (lp, window) in enumerate(_layer_views(params, cfg)):
        h = rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q = (h @ lp["wq"]).reshape(B, 1, cfg.n_heads_padded, cfg.d_head)
        k_new = (h @ lp["wk"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
        v_new = (h @ lp["wv"]).reshape(B, 1, cfg.n_kv_heads, cfg.d_head)
        q = apply_rope(q, positions, cfg.rope_theta)[:, 0]  # (B, Hq, dh)
        k_new = apply_rope(k_new, positions, cfg.rope_theta)
        if mesh is not None:
            out = _sp_decode_attention(q, cache["k"][i], cache["v"][i], length, k_new, v_new,
                                       window, mesh, seq_axes)
        else:
            kc, vc = _append_kv(cache["k"][i], cache["v"][i], k_new, v_new, length)
            o, m, l = decode_attention_local(q, kc, vc, length + 1, window=window)
            out = lse_combine([(o, m, l)])
        x = x + out.to(x.dtype).reshape(B, 1, -1) @ _wo_masked(lp["wo"], cfg)
        x, _ = _ffn_block(x, lp, cfg)
    cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return (x @ lm_head(params, cfg))[:, 0], cache


def _append_kv(k_cache, v_cache, k_new, v_new, length):
    """Write the new token's kv at ``length`` (per batch row), in place."""
    b_idx = torch.arange(k_new.shape[0], device=k_cache.device)
    pos = length.long()
    k_cache[b_idx, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[b_idx, pos] = v_new[:, 0].to(v_cache.dtype)
    return k_cache, v_cache


def _sp_decode_attention(q, k_cache, v_cache, length, k_new, v_new, window: int, mesh,
                         seq_axes=("model",)):
    """Sequence-parallel flash-decoding in the local view: ``k_cache`` and
    ``v_cache`` (B, S_local, Hkv, dh) are this rank's block over
    ``seq_axes`` (the block index row-major over them).  The new token's k
    and v are written in place only by the rank whose block holds position
    ``length``; the window masks by ABSOLUTE position (the block's offset),
    so a local layer stays exact across blocks; the combine is the exact
    log-sum-exp: a ``pmax`` of m, then ``psum``s of the shifted numerator
    and denominator.  -> (B, Hq, dh) float32, replicated over ``seq_axes``."""
    S_local = k_cache.shape[1]
    offset = mesh.index(seq_axes) * S_local
    in_shard = ((length >= offset) & (length < offset + S_local))[:, None, None]
    pos = (length - offset).clamp(0, S_local - 1).long()
    b_idx = torch.arange(q.shape[0], device=q.device)
    k_cache[b_idx, pos] = torch.where(in_shard, k_new[:, 0].to(k_cache.dtype), k_cache[b_idx, pos])
    v_cache[b_idx, pos] = torch.where(in_shard, v_new[:, 0].to(v_cache.dtype), v_cache[b_idx, pos])
    o, m, l = decode_attention_local(q, k_cache, v_cache, length + 1, window=window,
                                     pos_offset=offset)
    m_g = pmax(m, seq_axes, mesh)
    num = psum(o * torch.exp(m - m_g)[..., None], seq_axes, mesh)
    den = psum(l * torch.exp(m - m_g), seq_axes, mesh)
    return num / torch.clamp(den[..., None], min=1e-30)
