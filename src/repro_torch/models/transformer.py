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
block over the data axes, the MoE FFN runs expert-parallel, and
``decode_step(mesh=)`` attends sequence-parallel over its block of the
cache (``kv_cache_specs``) with an exact log-sum-exp combine.  The dense
weights are either replicated (each one's gradient summed over the data
axes by ``pvary``) or, when the parameters carry ``specs`` (``shard_params``,
``param_specs``' FSDP x TP layout, the layout a dry run reckons with),
this rank's blocks:

  - each layer's weight blocks are all-gathered over their data (FSDP) axes
    just before use (``fsdp_gather``; the backward reduce-scatters the
    gradient), inside the layer's checkpoint, so a gathered layer lives
    only while it runs;
  - ``wq`` and the MLP's ``w_gate``/``w_up`` are column-parallel over the TP
    axis ("model"): this rank's heads and d_ff block; ``wo`` and ``w_down``
    row-parallel, followed by a ``psum`` over it;
  - a rank's query heads need whole KV heads, and q head h uses kv head
    h % Hkv: ``wk``/``wv`` are gathered over "model" too and the rank takes
    the columns of its heads' kv heads (one kv head per q head), unless its
    own block is exactly those (no full LM has it: 8 kv heads on 16 ranks);
  - ``embed`` is a vocab-sharded lookup (a masked take and a ``psum``), the
    head (the tied ``embed`` or ``lm_head``) is vocab-sharded: ``forward``
    and ``prefill`` all-gather the logits over "model", ``lm_loss`` feeds
    its block to ``sharded_xent``;
  - ``prefill`` returns this rank's block of the cache, sequence over
    "model" (``kv_cache_specs``): all kv heads at its block of positions,
    from the whole ``wk``/``wv``;
  - ``decode_step`` all-gathers the step's q, k and v over "model", attends
    sequence-parallel, then takes its heads for the row-parallel ``wo``.
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
from repro_torch.sharding.api import (P, _axes, all_gather, batch_axes, current_mesh, flatten,
                                      fsdp_gather, pmax, psum, pvary, shard, use_mesh)


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
    ``layers.<name>`` (stacked over L) and ``lm_head`` (None when tied).

    ``specs``: None for whole (replicated) tensors, else the flat
    {parameter name: ``P``} layout of this rank's blocks (``param_specs``)."""

    def __init__(self, embed, ln_f, layers: dict, lm_head=None, specs=None):
        super().__init__()
        self.embed = nn.Parameter(embed)
        self.ln_f = nn.Parameter(ln_f)
        self.layers = nn.ParameterDict({k: nn.Parameter(w) for k, w in layers.items()})
        self.lm_head = None if lm_head is None else nn.Parameter(lm_head)
        self.specs = None if specs is None else flatten(specs)


def param_shapes(cfg: LMConfig) -> dict:
    """{parameter name: (global shape, dtype)}, ``LMParams``' names."""
    dt, d = _dt(cfg), cfg.d_model
    out = {"embed": ((cfg.vocab_size, d), dt), "ln_f": ((d,), dt)}
    out.update({f"layers.{k}": v for k, v in layer_shapes(cfg).items()})
    if not cfg.tie_embeddings:
        out["lm_head"] = ((d, cfg.vocab_size), dt)
    return out


def shard_params(params: LMParams, specs, mesh) -> LMParams:
    """This rank's blocks of the whole ``params`` under ``specs``
    (``param_specs``' tree), carrying the specs: the FSDP x TP layout."""
    flat = flatten(specs)
    with torch.no_grad():
        blocks = {k: shard(p.detach(), flat[k], mesh) for k, p in params.named_parameters()}
    layers = {k.removeprefix("layers."): w for k, w in blocks.items() if k.startswith("layers.")}
    return LMParams(blocks["embed"], blocks["ln_f"], layers, blocks.get("lm_head"), specs=flat)


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


def _wo_masked(wo, cfg: LMConfig, head0: int = 0):
    """o-proj with hard-zeroed rows for padded heads: the padded model is
    exactly the unpadded one.  ``wo``'s rows are the heads from ``head0`` on
    (a TP rank's block)."""
    if cfg.n_heads_padded == cfg.n_heads:
        return wo
    heads = torch.arange(head0, head0 + wo.shape[0] // cfg.d_head, device=wo.device)
    mask = torch.repeat_interleave(heads < cfg.n_heads, cfg.d_head).to(wo.dtype)
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


class _Sharded:
    """FSDP x TP of the dense layers in the local view: the mesh, the
    parameters' flat specs, the TP axes (those of ``wq``'s columns), this
    rank's TP index and query heads, and the kv head of each of them."""

    def __init__(self, params: LMParams, cfg: LMConfig, mesh):
        if mesh is None:
            raise ValueError("parameters laid out by specs run only under a mesh "
                             "(use_mesh, or decode_step(mesh=))")
        self.mesh, self.specs = mesh, params.specs
        self.tp = _axes(self.specs["layers.wq"][2])
        self.n_tp = mesh.size_of(self.tp)
        self.r = mesh.index(self.tp) if self.tp else 0
        hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads
        if hq % self.n_tp or cfg.vocab_size % self.n_tp:
            raise ValueError(f"{hq} heads and a vocab of {cfg.vocab_size} must split over "
                             f"{self.n_tp} TP ranks")
        self.hq = hq // self.n_tp
        self.head0 = self.r * self.hq
        self.kv = [(self.head0 + i) % hkv for i in range(self.hq)]
        own = (list(range(self.r * hkv // self.n_tp, (self.r + 1) * hkv // self.n_tp))
               if hkv % self.n_tp == 0 else None)
        self.own_kv = own == self.kv  # the kv block is exactly the heads' kv heads
        if cfg.is_moe and ("model" not in mesh.axis_names
                           or cfg.moe.n_experts % mesh.shape["model"]):
            raise ValueError("an MoE model's blocks run expert-parallel: the mesh needs a "
                             "\"model\" axis that divides the experts")

    def w(self, name: str, w):
        """A weight (one layer's slice of a stacked one) whole over its FSDP axes."""
        spec = self.specs[name]
        spec = P(*spec[1:]) if name.startswith("layers.") else spec
        return fsdp_gather(w, spec, self.tp, self.mesh)

    def tp_in(self, x):
        """``x``, replicated over TP, entering this rank's column block."""
        return pvary(x, self.tp, self.mesh)

    def tp_sum(self, x):
        return psum(x, self.tp, self.mesh)

    def tp_whole(self, x, varying: bool = True):
        """``x`` all-gathered over TP along its last dim (its column blocks)."""
        return all_gather(x, self.tp, x.ndim - 1, tiled=True, varying=varying, mesh=self.mesh)

    def kv_columns(self, w_whole, cfg: LMConfig):
        """The columns of each of this rank's query heads' kv head, (d, hq dh)."""
        d = w_whole.shape[0]
        idx = torch.tensor(self.kv, device=w_whole.device)
        return w_whole.reshape(d, cfg.n_kv_heads, cfg.d_head)[:, idx].reshape(d, -1)


def _layer_views(params: LMParams, cfg: LMConfig):
    """Per layer: a dict of its weights (views), and its window (0 = none).
    The MoE weights enter the expert-parallel region as they are; so do the
    blocks of parameters laid out by specs (each layer gathers its own)."""
    moe = moe_layer_shapes(cfg) if cfg.is_moe else {}
    keep = params.specs is not None
    per_name = {k: torch.unbind(w if k in moe or keep else _replicated(w), 0)
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


def _layer(x, lp, cfg, positions, window, block_q, block_kv, sh=None):
    if sh is not None:
        x, _ = _sharded_attention(x, lp, cfg, sh, positions, window, block_q=block_q,
                                  block_kv=block_kv)
        return _sharded_ffn(x, lp, cfg, sh)
    x, _, _ = _attention_block(x, lp, cfg, positions, window, block_q=block_q,
                               block_kv=block_kv)
    return _ffn_block(x, lp, cfg)


def _sharded_attention(x, lp, cfg: LMConfig, sh: _Sharded, positions, window: int, *,
                       block_q: int, block_kv: int, cache_at=None):
    """The residual stream after attention with this rank's heads (FSDP x TP,
    module docstring).  ``cache_at`` = (lo, hi): also this rank's block of
    the cache, every kv head at positions lo..hi (prefill), else None."""
    B, T, _ = x.shape
    dh = cfg.d_head
    h = rms_norm(x, sh.w("layers.ln_attn", lp["ln_attn"]), cfg.norm_eps)
    ht = sh.tp_in(h)
    q = (ht @ sh.w("layers.wq", lp["wq"])).reshape(B, T, sh.hq, dh)
    wk, wv = sh.w("layers.wk", lp["wk"]), sh.w("layers.wv", lp["wv"])
    if cache_at is not None or not sh.own_kv:
        wk, wv = sh.tp_whole(wk), sh.tp_whole(wv)
        wk_h, wv_h = sh.kv_columns(wk, cfg), sh.kv_columns(wv, cfg)
    else:
        wk_h, wv_h = wk, wv
    k = apply_rope((ht @ wk_h).reshape(B, T, sh.hq, dh), positions, cfg.rope_theta)
    v = (ht @ wv_h).reshape(B, T, sh.hq, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    out = blockwise_attention(q, k, v, window=window, block_q=block_q, block_kv=block_kv)
    wo = _wo_masked(sh.w("layers.wo", lp["wo"]), cfg, sh.head0)
    x = x + sh.tp_sum(out.reshape(B, T, -1) @ wo)
    if cache_at is None:
        return x, None
    lo, hi = cache_at
    hb = h[:, lo:hi]
    kb = apply_rope((hb @ wk).reshape(B, hi - lo, cfg.n_kv_heads, dh), positions[:, lo:hi],
                    cfg.rope_theta)
    return x, (kb, (hb @ wv).reshape(B, hi - lo, cfg.n_kv_heads, dh))


def _sharded_ffn(x, lp, cfg: LMConfig, sh: _Sharded):
    """The residual stream after the FFN: the SwiGLU MLP over this rank's
    d_ff block and a ``psum``, or the expert-parallel MoE region on the MoE
    blocks (its shared experts FSDP x TP there too)."""
    h = rms_norm(x, sh.w("layers.ln_mlp", lp["ln_mlp"]), cfg.norm_eps)
    if cfg.is_moe:
        with use_mesh(sh.mesh):
            out, aux = moe_ffn(h, {k: lp[k] for k in moe_layer_shapes(cfg)}, cfg)
        return x + out, aux
    ht = sh.tp_in(h)
    out = swiglu(ht, sh.w("layers.w_gate", lp["w_gate"]), sh.w("layers.w_up", lp["w_up"]),
                 sh.w("layers.w_down", lp["w_down"]))
    return x + sh.tp_sum(out), torch.zeros((), dtype=torch.float32, device=x.device)


def _embed(params: LMParams, tokens, cfg: LMConfig, sh=None):
    tokens = tokens.long()
    B, T = tokens.shape
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    if sh is None:
        return _replicated(params.embed)[tokens].to(_dt(cfg)), positions
    # vocab-sharded: this rank's rows of the gathered table, a psum over TP
    emb = sh.w("embed", params.embed)
    rel = tokens - sh.r * emb.shape[0]
    inside = (rel >= 0) & (rel < emb.shape[0])
    x = emb[rel.clamp(0, emb.shape[0] - 1)] * inside[..., None].to(emb.dtype)
    return sh.tp_sum(x).to(_dt(cfg)), positions


def _sharding(params: LMParams, cfg: LMConfig, mesh=None):
    """The ``_Sharded`` view of ``params`` on ``mesh`` (default: the current
    one), or None for whole parameters."""
    if params.specs is None:
        return None
    return _Sharded(params, cfg, mesh if mesh is not None else current_mesh())


def forward_hidden(params: LMParams, tokens, cfg: LMConfig, *, block_q: int = 512,
                   block_kv: int = 512):
    """tokens (B, T) -> final-norm hidden states (B, T, d), and the MoE aux
    summed over the layers (0 for a dense model).  ``cfg.remat`` recomputes
    each layer in the backward (``torch.utils.checkpoint``); with FSDP x TP
    parameters that recompute gathers the layer's weights again."""
    sh = _sharding(params, cfg)
    x, positions = _embed(params, tokens, cfg, sh)
    auxes = []
    for lp, window in _layer_views(params, cfg):
        fn = functools.partial(_layer, lp=lp, cfg=cfg, positions=positions, window=window,
                               block_q=block_q, block_kv=block_kv, sh=sh)
        x, aux = checkpoint(fn, x, use_reentrant=False) if cfg.remat else fn(x)
        auxes.append(aux)
    ln_f = _replicated(params.ln_f) if sh is None else sh.w("ln_f", params.ln_f)
    return rms_norm(x, ln_f, cfg.norm_eps), torch.stack(auxes).sum()


def lm_head(params: LMParams, cfg: LMConfig):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def sharded_head(params: LMParams, cfg: LMConfig, mesh=None):
    """FSDP x TP parameters: this rank's vocab block of the head, (d, V / tp),
    gathered over its FSDP axes (the tied ``embed``'s rows transposed)."""
    sh = _sharding(params, cfg, mesh)
    if cfg.tie_embeddings:
        return sh.w("embed", params.embed).T
    return sh.w("lm_head", params.lm_head)


def forward(params: LMParams, tokens, cfg: LMConfig, *, block_q: int = 512,
            block_kv: int = 512):
    """tokens (B, T) -> logits (B, T, V) in the param dtype, and aux.  With
    FSDP x TP parameters: this rank's batch block, every vocab column."""
    x, aux = forward_hidden(params, tokens, cfg, block_q=block_q, block_kv=block_kv)
    sh = _sharding(params, cfg)
    if sh is None:
        return x @ _replicated(lm_head(params, cfg)), aux
    return sh.tp_whole(sh.tp_in(x) @ sharded_head(params, cfg), varying=False), aux


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, device="cuda", dtype=None):
    """Zeroed k and v (n_layers, batch, max_len, n_kv_heads, d_head) in
    ``dtype`` (default the config's) and (batch,) int32 lengths."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    dt = dtype or _dt(cfg)
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
    if params.specs is not None:
        return _sharded_prefill(params, tokens, cfg, max_len, block_q, block_kv)
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


def _sharded_prefill(params: LMParams, tokens, cfg: LMConfig, max_len, block_q, block_kv):
    """``prefill`` with FSDP x TP parameters under the current mesh: the
    rank's batch block's last-position logits (every vocab column) and its
    block of the cache, ``kv_cache_specs(("model",), data axes)``: the
    sequence split over the TP axes."""
    sh = _sharding(params, cfg)
    B, T = tokens.shape
    x, positions = _embed(params, tokens, cfg, sh)
    S = max_len or T
    if S % sh.n_tp:
        raise ValueError(f"a cache of {S} positions does not split over {sh.n_tp} ranks")
    S_loc = S // sh.n_tp
    lo, hi = sh.r * S_loc, min(T, (sh.r + 1) * S_loc)
    cache = init_kv_cache(cfg, B, S_loc, device=x.device)
    for i, (lp, window) in enumerate(_layer_views(params, cfg)):
        x, (kb, vb) = _sharded_attention(x, lp, cfg, sh, positions, window, block_q=block_q,
                                         block_kv=block_kv, cache_at=(lo, max(lo, hi)))
        x, _ = _sharded_ffn(x, lp, cfg, sh)
        cache["k"][i, :, :kb.shape[1]] = kb
        cache["v"][i, :, :vb.shape[1]] = vb
    cache["length"].fill_(T)
    x = rms_norm(x[:, -1], sh.w("ln_f", params.ln_f), cfg.norm_eps)
    return sh.tp_whole(x @ sharded_head(params, cfg), varying=False), cache


def _sharded_decode(params: LMParams, cache, tokens, cfg: LMConfig, mesh, seq_axes):
    """``decode_step(mesh=)`` with FSDP x TP parameters (module docstring)."""
    sh = _sharding(params, cfg, mesh)
    B, dh = tokens.shape[0], cfg.d_head
    x, _ = _embed(params, tokens[:, None], cfg, sh)  # (B, 1, d)
    length = cache["length"]
    positions = length[:, None].long()
    hq, hkv = cfg.n_heads_padded, cfg.n_kv_heads
    for i, (lp, window) in enumerate(_layer_views(params, cfg)):
        h = rms_norm(x, sh.w("layers.ln_attn", lp["ln_attn"]), cfg.norm_eps)
        q, k_new, v_new = (sh.tp_whole(h @ sh.w(f"layers.{n}", lp[n]), varying=False)
                           for n in ("wq", "wk", "wv"))
        q = apply_rope(q.reshape(B, 1, hq, dh), positions, cfg.rope_theta)[:, 0]
        k_new = apply_rope(k_new.reshape(B, 1, hkv, dh), positions, cfg.rope_theta)
        out = _sp_decode_attention(q, cache["k"][i], cache["v"][i], length, k_new,
                                   v_new.reshape(B, 1, hkv, dh), window, mesh, seq_axes)
        mine = out[:, sh.head0:sh.head0 + sh.hq].to(x.dtype).reshape(B, 1, -1)
        wo = _wo_masked(sh.w("layers.wo", lp["wo"]), cfg, sh.head0)
        x = x + sh.tp_sum(mine @ wo)
        x, _ = _sharded_ffn(x, lp, cfg, sh)
    cache = {"k": cache["k"], "v": cache["v"], "length": length + 1}
    x = rms_norm(x, sh.w("ln_f", params.ln_f), cfg.norm_eps)
    return sh.tp_whole(x @ sharded_head(params, cfg, mesh), varying=False)[:, 0], cache


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
    ``seq_axes``.  FSDP x TP parameters need ``mesh``."""
    if mesh is not None:
        seq_axes = tuple(seq_axes)
        if dp is None:
            dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names and a not in seq_axes)
        if set(dp) & set(seq_axes) or not set(dp) | set(seq_axes) <= set(mesh.axis_names):
            raise ValueError(f"batch axes {dp} and sequence axes {seq_axes} must be disjoint "
                             f"axes of the mesh {mesh.axis_names}")
    if params.specs is not None:
        if mesh is None:
            raise ValueError("FSDP x TP parameters decode only with mesh=")
        return _sharded_decode(params, cache, tokens.long(), cfg, mesh, seq_axes)
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
