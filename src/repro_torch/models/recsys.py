"""Recsys ranking/retrieval models (PyTorch port of ``repro.models.recsys``):
AutoInt, DIN, two-tower, DCN-v2.

All four share the concatenated embedding table (``models/embedding.py``);
they differ in the feature-interaction op:

  AutoInt  : multi-head self-attention over field embeddings [1810.11921]
  DIN      : target-attention over user behaviour history    [1706.06978]
  two-tower: MLP towers + dot, in-batch sampled softmax      [RecSys'19]
  DCN-v2   : x_{l+1} = x0 * (x_l W + b) + x_l cross layers   [2008.13535]

The two-tower serving shape (one query against many candidates) is the
paper's own problem: the item-tower embeddings are indexed by
``repro_torch.core`` under the negdot distance.  The ranking models are
served by ``forward``, trained on ``bce_loss``.

The parameters mirror ``repro``'s param dict as module attributes:
``table``; ``user_tower.{w,b}.<i>`` and ``item_tower.{w,b}.<i>``;
``attn.<i>.{wq,wk,wv,wres}``; ``att_mlp.{w,b}.<i>``; ``cross.<i>.{w,b}``;
``head.{w,b}.<i>`` (``convert.recsys_params_from_jax`` carries them
across).  They are drawn on the CPU from a ``torch.Generator`` and then
moved, so the card and the CPU start from the same weights.
``param_specs`` is ``repro``'s spec tree: the table row-sharded
(``embedding.table_spec``), every dense layer replicated.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.core.distances import neg_inner_product
from repro_torch.kernels.ops import query_distance_matrix
from repro_torch.models.embedding import embedding_lookup, field_offsets, init_table, table_spec
from repro_torch.models.layers import NEG_INF, dense_init
from repro_torch.sharding.api import P


class MLP(nn.Module):
    """Dense layers ``x @ w + b``, ReLU between them (``_mlp_apply``)."""

    def __init__(self, weights, device):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w.to(device)) for w in weights])
        self.b = nn.ParameterList([nn.Parameter(torch.zeros(w.shape[1], device=device))
                                   for w in weights])


def _mlp_init(generator, dims, device) -> MLP:
    return MLP([dense_init(generator, dims[i], dims[i + 1]) for i in range(len(dims) - 1)],
               device)


def _mlp_apply(p: MLP, x, act=torch.relu, final_act: bool = False):
    n = len(p.w)
    for i, (w, b) in enumerate(zip(p.w, p.b)):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x


def _mlp_specs(dims):
    return {"w": [P(None, None) for _ in range(len(dims) - 1)],
            "b": [P(None) for _ in range(len(dims) - 1)]}


def _pad_vocab(cfg: RecsysConfig, mult: int = 512) -> int:
    return -(-cfg.table_rows() // mult) * mult


class _Recsys(nn.Module):
    """The padded table and its field offsets, shared by every model."""

    def __init__(self, cfg: RecsysConfig, gen, dev):
        super().__init__()
        self.table = nn.Parameter(init_table(gen, (_pad_vocab(cfg),), cfg.embed_dim).to(dev))
        self.register_buffer("offsets", field_offsets(cfg.vocab_sizes, dev), persistent=False)


class TwoTower(_Recsys):
    """The two-tower model: the first ``n_sparse // 2`` fields feed the user
    tower, the rest the item tower."""

    def __init__(self, cfg: RecsysConfig, gen, dev):
        super().__init__(cfg, gen, dev)
        d, fu = cfg.embed_dim, cfg.n_sparse // 2
        self.user_tower = _mlp_init(gen, (fu * d,) + tuple(cfg.tower_mlp_dims), dev)
        self.item_tower = _mlp_init(gen, ((cfg.n_sparse - fu) * d,) + tuple(cfg.tower_mlp_dims),
                                    dev)


class _AttnLayer(nn.Module):
    def __init__(self, gen, d_in: int, d_attn: int, dev):
        super().__init__()
        for name in ("wq", "wk", "wv", "wres"):
            setattr(self, name, nn.Parameter(dense_init(gen, d_in, d_attn).to(dev)))


class AutoInt(_Recsys):
    """Self-attention layers over the field embeddings (the first from
    ``embed_dim``, the rest from ``d_attn``), then one linear head over the
    flattened fields and the dense features."""

    def __init__(self, cfg: RecsysConfig, gen, dev):
        super().__init__(cfg, gen, dev)
        d, da = cfg.embed_dim, cfg.d_attn
        self.attn = nn.ModuleList([_AttnLayer(gen, d if i == 0 else da, da, dev)
                                   for i in range(cfg.n_attn_layers)])
        self.head = _mlp_init(gen, (cfg.n_sparse * da + cfg.n_dense, 1), dev)


class DIN(_Recsys):
    """The attention MLP over ``[h, t, h - t, h * t]`` and the head over
    ``[user, target, rest, dense]``."""

    def __init__(self, cfg: RecsysConfig, gen, dev):
        super().__init__(cfg, gen, dev)
        d = cfg.embed_dim
        self.att_mlp = _mlp_init(gen, (4 * d,) + tuple(cfg.attn_mlp_dims) + (1,), dev)
        in_dim = 2 * d + (cfg.n_sparse - 1) * d + cfg.n_dense
        self.head = _mlp_init(gen, (in_dim,) + tuple(cfg.mlp_dims) + (1,), dev)


class _CrossLayer(nn.Module):
    def __init__(self, gen, x0: int, dev):
        super().__init__()
        self.w = nn.Parameter(dense_init(gen, x0, x0).to(dev))
        self.b = nn.Parameter(torch.zeros(x0, device=dev))


class DCNv2(_Recsys):
    """Cross layers over ``x0 = [dense, embeddings]``, then the MLP head."""

    def __init__(self, cfg: RecsysConfig, gen, dev):
        super().__init__(cfg, gen, dev)
        x0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
        self.cross = nn.ModuleList([_CrossLayer(gen, x0, dev)
                                    for _ in range(cfg.n_cross_layers)])
        self.head = _mlp_init(gen, (x0,) + tuple(cfg.mlp_dims) + (1,), dev)


_MODELS = {"dot": TwoTower, "self-attn": AutoInt, "target-attn": DIN, "cross": DCNv2}


def init_params(cfg: RecsysConfig, generator=None, device="cuda") -> _Recsys:
    """The model for ``cfg.interaction`` on ``device`` (weights from
    ``generator``, a CPU ``torch.Generator``; seed 0 when omitted): the table
    first, then the layers in ``repro``'s order."""
    if cfg.interaction not in _MODELS:
        raise ValueError(cfg.interaction)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return _MODELS[cfg.interaction](cfg, gen, resolve_device(device))


def param_specs(cfg: RecsysConfig, fsdp_axis="data", tp_axis="model"):
    """``repro``'s spec tree for ``cfg.interaction``'s params."""
    specs = {"table": table_spec(tp_axis, fsdp_axis)}
    d = cfg.embed_dim
    if cfg.interaction == "self-attn":
        specs["attn"] = [{k: P(None, None) for k in ("wq", "wk", "wv", "wres")}
                         for _ in range(cfg.n_attn_layers)]
        specs["head"] = _mlp_specs((cfg.n_sparse * cfg.d_attn + cfg.n_dense, 1))
    elif cfg.interaction == "target-attn":
        specs["att_mlp"] = _mlp_specs((4 * d,) + tuple(cfg.attn_mlp_dims) + (1,))
        in_dim = 2 * d + (cfg.n_sparse - 1) * d + cfg.n_dense
        specs["head"] = _mlp_specs((in_dim,) + tuple(cfg.mlp_dims) + (1,))
    elif cfg.interaction == "cross":
        specs["cross"] = [{"w": P(None, None), "b": P(None)} for _ in range(cfg.n_cross_layers)]
        x0 = cfg.n_dense + cfg.n_sparse * d
        specs["head"] = _mlp_specs((x0,) + tuple(cfg.mlp_dims) + (1,))
    elif cfg.interaction == "dot":
        fu = cfg.n_sparse // 2
        specs["user_tower"] = _mlp_specs((fu * d,) + tuple(cfg.tower_mlp_dims))
        specs["item_tower"] = _mlp_specs(((cfg.n_sparse - fu) * d,) + tuple(cfg.tower_mlp_dims))
    return specs


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------


def forward(model: _Recsys, batch, cfg: RecsysConfig):
    """-> logits (B,) of a ranking model (AutoInt, DIN, DCN-v2)."""
    emb = embedding_lookup(model.table, batch["sparse_ids"], model.offsets)  # (B, F, d)
    B = emb.shape[0]

    if cfg.interaction == "self-attn":
        x = emb
        h = cfg.n_attn_heads
        e = cfg.d_attn // h
        for lp in model.attn:
            q = (x @ lp.wq).reshape(B, -1, h, e)
            k = (x @ lp.wk).reshape(B, -1, h, e)
            v = (x @ lp.wv).reshape(B, -1, h, e)
            s = torch.einsum("bfhe,bghe->bhfg", q, k) / e ** 0.5
            a = torch.softmax(s, dim=-1)
            o = torch.einsum("bhfg,bghe->bfhe", a, v).reshape(B, -1, cfg.d_attn)
            x = torch.relu(o + x @ lp.wres)
        flat = x.reshape(B, -1)
        if cfg.n_dense:
            flat = torch.cat([flat, batch["dense"]], dim=1)
        return _mlp_apply(model.head, flat)[:, 0]

    if cfg.interaction == "target-attn":
        # field 0 = target item; history ids share field 0's rows (offset 0)
        target = emb[:, 0]  # (B, d)
        T = batch["history"].shape[1]
        hist = embedding_lookup(model.table, batch["history"], model.offsets[:1].expand(T))
        t = target[:, None, :].expand(hist.shape)
        att_in = torch.cat([hist, t, hist - t, hist * t], dim=-1)
        w = _mlp_apply(model.att_mlp, att_in)[..., 0]  # (B, T)
        mask = torch.arange(T, device=w.device)[None, :] < batch["hist_len"][:, None]
        w = torch.where(mask, w, NEG_INF)  # -1e30, as repro's
        w = torch.softmax(w, dim=-1)
        user = torch.einsum("bt,btd->bd", w, hist)
        rest = emb[:, 1:].reshape(B, -1)
        feats = [user, target, rest]
        if cfg.n_dense:
            feats.append(batch["dense"])
        return _mlp_apply(model.head, torch.cat(feats, dim=1))[:, 0]

    if cfg.interaction == "cross":
        x0 = torch.cat([batch["dense"], emb.reshape(B, -1)], dim=1)
        x = x0
        for lp in model.cross:
            x = x0 * (x @ lp.w + lp.b) + x
        return _mlp_apply(model.head, x)[:, 0]

    raise ValueError(f"forward() not defined for {cfg.interaction}; use tower fns")


def tower_embeddings(model: TwoTower, batch, cfg: RecsysConfig):
    """-> (user_emb (B, dE), item_emb (B, dE)), each row L2-normalised
    (divided by max(norm, 1e-6))."""
    emb = embedding_lookup(model.table, batch["sparse_ids"], model.offsets)  # (B, F, d)
    B = emb.shape[0]
    fu = cfg.n_sparse // 2
    u = _mlp_apply(model.user_tower, emb[:, :fu].reshape(B, -1))
    it = _mlp_apply(model.item_tower, emb[:, fu:].reshape(B, -1))
    u = u / torch.clamp(torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True)), min=1e-6)
    it = it / torch.clamp(torch.sqrt(torch.sum(it * it, dim=-1, keepdim=True)), min=1e-6)
    return u, it


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def bce_loss(model: _Recsys, batch, cfg: RecsysConfig):
    """Mean binary cross-entropy of ``forward``'s logits against ``label``, in
    the stable form ``max(z, 0) - z y + log1p(exp(-|z|))``."""
    logits = forward(model, batch, cfg)
    y = batch["label"]
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits)) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def inbatch_softmax_loss(model: TwoTower, batch, cfg: RecsysConfig, temperature: float = 0.05):
    """Two-tower sampled softmax with in-batch negatives: row b's positive is
    item b, every other item of the batch a negative."""
    u, it = tower_embeddings(model, batch, cfg)
    logits = (u @ it.T) / temperature  # (B, B)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def retrieval_scores(user_emb, candidate_embs):
    """Serve-path scoring, one query row against every candidate: the paper's
    negdot distance, through ``distance_matrix`` on the card."""
    return query_distance_matrix(neg_inner_product(), user_emb, candidate_embs, mode="left")
