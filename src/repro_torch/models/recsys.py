"""The two-tower retrieval model (PyTorch port of ``repro.models.recsys``, ``dot``).

MLP towers over the concatenated embedding table, L2-normalised outputs,
trained with an in-batch sampled softmax [RecSys'19].  The serving shape
(one query against many candidates) is the paper's own problem: the
item-tower embeddings are indexed by ``repro_torch.core`` under the negdot
distance.  The other interactions (AutoInt's self-attention, DIN's target
attention, DCN-v2's cross layers) wait for ROADMAP M17.

The parameters mirror ``repro``'s param dict as module attributes:
``table``, ``user_tower.w.<i>``, ``user_tower.b.<i>``, ``item_tower.w.<i>``,
``item_tower.b.<i>`` (``convert.recsys_params_from_jax`` carries them
across).  They are drawn on the CPU from a ``torch.Generator`` and then
moved, so the card and the CPU start from the same weights.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import RecsysConfig
from repro_torch.core.distances import neg_inner_product
from repro_torch.kernels.ops import query_distance_matrix
from repro_torch.models.embedding import embedding_lookup, field_offsets, init_table
from repro_torch.models.layers import dense_init


def _check_interaction(cfg: RecsysConfig) -> None:
    if cfg.interaction != "dot":
        raise NotImplementedError(
            f"recsys interaction {cfg.interaction!r} is not ported to repro_torch yet "
            "(ROADMAP M17); only the two-tower 'dot' model is")


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


def _pad_vocab(cfg: RecsysConfig, mult: int = 512) -> int:
    return -(-cfg.table_rows() // mult) * mult


class TwoTower(nn.Module):
    """The two-tower model: the padded table and the user and item towers.

    The first ``n_sparse // 2`` fields feed the user tower, the rest the item
    tower.
    """

    def __init__(self, cfg: RecsysConfig, generator=None, device="cuda"):
        super().__init__()
        _check_interaction(cfg)
        dev = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        d = cfg.embed_dim
        fu = cfg.n_sparse // 2
        self.table = nn.Parameter(init_table(gen, (_pad_vocab(cfg),), d).to(dev))
        self.user_tower = _mlp_init(gen, (fu * d,) + tuple(cfg.tower_mlp_dims), dev)
        self.item_tower = _mlp_init(gen, ((cfg.n_sparse - fu) * d,) + tuple(cfg.tower_mlp_dims),
                                    dev)
        self.register_buffer("offsets", field_offsets(cfg.vocab_sizes, dev), persistent=False)


def init_params(cfg: RecsysConfig, generator=None, device="cuda") -> TwoTower:
    """The model for ``cfg`` on ``device`` (weights from ``generator``, a CPU
    ``torch.Generator``; seed 0 when omitted)."""
    return TwoTower(cfg, generator, device)


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
