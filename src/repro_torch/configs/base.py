"""Config dataclasses (PyTorch port of ``repro.configs.base``: ``MoEConfig``,
``LMConfig``, ``GNNConfig``, ``RecsysConfig``, ``RetrievalConfig``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0  # shared (always-on) experts
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    """Decoder-only transformer LM (dense + MoE).

    GQA grouping convention: q head h attends with kv head ``h % n_kv_heads``.
    ``local_global`` = (n_local, n_global) per pattern period, e.g. gemma3's
    5:1 sliding:full pattern; (0, 1) = all-global (full attention).
    ``pad_heads_to``: extra q heads whose o-proj rows are hard-zeroed (the
    padded model computes exactly the unpadded one).
    """

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    moe: Optional[MoEConfig] = None
    sliding_window: int = 4096
    local_global: Tuple[int, int] = (0, 1)
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: bool = True
    full_attention: bool = True  # True => pure full attention
    pad_heads_to: Optional[int] = None

    @property
    def n_heads_padded(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def n_params(self) -> int:
        """Total parameter count (analytic)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv_heads * self.d_head * 2
        if self.is_moe:
            mlp = 3 * d * self.moe.d_ff_expert * (self.moe.n_experts + self.moe.n_shared)
            mlp += d * self.moe.n_experts  # router
        else:
            mlp = 3 * d * self.d_ff
        norms = 2 * d
        return emb + L * (attn + mlp + norms) + d

    def n_active_params(self) -> int:
        """Active (per-token) parameters - MoE uses top_k + shared experts."""
        if not self.is_moe:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.d_head * 2 + d * self.n_kv_heads * self.d_head * 2
        mlp = 3 * d * self.moe.d_ff_expert * (self.moe.top_k + self.moe.n_shared)
        mlp += d * self.moe.n_experts
        return emb + L * (attn + mlp + 2 * d) + d


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_feat: int
    n_classes: int
    aggregator: str = "mean"  # mean | sum | max
    norm: str = "sym"  # sym (GCN D^-1/2 A D^-1/2) | none


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding CTR/retrieval models.

    ``interaction``: self-attn (AutoInt) | target-attn (DIN) | cross (DCN-v2)
                     | dot (two-tower retrieval)
    ``vocab_sizes``: per-field embedding table rows (criteo-like defaults).
    """

    name: str
    interaction: str
    n_dense: int
    vocab_sizes: Tuple[int, ...]
    embed_dim: int
    mlp_dims: Tuple[int, ...]
    # AutoInt
    n_attn_layers: int = 0
    n_attn_heads: int = 0
    d_attn: int = 0
    # DIN
    seq_len: int = 0
    attn_mlp_dims: Tuple[int, ...] = ()
    # DCN-v2
    n_cross_layers: int = 0
    # two-tower
    tower_mlp_dims: Tuple[int, ...] = ()

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def table_rows(self) -> int:
        return sum(self.vocab_sizes)


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """The paper's own architecture: a non-metric ANN retrieval index."""

    name: str
    distance: str = "kl"
    index_sym: str = "none"
    query_sym: str = "none"
    builder: str = "nndescent"
    NN: int = 15
    ef_construction: int = 100
    ef_search: int = 128
    k: int = 10
    dim: int = 128
    n_db: int = 500_000
