"""Config dataclasses (PyTorch port of ``repro.configs.base``: ``RecsysConfig``).

The LM, GNN and retrieval configs wait for ROADMAP M17.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """Sparse-embedding CTR/retrieval models: the fields the two-tower path reads.

    ``interaction``: self-attn (AutoInt) | target-attn (DIN) | cross (DCN-v2)
                     | dot (two-tower retrieval; the only one ported)
    ``vocab_sizes``: per-field embedding table rows.
    The other interactions' fields (dense features, attention, cross layers)
    come with them in ROADMAP M17.
    """

    name: str
    interaction: str
    vocab_sizes: Tuple[int, ...]
    embed_dim: int
    tower_mlp_dims: Tuple[int, ...] = ()

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    def table_rows(self) -> int:
        return sum(self.vocab_sizes)
