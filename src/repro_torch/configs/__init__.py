"""Architecture registry: ``--arch <id>`` resolution (PyTorch port of
``repro.configs``).

Ported: the dense LMs (llama3.2-1b, gemma3-12b, yi-34b), the MoE LMs
(phi3.5-moe, kimi-k2), the GCN (gcn-cora) and the two-tower retrieval
model.  The JAX package's other architectures (the other recsys models and
the paper's retrieval configs) raise ``NotImplementedError`` naming their
ROADMAP item (M17's queue).
"""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "yi-34b": ("repro_torch.configs.yi_34b", "lm"),
    "gemma3-12b": ("repro_torch.configs.gemma3_12b", "lm"),
    "llama3.2-1b": ("repro_torch.configs.llama3_2_1b", "lm"),
    "phi3.5-moe-42b-a6.6b": ("repro_torch.configs.phi3_5_moe", "lm"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2", "lm"),
    "gcn-cora": ("repro_torch.configs.gcn_cora", "gnn"),
    "two-tower-retrieval": ("repro_torch.configs.two_tower", "recsys"),
}
# the JAX package's registry, not ported yet (ROADMAP M17's queue)
_UNPORTED = ("autoint", "din", "dcn-v2", "swgraph-retrieval")

ARCH_IDS = list(_ARCH_MODULES)


def _entry(arch: str):
    if arch in _UNPORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported to repro_torch yet (ROADMAP M17); "
            f"ported: {ARCH_IDS}")
    try:
        return _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown architecture {arch!r}") from None


def get_family(arch: str) -> str:
    return _entry(arch)[1]


def get_config(arch: str):
    return importlib.import_module(_entry(arch)[0]).FULL


def get_smoke_config(arch: str):
    return importlib.import_module(_entry(arch)[0]).SMOKE
