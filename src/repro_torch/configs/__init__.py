"""Architecture registry: ``--arch <id>`` resolution (PyTorch port of
``repro.configs``) for the ten assigned architectures plus the paper's own
retrieval configs (``swgraph-retrieval``, family ``retrieval``, left out of
``ARCH_IDS`` as in ``repro``)."""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    # LM family
    "yi-34b": ("repro_torch.configs.yi_34b", "lm"),
    "gemma3-12b": ("repro_torch.configs.gemma3_12b", "lm"),
    "llama3.2-1b": ("repro_torch.configs.llama3_2_1b", "lm"),
    "phi3.5-moe-42b-a6.6b": ("repro_torch.configs.phi3_5_moe", "lm"),
    "kimi-k2-1t-a32b": ("repro_torch.configs.kimi_k2", "lm"),
    # GNN
    "gcn-cora": ("repro_torch.configs.gcn_cora", "gnn"),
    # recsys
    "autoint": ("repro_torch.configs.autoint", "recsys"),
    "din": ("repro_torch.configs.din", "recsys"),
    "two-tower-retrieval": ("repro_torch.configs.two_tower", "recsys"),
    "dcn-v2": ("repro_torch.configs.dcn_v2", "recsys"),
    # the paper's own architecture
    "swgraph-retrieval": ("repro_torch.configs.paper_swgraph", "retrieval"),
}

ARCH_IDS = [a for a in _ARCH_MODULES if a != "swgraph-retrieval"]


def _entry(arch: str):
    try:
        return _ARCH_MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown architecture {arch!r}") from None


def get_family(arch: str) -> str:
    return _entry(arch)[1]


def get_config(arch: str):
    mod = get_module(arch)
    if hasattr(mod, "FULL"):
        return mod.FULL
    return mod.WIKI128_KL  # paper retrieval default


def get_smoke_config(arch: str):
    return get_module(arch).SMOKE


def get_module(arch: str):
    return importlib.import_module(_entry(arch)[0])
