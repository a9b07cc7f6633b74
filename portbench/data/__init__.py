"""The benchmark's data, made from ``--seed``.

A configuration names its generator (``"data"``), the file
``data/<name>.py``, whose ``make(cfg, gen, device)`` returns ``(X (n, d),
pool (queries, d))``: the indexable rows and the held-out query pool, drawn
with ``gen`` on the device.
"""

from __future__ import annotations

import hashlib

import torch

from portbench import plugins


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose (data, traffic, judge) from ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, purpose))


def make_data(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(X, pool)`` of the configuration ``cfg`` from ``seed``."""
    mod = plugins.load("data", cfg["data"], "data generator")
    return mod.make(cfg, generator(seed, "data", device), device)
