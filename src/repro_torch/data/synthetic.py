"""Synthetic histogram collections (PyTorch port of ``repro.data.synthetic``).

  RandHist-d   : uniform samples from the d-simplex (Dirichlet(1,...,1)).
  Wiki-d/RCV-d : LDA-like topic histograms, sparse Dirichlet(alpha << 1).

Draws come from a seeded ``numpy.random.Generator`` and are then moved to the
device as float32.  They cannot reproduce ``jax.random``, so tests that
compare the two packages feed the port ``repro``'s arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distances import EPS


def _to_device(x: np.ndarray, device) -> torch.Tensor:
    x = np.maximum(x.astype(np.float32), np.float32(EPS))
    x /= x.sum(axis=-1, keepdims=True)
    return torch.from_numpy(x).to(resolve_device(device))


def random_histograms(rng: np.random.Generator, n: int, d: int, device="cuda"):
    """RandHist-d: uniform on the simplex, floored at EPS (paper's setup)."""
    return _to_device(rng.dirichlet(np.ones(d), size=n), device)


def lda_like_histograms(rng: np.random.Generator, n: int, d: int, alpha: float = 0.08,
                        device="cuda"):
    """Wiki-d / RCV-d proxy: concentrated Dirichlet topic histograms."""
    return _to_device(rng.dirichlet(np.full(d, alpha), size=n), device)


def split_queries(X, n_queries: int, rng: np.random.Generator):
    """Paper protocol: random split into queries and indexable points."""
    perm = torch.from_numpy(rng.permutation(X.shape[0])).to(X.device)
    return X[perm[:n_queries]], X[perm[n_queries:]]
