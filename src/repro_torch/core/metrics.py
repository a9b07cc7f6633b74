"""Retrieval quality / efficiency metrics (paper SS3).

recall@k is the average fraction of true neighbors found, order-insensitive.
The hardware-independent efficiency metric is the distance-computation
reduction n_db / n_evals, which the paper's wall-clock speedup tracks when
the distance dominates.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def recall_at_k(found_ids, true_ids) -> float:
    """Average |found intersect true| / |true| over the query batch."""
    found = _host(found_ids)
    true = _host(true_ids)
    if found.shape[0] != true.shape[0]:
        raise ValueError(f"found has {found.shape[0]} rows, true has {true.shape[0]}")
    hits = 0
    total = 0
    for f, t in zip(found, true):
        t_set = set(int(x) for x in t if x >= 0)
        f_set = set(int(x) for x in f if x >= 0)
        hits += len(t_set & f_set)
        total += len(t_set)
    return hits / max(total, 1)


def speedup_model(n_db: int, n_evals_per_query) -> float:
    """Distance-evaluation reduction vs brute force (model speedup)."""
    ev = float(np.mean(_host(n_evals_per_query)))
    return n_db / max(ev, 1.0)
