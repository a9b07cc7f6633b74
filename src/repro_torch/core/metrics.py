"""Retrieval quality / efficiency metrics (paper SS3).

recall@k is the average fraction of true neighbors found, order-insensitive;
``order_aware_recall`` weights each true neighbor by its rank (a diagnostic).
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


def order_aware_recall(found_ids, true_ids) -> float:
    """Position-weighted recall: true neighbor of rank r found anywhere in
    the row earns 1 / log2(r + 2), normalized per query.  The paper breaks
    ties arbitrarily, so this is a diagnostic, not a headline number."""
    found = _host(found_ids)
    true = _host(true_ids)
    k = true.shape[1]
    w = 1.0 / np.log2(np.arange(2, k + 2))
    score, norm = 0.0, w.sum()
    for f, t in zip(found, true):
        f_set = set(int(y) for y in f)
        for rank, x in enumerate(t):
            if int(x) in f_set:
                score += w[rank]
    return score / (norm * found.shape[0])
