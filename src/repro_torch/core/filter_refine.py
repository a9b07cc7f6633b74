"""Filter-and-refine retrieval (paper SS3, first experimental series), PyTorch
port of ``repro.core.filter_refine``.

A proxy distance (a symmetrized distance, L2, a learned one) picks k_c
candidates, by a brute-force scan or by a graph search under it; the
candidates are re-ranked under the ORIGINAL (non-symmetric) distance.  The
paper's Table 3 measures the k_c needed to reach 99% recall.
"""

from __future__ import annotations

import torch

from repro_torch.core.brute_force import knn_scan
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.symmetrize import reverse_of
from repro_torch.kernels.ops import gathered_scores, prepped


def rerank(orig_dist, Q, X, cand_ids, k: int, mode: str = "left", consts=None):
    """Re-rank candidate ids under the original distance; return the top k.

    cand_ids (B, k_c) int32, -1 padding.  Returns (dists (B, k), ids (B, k)):
    ascending, the lower position first on equal distances (the tie rule of
    ``jax.lax.top_k``).  The (B, k_c) candidates are one ``gather_scores``
    launch per branch on the card.  ``consts`` is
    ``prepped(orig_dist.prep_scan(X))`` when the caller preps the database
    once (a searcher does); ``mode="right"`` ranks by d(q, x).
    """
    if mode not in ("left", "right"):
        raise ValueError(f"unknown query mode {mode!r}")
    dist = reverse_of(orig_dist) if mode == "right" else orig_dist
    if consts is None:
        consts = prepped(dist.prep_scan(X))
    valid = cand_ids >= 0
    d = gathered_scores(dist, torch.where(valid, cand_ids, 0), prepped(dist.prep_queries(Q)),
                        consts)
    d = torch.where(valid, d, torch.inf)
    d_s, pos = torch.sort(d, dim=1, stable=True)
    return d_s[:, :k], torch.gather(cand_ids, 1, pos[:, :k])


def filter_and_refine(orig_dist, proxy_dist, Q, X, k: int, k_c: int, chunk: int = 8192,
                      proxy_mode: str = "left"):
    """Brute-force k_c-NN under the proxy, re-ranked under the original.

    Returns (dists (B, k) under the original distance, ids (B, k)).
    """
    _, cand = knn_scan(proxy_dist, Q, X, k_c, chunk=chunk, mode=proxy_mode)
    return rerank(orig_dist, Q, X, cand, k)


def kc_sweep(orig_dist, proxy_dist, Q, X, true_ids, k: int = 10, max_pow: int = 7,
             target: float = 0.99, chunk: int = 8192):
    """The paper's Table-3 protocol: test k_c = k * 2^i for i <= max_pow and
    report the first k_c reaching ``target`` recall (or the best reached).

    Returns a list of (k_c, recall) and the (k_c*, recall*) summary tuple.
    """
    results = []
    best = (None, 0.0)
    for i in range(0, max_pow + 1):
        k_c = k * (2**i)
        if k_c > X.shape[0]:
            break
        _, ids = filter_and_refine(orig_dist, proxy_dist, Q, X, k, k_c, chunk=chunk)
        r = recall_at_k(ids, true_ids)
        results.append((k_c, r))
        if r > best[1]:
            best = (k_c, r)
        if r >= target:
            return results, (k_c, r)
    return results, best
