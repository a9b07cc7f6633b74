"""The comparisons that decide ``correct``, against the plain reference of the
configuration's base distance (``reference/<distance>.py``, passed in as
``dist``).

Each comparison returns ``{name: (value, limit, ok)}``.  Every number is
"higher is worse" except a recall, which is held to the floor that the
configuration states (``recall_at_10_floor``, ``graph_recall_floor``).
The limits and the readings they were set from are in ``PERF.md``.

Searches (``judge_answers``): every answer of the window, each a query of
the pool with its k ids and distances.

* ``invalid``: answers with an id outside the rows, a repeated id, or a
  distance that is not finite (exact, limit 0);
* ``missing``: answers due in the window that never came (exact, limit 0);
* ``dist_gap``: the widest gap between a returned distance and the
  reference's float64 ``d(x_id, q)`` of the same pair, over ``1 + |d|``;
* ``recall_at_10``: the mean share of the exact top-k (float32, TF32 off)
  among the returned ids.

Builds (``judge_graph``): the last graph of the window.

* ``invalid``: rows whose forward list holds a padding id, the node itself,
  or an id outside the rows, or whose whole row repeats an id (exact, 0);
* ``order_gap``: over a sample of nodes drawn from the seed, the widest
  step by which the forward list, which the builder keeps sorted by its own
  scores, descends under the reference's float64 build distance (the
  configuration's build policy over its base distance), over
  ``1 + |d|``;
* ``graph_recall``: the share of each sampled node's exact 10 nearest rows
  under the build distance (itself left out) that its forward list holds.
"""

from __future__ import annotations

import torch

from portbench import reference as ref


def _recall(ids: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """(N,) share of each row of ``truth`` found among the same row of ``ids``."""
    hit = (ids[:, :, None] == truth[:, None, :]).any(dim=1)
    return hit.float().mean(dim=1)


def _rows_with_repeats(ids: torch.Tensor) -> torch.Tensor:
    s = torch.sort(ids, dim=1).values
    same = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    return same.any(dim=1)


def pool_truth(dist, X, pool, used, k: int, tf32: bool = False):
    """Exact top-k under ``d(x, q)`` of the pool rows flagged in ``used``
    (B,) bool, as (B, k) int64 with -1 in the rows not used."""
    rows = torch.nonzero(used).squeeze(1)
    truth = torch.full((pool.shape[0], k), -1, dtype=torch.int64, device=pool.device)
    dists = torch.full((pool.shape[0], k), float("inf"), device=pool.device)
    if rows.numel():
        d, i = ref.exact_topk(dist, pool[rows], X, k, tf32=tf32)
        truth[rows], dists[rows] = i, d
    return dists, truth


def judge_answers(dist, X, pool, qidx, ids, dists, truth, *, due: int, floor: float,
                  limit_gap: float, block: int = 65536) -> dict:
    """The comparisons of a search's answers.

    ``qidx`` (N,) pool rows, ``ids`` (N, k), ``dists`` (N, k) the answers as
    returned; ``truth`` the pool's exact top-k (``pool_truth``); ``due``
    the number of answers due in the window.
    """
    n = X.shape[0]
    N = int(qidx.shape[0])
    bad = gap = hits = 0.0
    for a in range(0, N, block):
        i = ids[a:a + block].long()
        d = dists[a:a + block].float()
        q = qidx[a:a + block].long()
        outside = ((i < 0) | (i >= n)).any(dim=1)
        rows_bad = outside | _rows_with_repeats(i) | ~torch.isfinite(d).all(dim=1)
        bad += float(rows_bad.sum())
        safe_i = i.clamp(0, n - 1)
        d_ref = dist.pairs(X[safe_i], pool[q][:, None, :])
        g = (d.double() - d_ref).abs() / (1.0 + d_ref.abs())
        g = torch.where(rows_bad[:, None], torch.zeros_like(g), g)
        gap = max(gap, float(g.max())) if g.numel() else gap
        hits += float(_recall(i, truth[q]).sum())
    recall = hits / N if N else 0.0
    missing = max(due - N, 0)
    return {
        "invalid": (bad, 0, bad == 0),
        "missing": (float(missing), 0, missing == 0),
        "dist_gap": (gap, limit_gap, gap <= limit_gap),
        "recall_at_10": (recall, floor, recall >= floor),
    }


def sample_nodes(n: int, count: int, seed: int, device) -> torch.Tensor:
    from portbench.data import generator

    gen = generator(seed, "judge", device)
    return torch.randperm(n, generator=gen, device=device)[:min(count, n)]


def graph_truth(dist, X, nodes, build: str, k: int = 10, tf32: bool = False):
    """Exact k nearest rows of each sampled node under the build distance
    (policy ``build``), the node itself left out: ``(dists, ids)``."""
    return ref.exact_topk(dist, X[nodes], X, k, policy_name=build, exclude=nodes, tf32=tf32)


def judge_graph(dist, X, neighbors, K: int, nodes, truth, *, build: str, floor: float,
                limit_gap: float) -> dict:
    """The comparisons of a built graph (``neighbors`` (n, M), forward list
    the first ``K`` columns)."""
    n = X.shape[0]
    nb = neighbors.long()
    fwd = nb[:, :K]
    iota = torch.arange(n, device=nb.device)[:, None]
    rows_bad = (((fwd < 0) | (fwd >= n) | (fwd == iota)).any(dim=1)
                | ((nb >= n) | (nb == iota)).any(dim=1) | _rows_with_repeats(nb))
    bad = float(rows_bad.sum())
    f = fwd[nodes].clamp(0, n - 1)
    d = ref.pair_distance(dist, build, X[f], X[nodes][:, None, :])
    step = (d[:, :-1] - d[:, 1:]).clamp_min(0) / (1.0 + d[:, :-1].abs())
    gap = float(step.max()) if step.numel() else 0.0
    recall = float(_recall(fwd[nodes], truth).mean())
    return {
        "invalid": (bad, 0, bad == 0),
        "order_gap": (gap, limit_gap, gap <= limit_gap),
        "graph_recall": (recall, floor, recall >= floor),
    }
