"""Distance learning baseline (PyTorch port of ``repro.core.metric_learning``).

A low-rank map L is trained so that true k-NN pairs (under the ORIGINAL
non-metric distance) are closer in L-space than random pairs: plain SGD on
a margin-ranking hinge, the gradient from ``torch.autograd``.  L2 in the
mapped space is the learned proxy (symmetric and metric: the coercion the
paper shows to be lossy).  ``repro_torch.core.learned`` embeds the map as a
correction term of a learned construction distance instead.

The random draws of one fit live in one ``MahalanobisDraws`` object.
``draw_mahalanobis`` makes them from a ``torch.Generator``; a test can pass
the JAX package's draws, replayed from its key splits, and compare maps.
The true neighbours come from ``knn_scan`` (``distance_matrix`` on the card).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.brute_force import knn_scan
from repro_torch.core.distances import l2_squared
from repro_torch.core.symmetrize import ViewedDistance
from repro_torch.kernels.ref import exact_float32_matmul

BATCH = 256  # (anchor, positive, negative) triples per SGD step


def true_neighbor_ids(dist, X, anchor_ids, k_pos: int, *, chunk: int = 4096):
    """True k-NN ids of ``X[anchor_ids]`` under ``dist``, self excluded BY ID.

    A positional drop of rank 0 is wrong for non-metric distances: negdot
    gives d(u, u) = -||u||^2 while d(u, 2u) = -2||u||^2 ranks closer.  A
    stable sort on the self mask moves every non-self id to the front in
    rank order; the first ``k_pos`` are taken.
    """
    anchor_ids = torch.as_tensor(anchor_ids, device=X.device).long()
    _, ids = knn_scan(dist, X[anchor_ids], X, k_pos + 1, chunk=chunk)
    is_self = (ids == anchor_ids[:, None]).to(torch.int8)
    order = torch.sort(is_self, dim=1, stable=True).indices  # non-self first
    return torch.gather(ids, 1, order)[:, :k_pos]


class MahalanobisDraws(NamedTuple):
    """The random draws of one ``fit_mahalanobis_map`` call."""

    anchors: torch.Tensor  # (A,) distinct rows of X: the anchors
    L0: torch.Tensor  # (m, rank) float32 initial map, N(0, 1) / sqrt(m)
    idx: torch.Tensor  # (steps, BATCH) in [0, A): the anchors of each step
    pos: torch.Tensor  # (steps, BATCH) in [0, k_pos): the positive's column
    neg: torch.Tensor  # (steps, BATCH) in [0, n): the random negatives


def draw_mahalanobis(n: int, m: int, rank: int, steps: int, n_anchors: int, k_pos: int,
                     generator=None, device="cpu") -> MahalanobisDraws:
    """The draws of one fit over n rows of width m (``rank``, ``n_anchors``
    already clamped to m and n)."""
    def ints(high, size):
        return torch.randint(0, high, size, generator=generator, device=device)

    anchors = torch.randperm(n, generator=generator, device=device)[:n_anchors]
    L0 = torch.randn((m, rank), generator=generator, device=device) / math.sqrt(m)
    return MahalanobisDraws(anchors=anchors, L0=L0, idx=ints(n_anchors, (steps, BATCH)),
                            pos=ints(k_pos, (steps, BATCH)), neg=ints(n, (steps, BATCH)))


def fit_mahalanobis_map(X, dist, generator=None, *, rank: int = 32, steps: int = 200,
                        n_anchors: int = 512, k_pos: int = 10, lr: float = 0.05,
                        margin: float = 1.0, draws: MahalanobisDraws = None):
    """Fit the low-rank map L: (m, rank) by margin ranking on true-NN pairs.

    Positives are true k-NN under the ORIGINAL (left-query) distance; each
    step pushes an anchor closer (squared L2 in L-space) to a sampled
    positive than to a random negative by ``margin``, and takes one plain
    SGD step of size ``lr``.  ``draws`` replaces the draws from
    ``generator``.  Returns L, detached, on X's device.
    """
    n, m = X.shape
    rank = min(rank, m)
    if draws is None:
        draws = draw_mahalanobis(n, m, rank, steps, min(n_anchors, n), k_pos, generator,
                                 X.device)
    anchors = draws.anchors.to(X.device).long()
    Xa = X[anchors]
    pos_ids = true_neighbor_ids(dist, X, anchors, k_pos).long()
    idx, pos, neg = (d.to(X.device).long() for d in (draws.idx, draws.pos, draws.neg))
    L = draws.L0.to(device=X.device, dtype=torch.float32)
    with exact_float32_matmul():
        for i in range(steps):
            L = L.detach().requires_grad_(True)
            a = Xa[idx[i]] @ L
            p = X[pos_ids[idx[i], pos[i]]] @ L
            ng = X[neg[i]] @ L
            d_pos = torch.sum((a - p) ** 2, dim=1)
            d_neg = torch.sum((a - ng) ** 2, dim=1)
            hinge = d_pos - d_neg + margin
            # torch.maximum splits the gradient at a tie, as jnp.maximum does
            loss = torch.mean(torch.maximum(torch.zeros_like(hinge), hinge))
            (g,) = torch.autograd.grad(loss, L)
            L = L.detach() - lr * g
    return L.detach()


def learn_mahalanobis(X, dist, generator=None, *, rank: int = 32, steps: int = 200,
                      n_anchors: int = 512, k_pos: int = 10, lr: float = 0.05,
                      margin: float = 1.0):
    """Learn a low-rank map L: (m, rank) by margin ranking on true-NN pairs.

    Returns a distance: squared L2 over the mapped representations.
    """
    L = fit_mahalanobis_map(X, dist, generator, rank=rank, steps=steps, n_anchors=n_anchors,
                            k_pos=k_pos, lr=lr, margin=margin)

    def view(M):
        return M @ L.to(M.device)

    return ViewedDistance(l2_squared(), left_view=view, right_view=view,
                          view_name="mahalanobis")


def l2_proxy():
    """The paper's pseudo-learning baseline."""
    return l2_squared()
