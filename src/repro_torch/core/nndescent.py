"""Parallel NN-descent graph construction (Dong et al. 2011), PyTorch port.

Every refinement round is a batched neighbor-of-neighbor join

    candidates(i) = adj[adj[i]]  u  sampled-reverse(i)  u  random(i)
    adj(i) <- top-K by d_build(x_c, x_i) after id-dedup

whose candidate scoring goes through the frontier-gather kernels: every
database row acts as its own query, with the database prepped once per build.
On the card the K*K two-hop columns are scored grouped by the middle node
(``two_hop_scores``) and the reverse and random columns by
``frontier_scores``, both straight into one (n, K + R) score block that also
holds the current neighbours, so a round concatenates no scores.  Under a
symmetrized, combined or learned build distance each branch is one such
launch pair into a block of its own, combined in place into the first.

The random draws live in one ``NNDescentDraws`` object.  ``draw_nndescent``
makes them from a ``torch.Generator``; a test can instead pass the JAX
package's draws, replayed from its key splits, and compare adjacencies.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.trace import span
from repro_torch.kernels.ops import prepped, round_scores, row_scores

INF = float("inf")


class NNDescentDraws(NamedTuple):
    init: torch.Tensor  # (n, K) in [0, n-1): random initial neighbors (self excluded by shift)
    rev_slots: torch.Tensor  # (iters, K) in [0, K): reverse-list slot of each forward column
    rnd: torch.Tensor  # (iters, n, n_random) in [0, n): random candidates per round
    final_slots: torch.Tensor  # (K,) in [0, M_out - K): slots of the final reverse edges


def draw_nndescent(n: int, K: int, iters: int, n_random: int, M_out: int,
                   generator=None, device="cpu") -> NNDescentDraws:
    """The random draws of one ``build_nndescent`` call (K already clamped)."""
    def ints(high, size):
        return torch.randint(0, high, size, generator=generator, device=device,
                             dtype=torch.int32)

    return NNDescentDraws(
        init=ints(n - 1, (n, K)),
        rev_slots=ints(K, (iters, K)),
        rnd=ints(n, (iters, n, n_random)),
        final_slots=ints(max(M_out - K, 1), (K,)),
    )


def _score_rows(dist, consts, qc_all, ids):
    """d_build(X[ids[i, c]], X[i]) for every node i, candidate c. (n, C)."""
    safe = torch.where(ids >= 0, ids, 0)
    return row_scores(dist, safe, qc_all, consts).float()


def _dedup_topk(d, ids, K: int):
    """Per-row: drop duplicate ids (keep the first), return the K smallest by d."""
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    d_s = torch.gather(d, 1, order)
    dup = torch.cat(
        [torch.zeros((ids.shape[0], 1), dtype=torch.bool, device=ids.device),
         ids_s[:, 1:] == ids_s[:, :-1]], dim=1
    )
    d_s = torch.where(dup | (ids_s < 0), INF, d_s)
    d_k, sel = torch.sort(d_s, dim=1, stable=True)
    sel = sel[:, :K]
    return d_k[:, :K], torch.gather(ids_s, 1, sel)


def _sampled_reverse(adj, K_rev: int, slots):
    """A sampled fixed-width reverse-neighbor list via ONE colliding scatter.

    Every edge (src, dst) bids for slot ``slots[column]`` of ``rev[dst]``;
    collisions keep the largest source id.  Invalid edges (dst < 0) go to a
    sentinel row n that is dropped afterwards, the port of the JAX scatter's
    ``mode="drop"``.
    """
    n, K = adj.shape
    src = torch.arange(n, dtype=torch.int32, device=adj.device)[:, None].expand(n, K)
    dst = torch.where(adj >= 0, adj, n).long()
    flat = dst * K_rev + slots.long()[None, :]
    rev = torch.full(((n + 1) * K_rev,), -1, dtype=torch.int32, device=adj.device)
    rev.scatter_reduce_(0, flat.reshape(-1), src.reshape(-1), reduce="amax")
    return rev.view(n + 1, K_rev)[:n]


def build_nndescent(dist, X, generator=None, K: int = 16, iters: int = 8,
                    n_random: int = 8, M_out: int | None = None,
                    add_reverse: bool = True, draws: NNDescentDraws | None = None):
    """Returns ``(neighbors (n, M_out) int32, degrees (n,) int32)``.

    ``M_out`` defaults to 2K when ``add_reverse`` (forward + sampled reverse
    edges).  ``draws`` replaces the generator's draws (see ``draw_nndescent``).

    Spans (``core.trace``; those marked * timed on the card too):
    ``build.nndescent``* over ``build.init``, one ``build.round``* per round
    (its ``build.join``*, the candidate block and its scores, and
    ``build.dedup``*, ``_dedup_topk``) and ``build.reverse``.
    """
    with span("build.nndescent", device=True):
        return _build(dist, X, generator, K, iters, n_random, M_out, add_reverse, draws)


def _build(dist, X, generator, K, iters, n_random, M_out, add_reverse, draws):
    n = X.shape[0]
    K = min(K, n - 1)
    M_out = M_out or (2 * K if add_reverse else K)
    with span("build.init"):
        if draws is None:
            draws = draw_nndescent(n, K, iters, n_random, M_out, generator, X.device)
        elif (draws.init.shape != (n, K) or draws.rev_slots.shape != (iters, K)
              or draws.rnd.shape != (iters, n, n_random) or draws.final_slots.shape != (K,)):
            raise ValueError(f"draws do not fit n={n}, K={K}, iters={iters}, "
                             f"n_random={n_random}")
        consts = prepped(dist.prep_scan(X))
        qc_all = prepped(dist.prep_queries(X))  # the whole database prepped as queries once
        iota = torch.arange(n, dtype=torch.int32, device=X.device)

        # --- init: random neighbors (exclude self by +1 shift mod n) ---
        init_ids = (iota[:, None] + 1 + draws.init.to(X.device)) % n
        init_d = _score_rows(dist, consts, qc_all, init_ids)
        adj_d, adj = _dedup_topk(init_d, init_ids, K)

    KK = K * K
    width = K + KK + K + n_random  # current neighbours, then the round's candidates
    for r in range(iters):
        with span("build.round", device=True):
            with span("build.join", device=True):
                safe = torch.where(adj >= 0, adj, 0)
                ids = torch.empty((n, width), dtype=torch.int32, device=X.device)
                d = torch.empty((n, width), dtype=torch.float32, device=X.device)
                ids[:, :K] = adj
                d[:, :K] = adj_d
                cand = ids[:, K:]
                cand[:, :KK] = safe[safe.reshape(-1).long()].reshape(n, KK)
                cand[:, KK:KK + K] = _sampled_reverse(adj, K, draws.rev_slots[r])
                cand[:, KK + K:] = draws.rnd[r]
                cand.masked_fill_(cand == iota[:, None], -1)  # no self loops
                round_scores(dist, safe, cand[:, KK:], qc_all, consts, out=d[:, K:])
            with span("build.dedup", device=True):
                adj_d, adj = _dedup_topk(d, ids, K)

    with span("build.reverse"):
        if add_reverse:
            rev = _sampled_reverse(adj, M_out - K, draws.final_slots)
            # drop reverse edges that duplicate forward ones
            dup = (rev[:, :, None] == adj[:, None, :]).any(dim=2)
            rev = torch.where(dup, -1, rev)
            neighbors = torch.cat([adj, rev], dim=1)
        else:
            neighbors = adj[:, :M_out]

    degrees = (neighbors >= 0).sum(dim=1, dtype=torch.int32)
    return neighbors.to(torch.int32).contiguous(), degrees
