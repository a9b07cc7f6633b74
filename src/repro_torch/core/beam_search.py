"""Best-first beam search over a fixed-degree graph (PyTorch port of
``repro.core.beam_search``): the single-query reference engine.

One step expands the nearest unexpanded beam entry: gather its M neighbor
rows, score the unvisited ones, merge them into the sorted beam.  The
search stops when the nearest unexpanded entry is farther than the worst
beam member (NMSLIB's efSearch semantics).  Every exact parity test holds
the other engines and builders against this one.

The JAX package runs one ``while_loop`` per query under ``vmap``; here the
B queries run in one batched loop with a per-query live mask, and a query
whose loop would have ended passes through each later step unchanged, so
its beam, ``n_evals`` and ``steps`` are the per-query values.  Scoring
goes through ``ops.gathered_scores``: ``gather_scores`` on the card (one
launch per branch of the distance), on the CPU its plain version, a
product and a sum per branch with the same rounding for every batch shape
(so a W=1 wave build and the sequential build score alike).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ops import gathered_scores, prepped

INF = float("inf")


class BeamState(NamedTuple):
    beam_d: torch.Tensor  # (B, ef) f32, ascending, inf-padded
    beam_i: torch.Tensor  # (B, ef) i32, -1-padded
    expanded: torch.Tensor  # (B, ef) bool (padding = True)
    visited: torch.Tensor  # (B, n) bool
    n_evals: torch.Tensor  # (B,) i32 distance evaluations (the paper's cost unit)
    steps: torch.Tensor  # (B,) i32


def beam_search_impl(neighbors, consts, qc, dist, entry: int, ef: int, n_active=None,
                     max_steps: int | None = None) -> BeamState:
    """Beam search for B queries at once, each as the JAX single-query loop.

    ``neighbors`` (n, M) int32 with -1 padding; ``consts`` the prepped
    ``dist.prep_scan(X)``, ``qc`` the B queries' prepped
    ``dist.prep_queries(Q)``; ``entry`` the entry node;
    ``n_active`` (int or 0-d tensor) makes only nodes < n_active searchable
    (the sequential builder's prefix).  Returns the final ``BeamState``.
    """
    n, M = neighbors.shape
    B = dist.branch_reps(qc)[0]["rep"].shape[0]
    dev = neighbors.device
    if max_steps is None:
        max_steps = n
    rows_b = torch.arange(B, device=dev)[:, None]

    # one sentinel column n absorbs the writes of invalid neighbor slots
    visited = torch.zeros((B, n + 1), dtype=torch.bool, device=dev)
    if n_active is not None:
        visited[:, :n] = (torch.arange(n, device=dev) >= n_active)[None, :]
    visited[:, entry] = True
    entry_ids = torch.full((B, 1), entry, dtype=torch.int32, device=dev)
    d0 = gathered_scores(dist, entry_ids, qc, consts)[:, 0]

    beam_d = torch.full((B, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = d0
    beam_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    beam_i[:, 0] = entry
    expanded = torch.ones((B, ef), dtype=torch.bool, device=dev)
    expanded[:, 0] = False
    n_evals = torch.ones((B,), dtype=torch.int32, device=dev)
    steps = torch.zeros((B,), dtype=torch.int32, device=dev)

    while True:
        cand = torch.where(expanded, INF, beam_d)
        cand_d, c = cand.min(dim=1)  # the first minimum, as jnp.argmin
        live = (cand_d <= beam_d[:, -1]) & torch.isfinite(cand_d) & (steps < max_steps)
        if not live.any().item():  # jaxlint: disable=JL003 - the loop condition itself
            break
        node = torch.gather(beam_i, 1, c[:, None])[:, 0]
        expanded = expanded.scatter(1, c[:, None], live[:, None] | torch.gather(
            expanded, 1, c[:, None]))

        nbrs = neighbors[torch.where(live, node, 0).long()]  # (B, M)
        safe = torch.where(nbrs >= 0, nbrs, 0).long()
        # visited is read before this step's writes: a neighbor id repeated
        # in one row is scored twice, as in the JAX .at[].max update
        valid = (nbrs >= 0) & ~torch.gather(visited, 1, safe) & live[:, None]
        visited[rows_b, torch.where(valid, safe, n)] = True
        d = torch.where(valid, gathered_scores(dist, safe, qc, consts), INF)

        all_d = torch.cat([beam_d, d], dim=1)
        all_i = torch.cat([beam_i, nbrs.to(torch.int32)], dim=1)
        all_e = torch.cat([expanded, ~valid], dim=1)
        order = torch.sort(all_d, dim=1, stable=True).indices[:, :ef]
        # a frozen query's own beam is already sorted with no candidates
        # below it, so the stable merge leaves it as it was
        beam_d = torch.gather(all_d, 1, order)
        beam_i = torch.gather(all_i, 1, order)
        expanded = torch.gather(all_e, 1, order)
        n_evals = n_evals + valid.sum(dim=1, dtype=torch.int32)
        steps = steps + live.to(torch.int32)
    return BeamState(beam_d, beam_i, expanded, visited[:, :n], n_evals, steps)


def make_batched_searcher(dist, neighbors, X, ef: int, k: int, entry: int = 0,
                          max_steps: int | None = None):
    """Searcher over the reference engine for a fixed index and distance.

    Returns ``search(Q) -> (dists (B,k), ids (B,k), n_evals (B,), hops (B,))``
    with distances under ``dist`` in the paper's left-query convention.
    """
    consts = prepped(dist.prep_scan(X))

    def search(Q):
        qc = prepped(dist.prep_queries(Q))
        st = beam_search_impl(neighbors, consts, qc, dist, entry, ef, max_steps=max_steps)
        return st.beam_d[:, :k], st.beam_i[:, :k], st.n_evals, st.steps

    return search
