"""Step-synchronized batched beam-search engine (PyTorch port).

All B queries advance in lock-step.  Each step:

  1. every active query pops its ``frontier`` best unexpanded beam entries,
  2. their neighbor rows are gathered as one (B, frontier*M) id block,
  3. the block is scored by one launch of the CUDA gather kernel
     ``gather_scores`` per branch of the distance (its plain PyTorch
     version on the CPU),
  4. a batched (B, ef + C) stable merge refreshes every beam,
  5. per-query convergence masking freezes finished queries.

The loop is a Python loop that reads ``done.all()`` once per step.  Its
spans (``core.trace``): ``search.batch`` around a searcher's call,
``search.seed``, ``search.step`` around each lock-step and ``search.sync``
around each read of ``done``.  Every
``jax.lax.top_k`` / ``jnp.argsort`` of the JAX engine becomes a stable
``torch.sort``: top_k puts the lower index first on equal values, and
``torch.topk`` promises no order for ties, which are common here (two
expanded nodes that share a neighbor give the same id and distance twice).

The visited set is bit-packed like the JAX engine's uint32 words, in int32
words with the same bit layout: bit 31 is the sign bit and ``(w >> b) & 1``
stays exact under the arithmetic shift.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.trace import span
from repro_torch.kernels.ops import gathered_scores, prepped, query_distance_matrix

INF = float("inf")


class BatchBeamState(NamedTuple):
    beam_d: torch.Tensor  # (B, ef) f32, ascending, inf-padded
    beam_i: torch.Tensor  # (B, ef) i32, -1-padded
    expanded: torch.Tensor  # (B, ef) bool (padding = True)
    visited: torch.Tensor  # (B, ceil(n/32)) int32 bit-packed visited set
    n_evals: torch.Tensor  # (B,) i32 distance evaluations (the paper's cost unit)
    hops: torch.Tensor  # (B,) i32 graph hops taken by each query
    done: torch.Tensor  # (B,) bool frozen queries


def _smallest(x, k: int):
    """(values, indices) of the k smallest per row, lower index first on ties."""
    vals, idx = torch.sort(x, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


# ---------------------------------------------------------------------------
# entry-point selection
# ---------------------------------------------------------------------------


def select_entries(dist, X, n_entries: int = 4, generator=None, sample: int = 256,
                   probe=None, rand=None):
    """Entry points for the beam: left-medoid + random spread.

    The medoid minimises the mean left-query distance d(x_i, .) towards a
    random sample ``probe`` of the database (one ``query_distance_matrix``
    block, under any distance); the remaining entries come from
    the random ids ``rand`` with the medoid excluded.  ``probe`` (s,) and
    ``rand`` (min(4 * n_entries, n),) are drawn from ``generator`` without
    replacement unless given: a test injects the JAX package's draws.
    """
    n = X.shape[0]
    n_entries = max(1, min(n_entries, n))
    s = min(sample, n)
    if probe is None:
        probe = torch.randperm(n, generator=generator, device=X.device)[:s]
    D = query_distance_matrix(dist, X[probe.long()], X, mode="left")
    medoid = torch.argmin(torch.mean(D, dim=0)).to(torch.int32)
    if n_entries == 1:
        return medoid[None]
    if rand is None:
        rand = torch.randperm(n, generator=generator, device=X.device)[:min(4 * n_entries, n)]
    rand = rand.to(device=X.device, dtype=torch.int32)
    # the stable sort keys the (at most one) medoid hit to the tail
    keep = torch.sort((rand == medoid).to(torch.int8), stable=True).indices
    return torch.cat([medoid[None], rand[keep][: n_entries - 1]])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _pack_mask(mask, nw: int):
    """(nw,) int32 words with bit v set where ``mask[v]`` ((nw * 32,) bool)."""
    lanes = torch.ones(32, dtype=torch.int32, device=mask.device) << torch.arange(
        32, dtype=torch.int32, device=mask.device)
    # distinct bits: the int64 sum of the 32 lanes is their OR, and it fits int32
    return torch.where(mask.view(nw, 32), lanes, 0).sum(dim=1).to(torch.int32)


def _pack_bits(ids, nw: int):
    """(nw,) int32 words with bit v set for every v in ``ids`` (repeats allowed)."""
    mask = torch.zeros(nw * 32, dtype=torch.bool, device=ids.device)
    mask[ids.long()] = True
    return _pack_mask(mask, nw)


def seed_beams(score_rows, entries, B: int, ef: int, n: int,
               n_active=None, alive=None) -> BatchBeamState:
    """Score the shared entry nodes for B queries and seed their beams.

    ``n_active`` (a 0-d int tensor on the entries' device, or None) makes
    only nodes < n_active searchable; ``alive`` ((n,) bool on the same
    device, or None, the online index's tombstone mask) makes only the
    nodes it flags searchable.  Every blocked node is pre-marked visited in
    the packed bitset, and a blocked entry seeds as (inf, -1) padding that
    is never expanded and not counted in ``n_evals``.  Both are tensors, so
    the wave builder and the online index move them without a host sync.
    """
    E = entries.shape[0]
    dev = entries.device
    masked = n_active is not None or alive is not None
    d0 = score_rows(entries[None, :].expand(B, E).contiguous()).float()
    if masked:
        entry_ok = torch.ones((E,), dtype=torch.bool, device=dev)
        if n_active is not None:
            entry_ok &= entries < n_active
        if alive is not None:
            entry_ok &= alive[entries.long()]
        d0 = torch.where(entry_ok[None, :], d0, INF)
    d0_sorted, order0 = _smallest(d0, min(E, ef))
    take = d0_sorted.shape[1]
    i0_sorted = entries[order0].to(torch.int32)
    if masked:
        i0_sorted = torch.where(torch.isfinite(d0_sorted), i0_sorted, -1)
    beam_d = torch.full((B, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, :take] = d0_sorted
    beam_i = torch.full((B, ef), -1, dtype=torch.int32, device=dev)
    beam_i[:, :take] = i0_sorted
    expanded = torch.ones((B, ef), dtype=torch.bool, device=dev)
    expanded[:, :take] = ~torch.isfinite(d0_sorted) if masked else False
    nw = -(-n // 32)
    seed = _pack_bits(entries, nw)
    if masked:
        # bit v set iff v is not searchable: the suffix and the tombstones
        blocked = torch.zeros(nw * 32, dtype=torch.bool, device=dev)
        if n_active is not None:
            blocked |= torch.arange(nw * 32, device=dev) >= n_active
        if alive is not None:
            blocked[:n] |= ~alive
            blocked[n:] = True
        seed = seed | _pack_mask(blocked, nw)
    visited = seed.expand(B, nw).contiguous()
    if masked:
        n_evals0 = entry_ok.sum(dtype=torch.int32).expand(B).contiguous()
    else:
        n_evals0 = torch.full((B,), E, dtype=torch.int32, device=dev)
    return BatchBeamState(
        beam_d,
        beam_i,
        expanded,
        visited,
        n_evals0,
        torch.zeros((B,), dtype=torch.int32, device=dev),
        torch.zeros((B,), dtype=torch.bool, device=dev),
    )


def beam_step(st: BatchBeamState, neighbors, score_rows, ef: int, T: int, C: int,
              max_steps: int, t_active=None, ef_active=None) -> BatchBeamState:
    """One lock-step of the batched beam engine.

    ``t_active`` (B,) optionally caps how many of the top-T popped candidates
    each query may expand this step (the adaptive-frontier policy).
    ``ef_active`` (B,) int32, each <= ef, optionally runs a query at a
    narrower efSearch inside the (B, ef) arrays: the termination radius is
    read at position ``ef_active - 1`` and the beam past ``ef_active`` is
    voided after the merge, so the query steps exactly as an engine at
    ``ef = ef_active`` would (the scheduler's demotion ladder).  Queries
    with ``done=True`` are frozen: beam, visited set and counters pass through.
    """
    B = st.beam_d.shape[0]
    M = neighbors.shape[1]
    dev = st.beam_d.device

    # -- per-query convergence masking (NMSLIB efSearch semantics)
    cand = torch.where(st.expanded, INF, st.beam_d)  # (B, ef)
    best = cand.min(dim=1).values
    if ef_active is None:
        worst = st.beam_d[:, -1]
    else:
        wi = torch.clamp(ef_active - 1, 0, ef - 1).long()[:, None]
        worst = torch.gather(st.beam_d, 1, wi)[:, 0]
    done = st.done | ~((best <= worst) & torch.isfinite(best)) | (st.hops >= max_steps)
    active = ~done

    # -- pop the top-T unexpanded candidates of each active query, gated to
    # the termination radius
    pop_d, slots = _smallest(cand, T)  # (B, T), best-first
    ok = torch.isfinite(pop_d) & (pop_d <= worst[:, None]) & active[:, None]
    if t_active is not None:
        ok &= torch.arange(T, device=dev)[None, :] < torch.clamp(t_active, max=T)[:, None]
    nodes = torch.gather(st.beam_i, 1, slots)
    # slots are distinct per row, so gather-OR-scatter is exact
    expanded = st.expanded.scatter(1, slots, torch.gather(st.expanded, 1, slots) | ok)

    # -- gather + score the (B, T*M) neighbor frontier in one fused call
    safe_nodes = torch.where(ok, nodes, 0)
    nbrs = neighbors[safe_nodes.long()].reshape(B, T * M)
    ok_r = ok.repeat_interleave(M, dim=1)  # (B, T*M), block-aligned
    safe = torch.where(nbrs >= 0, nbrs, 0)
    words = torch.gather(st.visited, 1, (safe // 32).long())
    unvisited = ((words >> (safe % 32)) & 1) == 0
    valid = (nbrs >= 0) & unvisited & ok_r
    d = torch.where(valid, score_rows(safe).float(), INF)

    # -- compact to the C best candidates
    kept_d, kidx = _smallest(d, C)
    kept_i = torch.gather(nbrs, 1, kidx)
    kept_ok = torch.gather(valid, 1, kidx)
    # two expanded nodes may share a neighbor: find later duplicates (O(C^2))
    later = torch.arange(C, device=dev)[:, None] > torch.arange(C, device=dev)[None, :]
    dup = torch.any(
        (kept_i[:, :, None] == kept_i[:, None, :]) & later[None] & kept_ok[:, None, :],
        dim=2,
    )
    if T > 1:
        # keep the first (best) occurrence, void the rest, restore sortedness
        kept_d = torch.where(dup, INF, kept_d)
        kept_ok = kept_ok & ~dup
        kept_d, ridx = _smallest(kept_d, C)
        kept_i = torch.gather(kept_i, 1, ridx)
        kept_ok = torch.gather(kept_ok, 1, ridx)
        mark = kept_ok
    else:
        mark = kept_ok & ~dup
    # mark kept candidates visited: per-row-unique (word, bit) updates, so a
    # scatter-add of fresh bits then a word-wise OR is exact
    safe_kept = torch.where(mark, kept_i, 0)
    bits = torch.where(mark, torch.ones_like(safe_kept) << (safe_kept % 32), 0)
    step_mask = torch.zeros_like(st.visited).scatter_add_(1, (safe_kept // 32).long(), bits)
    visited = st.visited | step_mask

    beam_d, beam_i, beam_e = _merge_beams(
        (st.beam_d, st.beam_i, expanded), (kept_d, kept_i, ~kept_ok), ef
    )
    if ef_active is not None:
        # the first ef_active entries of the stable merge are what a merge
        # into an ef_active-wide beam keeps: void the rest
        off = torch.arange(ef, device=dev)[None, :] >= ef_active[:, None]
        beam_d = torch.where(off, INF, beam_d)
        beam_i = torch.where(off, -1, beam_i)
        beam_e = beam_e | off
    return BatchBeamState(
        beam_d,
        beam_i,
        beam_e,
        visited,
        st.n_evals + valid.sum(dim=1, dtype=torch.int32),
        st.hops + active.to(torch.int32),
        done,
    )


def frontier_compact_width(T: int, M: int, compact: int) -> int:
    """Per-step merge width: only the C best-scoring candidates can enter
    the beam.  C >= M makes frontier=1 EXACT; for frontier > 1 it bounds the
    merge width, and dropped candidates stay unvisited."""
    return min(T * M, max(M, compact))


def adaptive_width_update(core: BatchBeamState, t_cur, stall, worst, T: int,
                          patience: int, radius=None):
    """One step of the per-query adaptive-frontier policy.

    While the beam radius (worst member) still shrinks, or the beam has not
    filled, a query expands one candidate per step; once it stalls for
    ``patience`` steps its width doubles per step back up to ``T``.
    """
    if radius is None:
        radius = core.beam_d[:, -1]
    improved = (radius < worst) | ~torch.isfinite(radius)
    stall = torch.where(improved, 0, stall + 1)
    t_cur = torch.where(
        improved,
        1,
        torch.where(stall >= patience, torch.clamp(t_cur * 2, max=T), t_cur),
    )
    return t_cur, stall, radius


def batched_beam_search(neighbors, score_rows, entries, B: int, ef: int,
                        max_steps: int | None = None, frontier: int = 1,
                        compact: int = 32, n_active=None, alive=None,
                        adaptive: bool = False, patience: int = 1):
    """Run B queries to convergence in lock-step.  Returns BatchBeamState.

    ``score_rows`` maps (B, R) int32 ids to (B, R) float32 left-query
    distances; invalid slots in its output are masked here, so it may score
    placeholder id 0 freely.  ``n_active`` (0-d int tensor) searches only
    the prefix of nodes < n_active, as the wave builder does against the
    frozen prefix graph; ``alive`` ((n,) bool) searches only the nodes it
    flags, as the online index does around its tombstones (see
    ``seed_beams``).  ``adaptive=True`` carries the
    per-query frontier width (``frontier`` becomes its maximum).
    """
    n, M = neighbors.shape
    if frontier < 1:
        raise ValueError(f"frontier must be >= 1, got {frontier}")
    T = min(frontier, ef)
    if max_steps is None:
        max_steps = n
    with span("search.seed"):
        st = seed_beams(score_rows, entries, B, ef, n, n_active=n_active, alive=alive)
    C = frontier_compact_width(T, M, compact)
    dev = st.beam_d.device
    if adaptive:
        t_cur = torch.ones((B,), dtype=torch.int32, device=dev)
        stall = torch.zeros((B,), dtype=torch.int32, device=dev)
        worst = torch.full((B,), INF, dtype=torch.float32, device=dev)
    # one host read of the done mask per step is the loop's only sync
    while True:
        with span("search.sync"):
            done = st.done.all().item()  # jaxlint: disable=JL003 - the loop condition itself
        if done:
            return st
        with span("search.step", device=True):
            if adaptive:
                st = beam_step(st, neighbors, score_rows, ef, T, C, max_steps, t_active=t_cur)
                t_cur, stall, worst = adaptive_width_update(st, t_cur, stall, worst, T, patience)
            else:
                st = beam_step(st, neighbors, score_rows, ef, T, C, max_steps)


def _merge_beams(beam, kept, ef: int):
    """Merge a sorted (B, ef) beam with sorted (B, C) candidates, keep ef.

    The first ef entries of the stable sort of [beam | candidates] by
    distance: ties resolve beam-first, then in candidate order, exactly as
    the JAX engine's bitonic network with (distance, position) keys.  A
    compare-exchange network of log2(ef + C) stages is ~30 small kernels
    per stage here, which made it most of a lock-step's host time; the
    sort is a handful.
    """
    beam_d, beam_i, beam_e = beam
    kept_d, kept_i, kept_e = kept
    d = torch.cat([beam_d, kept_d], dim=1)
    order = torch.sort(d, dim=1, stable=True).indices[:, :ef]
    return (torch.gather(d, 1, order),
            torch.gather(torch.cat([beam_i, kept_i], dim=1), 1, order),
            torch.gather(torch.cat([beam_e, kept_e], dim=1), 1, order))


# ---------------------------------------------------------------------------
# searcher factory
# ---------------------------------------------------------------------------


def make_step_searcher(dist, neighbors, X, ef: int, k: int, entries=None,
                       frontier: int = 4, compact: int = 32, max_steps: int | None = None,
                       adaptive: bool = False, patience: int = 1):
    """Batched searcher over the step-synchronized engine.

    Returns ``search(Q) -> (dists (B,k), ids (B,k), n_evals (B,), hops (B,))``.
    ``dist`` is any distance (the bound search policy under a rerank spec).
    Scoring goes through ``ops.gathered_scores``: one launch of the CUDA
    kernel ``gather_scores`` per branch for tensors on the card, the plain
    version for tensors on the CPU.
    """
    consts = prepped(dist.prep_scan(X))
    if entries is None:
        entries = torch.zeros((1,), dtype=torch.int32, device=X.device)
    # order-preserving dedup: the bit-packed visited seeding counts each
    # entry once in n_evals
    e = entries.detach().cpu().numpy()
    _, first = np.unique(e, return_index=True)
    entries = torch.as_tensor(e[np.sort(first)], dtype=torch.int32, device=X.device)

    def search(Q):
        with span("search.batch", device=True):
            B = Q.shape[0]
            qc = prepped(dist.prep_queries(Q))

            def score_rows(ids):
                return gathered_scores(dist, ids, qc, consts)

            st = batched_beam_search(
                neighbors, score_rows, entries, B, ef,
                max_steps=max_steps, frontier=frontier, compact=compact,
                adaptive=adaptive, patience=patience,
            )
            return st.beam_d[:, :k], st.beam_i[:, :k], st.n_evals, st.hops

    return search
