"""Wave-parallel SW-graph construction and the sharded build (PyTorch port
of ``repro.core.build_engine``).

Points are inserted in waves of W.  Each wave runs its W construction beam
searches through the batched engine against the FROZEN prefix graph
(``n_active`` masking), so wave-mates do not see each other: the relaxed
ordering NMSLIB accepts across insert threads.  Each point's closest L
wave-mates then compete with its beam results for the NN forward slots;
forward edges land as one scatter, and reverse edges go through a
degree-capped scatter-with-eviction merge.  At W=1 the build equals the
sequential ``swgraph.build_swgraph`` edge for edge.

Scoring follows the tensors' device, for any build distance.  On the card
the construction searches' candidate blocks, the reverse-edge candidates
and the intra-wave block go through the per-cell gather kernel
``gather_scores``, one launch per branch of the distance; on the CPU all
take the plain gathered dot product that the sequential builder uses.

The JAX package's ``.at[].set(mode="drop")`` scatters become writes into a
sentinel row n, which the builder keeps below its adjacency and slices off
at the end: ``index_put`` raises on out-of-bounds rows.

``build_sharded`` is the multi-process composition on ``torch.distributed``:
each rank builds a subgraph over its own rows, all ranks exchange a sample
of their rows (one ``all_gather``), and every local point keeps its best
``cross_links`` edges into other shards, scored with the distance-matrix
kernel on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.batched_beam import _smallest, batched_beam_search
from repro_torch.core.distances import tree_map
from repro_torch.core.distributed import all_gather, local_block
from repro_torch.kernels.ops import gathered_scores, prepped, query_distance_matrix

INF = float("inf")


def _with_sentinel(adj, adj_d):
    """Copies of (n, M) ``adj``/``adj_d`` with a trailing sentinel row."""
    M = adj.shape[1]
    return (torch.cat([adj, adj.new_full((1, M), -1)]),
            torch.cat([adj_d, adj_d.new_full((1, M), INF)]))


def _reverse_edge_merge_(adj_s, adj_d_s, owners, cands, d_rev, ok, rounds: int) -> None:
    """``reverse_edge_merge`` in place on sentinel-padded (n + 1, M) buffers."""
    n = adj_s.shape[0] - 1
    U = owners.shape[0]
    dev = owners.device
    d_rev = torch.where(ok, d_rev, INF)
    owner_key = torch.where(ok, owners, n)
    # jnp.lexsort((d_rev, owner_key)): by owner, then distance, stable
    by_d = torch.sort(d_rev, stable=True).indices
    order = by_d[torch.sort(owner_key[by_d], stable=True).indices]
    o_j, o_i, o_d, o_ok = (a[order] for a in (owner_key, cands, d_rev, ok))
    prev = torch.cat([o_j.new_full((1,), -1), o_j[:-1]])
    idxs = torch.arange(U, dtype=torch.int64, device=dev)
    rank = idxs - torch.cummax(torch.where(o_j == prev, 0, idxs), dim=0).values

    for r in range(rounds):
        m = o_ok & (rank == r)
        oj = torch.where(m, o_j, 0).long()
        rows_d = adj_d_s[oj]  # (U, M)
        slot = torch.argmax(rows_d, dim=1)  # free slots are +inf -> the first chosen
        cur = rows_d.gather(1, slot[:, None])[:, 0]
        # never duplicate an edge the owner already holds (mutual intra-wave
        # links), never write a self-loop
        already = (adj_s[oj] == o_i[:, None]).any(dim=1)
        do = m & (o_d < cur) & ~already & (o_i != oj)
        oj_w = torch.where(do, o_j, n).long()  # losers write the sentinel row
        adj_s[oj_w, slot] = o_i.to(adj_s.dtype)
        adj_d_s[oj_w, slot] = o_d


def reverse_edge_merge(adj, adj_d, owners, cands, d_rev, ok, rounds: int):
    """Degree-capped reverse-edge scatter-with-eviction merge.

    Applies up to U candidate edges ``owners[u] -> cands[u]`` (slot distance
    ``d_rev[u] = d_build(x_cand, x_owner)``) into the fixed-degree rows of
    ``adj``/``adj_d``, evicting each owner's farthest edge when its row is
    full.  Updates are sorted by (owner, distance) and ranked within each
    owner; rank round r writes its updates (owners are distinct within a
    rank) into the farthest slot of each owner row, so per owner the merge
    keeps the M closest of {existing edges} u {candidates}.  An owner with
    more than ``rounds`` candidates keeps only the closest ``rounds``.
    Self-loops and edges already present are never written; ``ok`` masks
    padded update slots.  Returns new ``(adj, adj_d)``; the inputs are not
    modified.
    """
    n = adj.shape[0]
    adj_s, adj_d_s = _with_sentinel(adj, adj_d)
    _reverse_edge_merge_(adj_s, adj_d_s, owners, cands, d_rev, ok, rounds)
    return adj_s[:n], adj_d_s[:n]


def reverse_edge_scores(dist, consts, qc_all, flat_i, safe_j):
    """d_build(x_i, x_j) for reverse candidates: i the candidate (left), j the
    owner (query side, gathered from the prepped ``qc_all``).

    One (owner, candidate) cell per query: on the card the per-cell gather
    kernel, once per branch of the distance.
    """
    qc = tree_map(lambda a: a[safe_j.long()].contiguous(), qc_all)
    return gathered_scores(dist, flat_i[:, None], qc, consts)[:, 0]


def _wave_connect_(dist, consts, qc_all, adj_s, adj_d_s, pids, ok_pt, beam_i, beam_d, *,
                   NN: int, L: int, R: int) -> None:
    """``wave_connect`` in place on sentinel-padded (cap + 1, M) buffers."""
    cap, M_max = adj_s.shape[0] - 1, adj_s.shape[1]
    W = pids.shape[0]
    dev = pids.device
    safe_p = torch.where(ok_pt, pids, 0).to(torch.int32)
    ids = beam_i[:, :NN]  # (W, NN)
    ds = beam_d[:, :NN]

    if L > 0:
        qc = tree_map(lambda a: a[safe_p.long()], qc_all)
        # D_intra[a, b] = d_build(x_{p_b}, x_{p_a}): row a is the query
        D_intra = gathered_scores(dist, safe_p[None, :].expand(W, W), qc, consts)
        iw = torch.arange(W, device=dev)
        bad = (iw[None, :] == iw[:, None]) | ~ok_pt[None, :] | ~ok_pt[:, None]
        D_intra = torch.where(bad, INF, D_intra)
        intra_d, posi = _smallest(D_intra, L)
        intra_i = torch.where(torch.isfinite(intra_d), safe_p[posi], -1)
        cand_i = torch.cat([ids, intra_i], dim=1)
        cand_d = torch.cat([torch.where(ids >= 0, ds, INF), intra_d], dim=1)
        ds, sel = _smallest(cand_d, NN)  # beam ids and wave-mates are disjoint
        ids = torch.gather(cand_i, 1, sel)
    valid = (ids >= 0) & torch.isfinite(ds) & ok_pt[:, None]

    # -- forward edges: one scatter for the whole wave, padding to the sentinel
    row_i = torch.full((W, M_max), -1, dtype=torch.int32, device=dev)
    row_i[:, :NN] = torch.where(valid, ids, -1)
    row_d = torch.full((W, M_max), INF, dtype=torch.float32, device=dev)
    row_d[:, :NN] = torch.where(valid, ds, INF)
    dst = torch.where(ok_pt, pids, cap).long()
    adj_s[dst] = row_i
    adj_d_s[dst] = row_d

    # -- reverse edges: (owner j, candidate i, d_build(x_i, x_j)) updates
    U = W * NN
    flat_j = ids.reshape(U)
    flat_ok = valid.reshape(U)
    flat_i = safe_p.repeat_interleave(NN)
    safe_j = torch.where(flat_ok, flat_j, 0)
    d_rev = torch.where(flat_ok, reverse_edge_scores(dist, consts, qc_all, flat_i, safe_j), INF)
    _reverse_edge_merge_(adj_s, adj_d_s, flat_j, flat_i, d_rev, flat_ok, R)


def wave_connect(dist, consts, qc_all, adj, adj_d, pids, ok_pt, beam_i, beam_d, *,
                 NN: int, L: int, R: int):
    """Connect one wave of points into the graph from their beam results.

    1. intra-wave links: each point's closest L wave-mates (one exact
       (W, W) block) compete with its beam candidates for the NN forward
       slots;
    2. forward edges: one scatter of the wave's rows;
    3. reverse edges: the degree-capped ``reverse_edge_merge``.

    ``beam_i``/``beam_d`` are the wave's (W, ef) beam results; rows with
    ``ok_pt[w] == False`` are padding and write nothing.  Returns new
    ``(adj, adj_d)``; the inputs are not modified.
    """
    cap = adj.shape[0]
    adj_s, adj_d_s = _with_sentinel(adj, adj_d)
    _wave_connect_(dist, consts, qc_all, adj_s, adj_d_s, pids, ok_pt, beam_i, beam_d,
                   NN=NN, L=L, R=R)
    return adj_s[:cap], adj_d_s[:cap]


def build_swgraph_wave(dist, X, NN: int = 15, ef_construction: int = 100,
                       M_max: int | None = None, wave: int = 32, rev_rounds: int | None = None,
                       frontier: int | None = None, intra_links: int | None = None):
    """Wave-parallel SW-graph build over X under ``dist``.

    Same contract as ``build_swgraph``: returns
    ``(neighbors (n, M_max) int32, degrees (n,) int32)`` on X's device.

    ``wave``: points inserted per wave (W=1 gives the sequential builder's
    adjacency).  ``frontier``: beam candidates expanded per lock-step of the
    construction searches (1 at W=1, 4 otherwise).  ``intra_links``: how many
    of its closest wave-mates each point considers (min(NN, W-1)).
    ``rev_rounds``: reverse-edge merge rounds per wave (min(W, 8)); an owner
    row receiving more candidates in one wave keeps the closest of them.
    """
    if M_max is None:
        M_max = 2 * NN
    if M_max < NN:
        raise ValueError(f"M_max {M_max} < NN {NN}")
    n = X.shape[0]
    dev = X.device
    consts = prepped(dist.prep_scan(X))
    qc_all = prepped(dist.prep_queries(X))
    ef = max(ef_construction, NN)
    W = int(max(1, min(wave, n - 1)))
    R = int(min(W, 8 if rev_rounds is None else rev_rounds))
    T = int(frontier) if frontier is not None else (1 if W == 1 else 4)
    L = int(min(NN if intra_links is None else intra_links, W - 1))
    n_waves = -(-(n - 1) // W)
    # point 0 is the seed node (never inserted); waves cover 1..n-1, padded
    pids_all = 1 + torch.arange(n_waves * W, dtype=torch.int32, device=dev).reshape(n_waves, W)

    adj_s = torch.full((n + 1, M_max), -1, dtype=torch.int32, device=dev)
    adj_d_s = torch.full((n + 1, M_max), INF, dtype=torch.float32, device=dev)
    entries = torch.zeros((1,), dtype=torch.int32, device=dev)

    for w in range(n_waves):
        pids = pids_all[w]
        base = pids[0]  # every point of the wave sees exactly the prefix; 0-d, no sync
        ok_pt = pids < n
        qc = tree_map(lambda a: a[torch.where(ok_pt, pids, 0).long()].contiguous(), qc_all)

        def score_rows(ids, qc=qc):
            return gathered_scores(dist, ids, qc, consts)

        st = batched_beam_search(adj_s[:n], score_rows, entries, W, ef, n_active=base,
                                 frontier=T)
        _wave_connect_(dist, consts, qc_all, adj_s, adj_d_s, pids, ok_pt, st.beam_i,
                       st.beam_d, NN=NN, L=L, R=R)

    adj = adj_s[:n].contiguous()
    degrees = (adj >= 0).sum(dim=1, dtype=torch.int32)
    return adj, degrees


# ---------------------------------------------------------------------------
# shard-and-merge builds
# ---------------------------------------------------------------------------


def shard_rows(X, rank: int, world: int):
    """Rank ``rank``'s equal block of the rows of X; ``ValueError`` unless
    ``world`` divides n."""
    n = X.shape[0]
    if n % world:
        raise ValueError(
            f"build_sharded needs n ({n}) divisible by the shard count ({world}); "
            f"pad the corpus")
    return local_block(X, rank, world)[0]


def build_sharded(dist, X_local, *, NN: int = 15, builder: str = "wave", wave: int = 32,
                  ef_construction: int = 100, M_max: int | None = None, nnd_iters: int = 8,
                  cross_links: int = 4, sample_per_shard: int = 64, group=None,
                  generator: torch.Generator | None = None, sample_idx=None, nnd_draws=None):
    """Build this rank's subgraph and stitch it to the other shards.

    Call on every rank of ``group`` (default: the default process group)
    with that rank's rows ``X_local``: the shard count is the group's size
    and the shard is the rank, so rank r holds global rows
    [r n_local, (r + 1) n_local).  Each rank builds a subgraph over its rows
    (``builder`` "wave" or "nndescent"), all ranks exchange
    ``sample_per_shard`` sampled rows and their global ids (one
    ``all_gather`` each), and every local point keeps its best
    ``cross_links`` edges into OTHER shards.

    ``sample_idx`` (S,) and ``nnd_draws`` replace this rank's draws from
    ``generator`` (a test replays the JAX package's ``jax.random`` draws).
    Returns this rank's (n_local, M_max + cross_links) int32 adjacency in
    GLOBAL row ids.  ``ValueError`` when the ranks' row counts differ (n is
    not divisible by the shard count).
    """
    import torch.distributed as tdist

    from repro_torch.core.nndescent import build_nndescent

    if builder not in ("wave", "nndescent"):
        raise ValueError(f"unknown sharded builder {builder!r}; known: wave, nndescent")
    shards = tdist.get_world_size(group)
    shard = tdist.get_rank(group)
    n_local = X_local.shape[0]
    dev = X_local.device
    counts = all_gather(torch.tensor([n_local], dtype=torch.int64, device=dev), group).flatten()
    if bool((counts != n_local).any()):
        raise ValueError(
            f"build_sharded needs n ({int(counts.sum())}) divisible by the shard count "
            f"({shards}) and equal shards; the ranks hold {counts.tolist()} rows")

    if builder == "wave":
        nbrs, _ = build_swgraph_wave(dist, X_local, NN=NN, ef_construction=ef_construction,
                                     M_max=M_max, wave=wave)
    else:
        nbrs, _ = build_nndescent(dist, X_local, generator, K=NN, iters=nnd_iters,
                                  M_out=M_max, draws=nnd_draws)

    # cross-shard neighbor exchange: sample rows, gather, score, link
    S = min(sample_per_shard, n_local)
    if sample_idx is None:
        sample_idx = torch.randperm(n_local, generator=generator, device=dev)[:S]
    sample_idx = sample_idx.to(device=dev, dtype=torch.int64)
    if sample_idx.shape != (S,):
        raise ValueError(f"sample_idx has shape {tuple(sample_idx.shape)}, expected ({S},)")
    gids = (sample_idx + shard * n_local).to(torch.int32)
    all_Xs = all_gather(X_local[sample_idx], group).flatten(0, 1)
    all_gids = all_gather(gids, group).flatten(0, 1)
    # D[b, t] = d_build(sample_t, x_b): the owner-row slot convention
    D = query_distance_matrix(dist, X_local, all_Xs)
    own = torch.div(all_gids, n_local, rounding_mode="floor") == shard
    D = torch.where(own[None, :], INF, D)
    cross_d, pos = _smallest(D, min(cross_links, all_gids.shape[0]))
    cross = torch.where(torch.isfinite(cross_d), all_gids[pos], -1)
    local_global = torch.where(nbrs >= 0, nbrs + shard * n_local, -1)
    return torch.cat([local_global, cross], dim=1).to(torch.int32)
