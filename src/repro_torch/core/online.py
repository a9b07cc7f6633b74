"""Online mutable index (PyTorch port of ``repro.core.online``): incremental
inserts, tombstone deletes and compaction over capacity-padded tensors.

  insert(X_new)  new points land in the next free slots (tombstoned slots
                 first, oldest delete first) and are connected in waves of
                 W: a construction beam search against the graph of the
                 already-live points (the ``alive`` mask in place of the
                 wave builder's ``n_active`` prefix), then the wave
                 builder's intra-wave links, forward scatter and
                 degree-capped reverse-edge merge.

  delete(ids)    tombstoning only: the engine pre-marks dead nodes visited,
                 so they are never scored, never enter a beam and never
                 appear in results.  The slot joins a FIFO free list; the
                 ``killed_epoch`` stamp lets in-flight readers (the slot
                 scheduler) detect a slot that was recycled.

  compact()      drops every edge into and out of tombstones, then re-links
                 the surviving neighbours with repair beam searches over the
                 alive graph (streaming top-M merge plus reverse edges).

Every distance goes through the kernels, one launch per branch: on the card
the construction and repair searches, the intra-wave block, the reverse
edges, the edge distances of ``from_graph`` and the alive-masked search all
run ``gather_scores``; on the CPU their plain versions.

The device state (``X``, ``adj``, ``adj_d``, ``alive``, the prepped
constants) lives on the index's device and is updated in place.  ``adj`` and
``adj_d`` are views of (capacity + 1, M) buffers whose last row is the
sentinel that the wave builder's scatters write their padding into (the JAX
package's ``mode="drop"``), so a wave re-pads nothing.  The host state is
kept as ``repro`` keeps it: numpy ``killed_epoch``, a Python free list, a
``collections.deque`` of pending repairs, and the index's own
``np.random.default_rng(seed)`` for the entry refresh: an explicit
generator, and the only way the port's choices can equal ``repro``'s.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from repro_torch.core.batched_beam import _smallest, batched_beam_search
from repro_torch.core.build_engine import (_reverse_edge_merge_, _wave_connect_,
                                           reverse_edge_scores)
from repro_torch.core.distances import tree_map
from repro_torch.kernels.ops import gathered_scores, prepped

INF = float("inf")


def _set_rows(tree, ids, new) -> None:
    """``tree[ids] = new`` for every tensor of a nested dict of constants."""
    if isinstance(tree, dict):
        for key in tree:
            _set_rows(tree[key], ids, new[key])
    else:
        tree[ids] = new


# ---------------------------------------------------------------------------
# state transitions
# ---------------------------------------------------------------------------


def _edge_distances(dist, adj, consts, qc_all):
    """Slot distances d_build(x_t, x_j) for every edge j -> t of ``adj``:
    ``gather_scores`` with ids = adj, the row's own query constants (-1 -> inf)."""
    return gathered_scores(dist, adj, qc_all, consts)


def _wave_searcher(dist, adj, consts, qc_all, alive, entries, pids, ok_pt, ef, T):
    """The wave's (W, ef) construction beams over the alive graph."""
    safe_p = torch.where(ok_pt, pids, 0).long()
    qc = tree_map(lambda a: a[safe_p].contiguous(), qc_all)

    def score_rows(ids):
        return gathered_scores(dist, ids, qc, consts)

    return batched_beam_search(adj, score_rows, entries, pids.shape[0], ef, frontier=T,
                               alive=alive)


def _insert_wave(dist, adj_s, adj_d_s, consts, qc_all, alive, entries, pids, ok_pt, n_ok: int,
                 *, NN: int, ef: int, T: int, L: int, R: int) -> None:
    """Connect one wave of freshly written points against the alive graph, in place.

    The wave's points are not yet alive, so they see exactly the pre-wave
    graph (NMSLIB's relaxed insert ordering); then the wave builder's
    ``_wave_connect_`` on the sentinel-padded buffers; then the first
    ``n_ok`` points of the wave (its real ones) are marked alive.
    """
    cap = adj_s.shape[0] - 1
    st = _wave_searcher(dist, adj_s[:cap], consts, qc_all, alive, entries, pids, ok_pt, ef, T)
    _wave_connect_(dist, consts, qc_all, adj_s, adj_d_s, pids, ok_pt, st.beam_i, st.beam_d,
                   NN=NN, L=L, R=R)
    alive[pids[:n_ok].long()] = True


def _drop_edges_into(adj, adj_d, target) -> None:
    """Remove, in place, every edge whose target slot is flagged for REUSE:
    the dead point's incoming edges were computed against its vector and
    must not pass to the new point in its slot."""
    hit = (adj >= 0) & target[adj.clamp(min=0).long()]
    adj.masked_fill_(hit, -1)
    adj_d.masked_fill_(hit, INF)


def _drop_dead_edges(adj, adj_d, alive, n_total: int):
    """Remove, in place, every edge into or out of a tombstone.

    Returns ``(affected, n_dropped)`` as device tensors: ``affected`` flags
    alive nodes that pointed at a tombstone (they lost outgoing edges) or
    were pointed at by one (they lost incoming paths), the set ``compact``
    re-links.  The scatter that finds the second kind writes True into
    every target (and the sentinel), so its order does not matter.
    """
    cap = adj.shape[0]
    dev = adj.device
    dead = (torch.arange(cap, device=dev) < n_total) & ~alive
    has = adj >= 0
    tgt_dead = has & dead[adj.clamp(min=0).long()]
    points_to_dead = tgt_dead.any(dim=1)
    src_dead = dead[:, None] & has
    targets = torch.where(src_dead, adj, cap).reshape(-1).long()
    pointed = torch.zeros((cap + 1,), dtype=torch.bool, device=dev).index_fill_(0, targets, True)
    n_dropped = tgt_dead.sum(dtype=torch.int64)
    gone = tgt_dead | dead[:, None]  # tombstoned rows drop out of the graph entirely
    adj.masked_fill_(gone, -1)
    adj_d.masked_fill_(gone, INF)
    return alive & (points_to_dead | pointed[:cap]), n_dropped


def _repair_wave(dist, adj_s, adj_d_s, consts, qc_all, alive, entries, pids, ok_pt,
                 *, NN: int, ef: int, T: int, R: int) -> None:
    """Re-link one wave of tombstone-adjacent nodes over the alive graph, in place.

    Each node u searches the alive graph, merges the NN best fresh
    candidates (u itself voided) with its surviving edges (streaming
    top-M_max, the lower position first on ties as ``lax.top_k``), and
    re-applies reverse edges so nodes that lost incoming paths regain them.
    """
    cap, M_max = adj_s.shape[0] - 1, adj_s.shape[1]
    adj, adj_d = adj_s[:cap], adj_d_s[:cap]
    W = pids.shape[0]
    safe_p = torch.where(ok_pt, pids, 0)
    sp = safe_p.long()
    st = _wave_searcher(dist, adj, consts, qc_all, alive, entries, pids, ok_pt, ef, T)
    # the repair query u is alive, so the beam finds u itself (self-distance
    # ~0): take NN + 1 candidates and void the self-match before keeping NN
    take = min(NN + 1, ef)
    cand_i = st.beam_i[:, :take]
    cand_d = torch.where(cand_i == safe_p[:, None], INF, st.beam_d[:, :take])
    cand_d, sel = _smallest(cand_d, NN)
    cand_i = torch.gather(cand_i, 1, sel)
    row_i = adj[sp]  # (W, M_max) surviving edges (post drop)
    dup = (cand_i[:, :, None] == row_i[:, None, :]).any(dim=2)
    cand_ok = (cand_i >= 0) & torch.isfinite(cand_d) & ~dup & ok_pt[:, None]
    cand_d = torch.where(cand_ok, cand_d, INF)

    # merged row: streaming top-M_max of {surviving edges} u {candidates}
    all_d = torch.cat([adj_d[sp], cand_d], dim=1)
    all_i = torch.cat([row_i, torch.where(cand_ok, cand_i, -1)], dim=1)
    new_d, sel2 = _smallest(all_d, M_max)
    fin = torch.isfinite(new_d)
    dst = torch.where(ok_pt, pids, cap).long()
    adj_s[dst] = torch.where(fin, torch.gather(all_i, 1, sel2), -1)
    adj_d_s[dst] = torch.where(fin, new_d, INF)

    # reverse edges: u into its fresh candidates, the insert-time semantics
    flat_j = cand_i.reshape(W * NN)
    flat_ok = cand_ok.reshape(W * NN)
    flat_i = safe_p.repeat_interleave(NN)
    safe_j = torch.where(flat_ok, flat_j, 0)
    d_rev = reverse_edge_scores(dist, consts, qc_all, flat_i, safe_j)
    _reverse_edge_merge_(adj_s, adj_d_s, flat_j, flat_i, d_rev, flat_ok, R)


def _masked_search(dist, Q, consts, adj, alive, entries, k: int, ef: int, T: int,
                   compact: int, adaptive: bool = False, patience: int = 1):
    """Alive-masked batched beam search over the capacity-padded graph."""
    qc = prepped(dist.prep_queries(Q))

    def score_rows(ids):
        return gathered_scores(dist, ids, qc, consts)

    st = batched_beam_search(adj, score_rows, entries, Q.shape[0], ef, frontier=T,
                             compact=compact, alive=alive, adaptive=adaptive, patience=patience)
    return st.beam_d[:, :k], st.beam_i[:, :k], st.n_evals, st.hops


# ---------------------------------------------------------------------------
# the mutable index
# ---------------------------------------------------------------------------


class OnlineIndex:
    """A mutable neighborhood-graph index over capacity-padded tensors.

    State: ``X (capacity, m)``, ``adj``/``adj_d (capacity, M_max)``,
    ``alive (capacity,) bool`` on the index's device, and the host-side
    high-water mark ``n_total`` (slots 0..n_total-1 have been inserted at
    some point; a slot is live iff ``alive``).  Tombstoned slots land on a
    FIFO free list and are reused before the index grows into fresh suffix
    capacity, so sustained +N/-N churn runs forever at constant capacity.
    """

    def __init__(self, X, adj, adj_d, alive, n_total, build_dist, search_dist, entries, *,
                 NN, ef_construction=100, wave=32, frontier=4, rev_rounds=None, seed=0,
                 spec=None):
        cap, M_max = adj.shape
        if X.shape[0] != cap or alive.shape != (cap,):
            raise ValueError(f"X {tuple(X.shape)} and alive {tuple(alive.shape)} do not match "
                             f"the adjacency's {cap} slots")
        dev = X.device
        self.spec = spec  # the RetrievalSpec this index serves, for self-description
        self.build_dist = build_dist
        self.search_dist = search_dist if search_dist is not None else build_dist
        self.capacity = int(cap)
        self.M_max = int(M_max)
        self.NN = int(min(NN, M_max))
        self.ef_construction = int(max(ef_construction, self.NN))
        self.wave = int(max(1, wave))
        self.frontier = int(max(1, frontier))
        self.rev_rounds = int(min(self.wave, 8 if rev_rounds is None else rev_rounds))
        self.X = X.contiguous()
        # (cap + 1, M) buffers: the last row is the scatters' sentinel
        self._adj_s = torch.cat([adj.to(torch.int32), adj.new_full((1, M_max), -1,
                                                                   dtype=torch.int32)])
        self._adj_d_s = torch.cat([adj_d.float(), adj_d.new_full((1, M_max), INF,
                                                                 dtype=torch.float32)])
        self.alive = alive.to(torch.bool).clone()
        self.n_total = int(n_total)
        self.consts = prepped(build_dist.prep_scan(self.X))
        self.qc_all = prepped(build_dist.prep_queries(self.X))
        if isinstance(entries, torch.Tensor):
            entries = entries.cpu().numpy()
        self.entries = torch.as_tensor(np.asarray(entries, np.int32), device=dev)
        self._rng = np.random.default_rng(seed)
        self._sconsts_cache = None  # search-dist constants, maintained row by row
        self._free: list[int] = []  # tombstoned slots available for reuse (FIFO)
        # mutation epoch: bumped per delete batch; killed_epoch[s] is the epoch
        # slot s was last tombstoned (read by the slot scheduler)
        self.mutation_epoch: int = 0
        self.killed_epoch = np.zeros((cap,), np.int64)
        # incremental compaction (compact_slice): nodes awaiting a repair wave,
        # and whether tombstone edges await a drop pass
        self._repair_pending: collections.deque = collections.deque()
        self._compact_dirty = False

    @property
    def adj(self):
        return self._adj_s[:self.capacity]

    @property
    def adj_d(self):
        return self._adj_d_s[:self.capacity]

    # ------------------------------------------------------------- construct

    @classmethod
    def from_graph(cls, X, neighbors, build_dist, search_dist=None, *, capacity=None,
                   entries=None, NN=None, ef_construction=100, wave=32, frontier=4,
                   rev_rounds=None, seed=0, spec=None):
        """Wrap a built ``(X, neighbors)`` graph in a mutable index on X's device.

        ``capacity`` (default ``2 * n``) bounds the number of SIMULTANEOUSLY
        live points (slots are recycled, see ``insert``).  Slot distances are
        recomputed once under the build distance: one ``gather_scores``
        launch per branch at (capacity, M).
        """
        n, M_max = neighbors.shape
        cap = int(capacity) if capacity is not None else 2 * n
        if cap < n:
            raise ValueError(f"capacity {cap} < current database size {n}")
        dev = X.device
        X_pad = torch.zeros((cap, X.shape[1]), dtype=X.dtype, device=dev)
        X_pad[:n] = X
        adj = torch.full((cap, M_max), -1, dtype=torch.int32, device=dev)
        adj[:n] = neighbors
        alive = torch.zeros((cap,), dtype=torch.bool, device=dev)
        alive[:n] = True
        if entries is None:
            entries = np.zeros((1,), np.int32)
        self = cls(X_pad, adj, torch.full((cap, M_max), INF, device=dev), alive, n,
                   build_dist, search_dist, entries, NN=NN if NN is not None else M_max // 2,
                   ef_construction=ef_construction, wave=wave, frontier=frontier,
                   rev_rounds=rev_rounds, seed=seed, spec=spec)
        self.adj_d.copy_(_edge_distances(build_dist, self.adj, self.consts, self.qc_all))
        return self

    # ------------------------------------------------------------ properties

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def free_slots(self) -> int:
        """Insertable slots: untouched suffix capacity + reusable tombstones."""
        return self.capacity - self.n_total + len(self._free)

    # ------------------------------------------------------------- mutation

    def _upload_waves(self, ids: np.ndarray, W: int):
        """(n_waves, W) int32 slot ids on the device, padded with ``capacity``:
        one host-to-device copy for the whole loop."""
        n_waves = -(-len(ids) // W)
        pids = np.full((n_waves * W,), self.capacity, np.int32)
        pids[:len(ids)] = ids
        return torch.as_tensor(pids.reshape(n_waves, W), device=self.X.device)

    def insert(self, X_new) -> np.ndarray:
        """Insert new points; returns their assigned slot ids (numpy int64).

        Ids are ARENA ids: a deleted id's slot is recycled by later inserts,
        after which the id names the NEW occupant (``killed_epoch`` records
        the tombstoning epoch).  Tombstoned slots are reused first (oldest
        delete first), their stale incoming edges dropped; the remainder
        grows into suffix capacity.  ``ValueError`` when the batch does not
        fit in ``free_slots``.  The wave loop makes no host sync of its own:
        entry liveness is read once before it, and ``n_total`` advances from
        the host-side ids.
        """
        X_new = torch.as_tensor(X_new, device=self.X.device).to(self.X.dtype)
        if X_new.ndim == 1:
            X_new = X_new[None, :]
        k = int(X_new.shape[0])
        if k == 0:
            return np.zeros((0,), np.int64)
        if k > self.free_slots:
            raise ValueError(
                f"insert of {k} points overflows capacity {self.capacity} "
                f"(n_total={self.n_total}, reusable tombstones={len(self._free)}); "
                f"grow the index with a larger capacity or compact offline")
        n_reuse = min(k, len(self._free))
        reused = np.asarray(self._free[:n_reuse], np.int64)
        self._free = self._free[n_reuse:]
        fresh = np.arange(self.n_total, self.n_total + (k - n_reuse))
        ids = np.concatenate([reused, fresh]).astype(np.int64)
        W = min(self.wave, k)
        pids_all = self._upload_waves(ids, W)
        ids_t = pids_all.reshape(-1)[:k].long()
        if n_reuse:
            target = torch.zeros((self.capacity,), dtype=torch.bool, device=self.X.device)
            target[ids_t[:n_reuse]] = True
            _drop_edges_into(self.adj, self.adj_d, target)
        self.X[ids_t] = X_new
        _set_rows(self.consts, ids_t, prepped(self.build_dist.prep_scan(X_new)))
        _set_rows(self.qc_all, ids_t, prepped(self.build_dist.prep_queries(X_new)))
        if self._sconsts_cache is not None:
            # the search constants follow row by row instead of re-prepping
            # all `capacity` rows on the next query
            _set_rows(self._sconsts_cache, ids_t, prepped(self.search_dist.prep_scan(X_new)))

        T = max(1, min(self.frontier, self.ef_construction))
        L = min(self.NN, W - 1)
        # one host read up front: in steady state (some entry alive, which
        # inserts never undo) the wave loop runs with no per-wave sync; only
        # the delete-all recovery path re-checks until it adopts a live entry
        entries_ok = self._entries_alive()
        for w, lo in enumerate(range(0, k, W)):
            chunk = ids[lo:lo + W]
            pids = pids_all[w]
            if not entries_ok:
                # every entry is tombstoned (e.g. after delete-all): adopt
                # whatever is alive; n_total already covers earlier waves
                self._refresh_entries()
                entries_ok = self._entries_alive()
            _insert_wave(self.build_dist, self._adj_s, self._adj_d_s, self.consts,
                         self.qc_all, self.alive, self.entries, pids, pids < self.capacity,
                         len(chunk), NN=self.NN, ef=self.ef_construction, T=T, L=L,
                         R=self.rev_rounds)
            # the high-water mark (reused slots sit below it already)
            self.n_total = max(self.n_total, int(chunk.max()) + 1)
        self._refresh_entries()
        return ids

    def delete(self, ids) -> int:
        """Tombstone points by id; returns how many were newly deleted.

        Dead nodes stop appearing in results at once; their edges keep their
        graph slots until ``compact()``, but the slots themselves join the
        free list.  Unknown and already-dead ids are ignored.
        """
        ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
        ids = ids[(ids >= 0) & (ids < self.n_total)]
        if len(ids) == 0:
            return 0
        ids_t = torch.as_tensor(ids, device=self.X.device)
        newly = self.alive[ids_t].cpu().numpy()
        was_alive = int(newly.sum())
        if was_alive:
            self.alive[ids_t] = False
            self._free.extend(int(i) for i in ids[newly])
            self.mutation_epoch += 1
            self.killed_epoch[ids[newly]] = self.mutation_epoch
            self._compact_dirty = True
            self._refresh_entries()
        return was_alive

    def _repair(self, nodes) -> None:
        """Repair waves of ``self.wave`` (fewer if ``nodes`` is shorter) over ``nodes``."""
        W = min(self.wave, len(nodes))
        T = max(1, min(self.frontier, self.ef_construction))
        waves = self._upload_waves(nodes, W)
        for pids in waves:
            _repair_wave(self.build_dist, self._adj_s, self._adj_d_s, self.consts, self.qc_all,
                         self.alive, self.entries, pids, pids < self.capacity, NN=self.NN,
                         ef=self.ef_construction, T=T, R=self.rev_rounds)

    def compact(self) -> dict:
        """Repair the graph around tombstones (no full rebuild).

        Drops every edge into and out of dead nodes, then re-links each
        surviving node that was adjacent to a tombstone.  Tombstones stay on
        the free list; repair debt left by partly drained ``compact_slice``
        calls is folded in and cleared.
        """
        affected, n_dropped = _drop_dead_edges(self.adj, self.adj_d, self.alive, self.n_total)
        affected_np = affected.cpu().numpy()
        if self._repair_pending:
            # nodes whose dead edges an earlier slice dropped are not flagged
            # again by this drop pass: take them from the slice queue
            alive_np = self.alive.cpu().numpy()
            for u in self._repair_pending:
                if alive_np[u]:
                    affected_np[u] = True
            self._repair_pending.clear()
        self._compact_dirty = False
        affected_ids = np.flatnonzero(affected_np)
        stats = {"tombstones": self.n_total - self.n_alive,
                 "dead_edges_dropped": int(n_dropped),
                 "repaired": int(len(affected_ids))}
        if len(affected_ids):
            self._repair(affected_ids)
        return stats

    @property
    def compaction_debt(self) -> int:
        """Outstanding incremental-compaction work: queued repair nodes, plus
        one while tombstone edges still await a drop pass."""
        return len(self._repair_pending) + (1 if self._compact_dirty else 0)

    def compact_slice(self, max_nodes=None) -> dict:
        """One bounded increment of ``compact()``, the scheduler's idle-tick hook.

        The first slice after new tombstones runs ``compact()``'s drop pass
        and queues the affected nodes; each later slice repairs up to
        ``max_nodes`` (default ``self.wave``) of them in one repair wave.
        Draining the queue at ``max_nodes=self.wave`` with no mutation in
        between leaves the adjacency equal to one ``compact()``.  Returns
        ``{"repaired", "remaining", "dead_edges_dropped"}``.
        """
        W = max(1, int(min(self.wave, self.wave if max_nodes is None else max_nodes)))
        dropped = 0
        if not self._repair_pending and self._compact_dirty:
            affected, n_dropped = _drop_dead_edges(self.adj, self.adj_d, self.alive,
                                                   self.n_total)
            self._repair_pending.extend(int(u) for u in np.flatnonzero(affected.cpu().numpy()))
            self._compact_dirty = False
            dropped = int(n_dropped)
        if not self._repair_pending:
            return {"repaired": 0, "remaining": 0, "dead_edges_dropped": dropped}
        alive_np = self.alive.cpu().numpy()
        chunk: list[int] = []
        while self._repair_pending and len(chunk) < W:
            u = self._repair_pending.popleft()
            if alive_np[u]:  # a node tombstoned since the drop pass needs no repair
                chunk.append(u)
        if chunk:
            T = max(1, min(self.frontier, self.ef_construction))
            pids = self._upload_waves(np.asarray(chunk), W)[0]
            _repair_wave(self.build_dist, self._adj_s, self._adj_d_s, self.consts, self.qc_all,
                         self.alive, self.entries, pids, pids < self.capacity, NN=self.NN,
                         ef=self.ef_construction, T=T, R=self.rev_rounds)
        return {"repaired": len(chunk), "remaining": len(self._repair_pending),
                "dead_edges_dropped": dropped}

    # -------------------------------------------------------------- serving

    def _search_consts(self):
        if self.search_dist is self.build_dist:
            return self.consts
        if self._sconsts_cache is None:
            # prepped in full once; insert() then keeps the touched rows up to
            # date (deletes and compaction change no row)
            self._sconsts_cache = prepped(self.search_dist.prep_scan(self.X))
        return self._sconsts_cache

    def searcher(self, k: int, ef_search: int, frontier: int = 2, compact: int = 32,
                 adaptive: bool = False, patience: int = 1):
        """Alive-masked batched searcher: ``search(Q) -> (d, ids, evals, hops)``.

        The returned callable reads the CURRENT index state on every call.
        Ids are slot ids; rows with fewer than k alive reachable points pad
        with (-1, inf).
        """
        ef = max(ef_search, k)
        T = max(1, min(frontier, ef))

        def search(Q):
            return _masked_search(self.search_dist, Q, self._search_consts(), self.adj,
                                  self.alive, self.entries, k=k, ef=ef, T=T, compact=compact,
                                  adaptive=adaptive, patience=patience)

        return search

    def search(self, Q, k: int = 10, ef_search: int = 64, frontier: int = 2):
        return self.searcher(k, ef_search, frontier)(Q)

    # ------------------------------------------------------------ internals

    def _entries_alive(self) -> bool:
        """At least one entry point is alive (ONE host sync: callers hoist it
        out of wave loops, see ``insert``)."""
        return bool(self.alive[self.entries.long()].any())

    def _refresh_entries(self) -> None:
        """Keep entry points alive: dead entries are replaced by random live
        nodes drawn from the index's generator; with nothing alive the
        entries stay tombstoned and the engine returns empty results."""
        E = int(self.entries.shape[0])
        entries_np = self.entries.cpu().numpy()
        # steady state: an E-element gather, not the whole mask on the host
        entry_alive = self.alive[self.entries.long()].cpu().numpy()
        if entry_alive.all() and len(set(entries_np.tolist())) == E:
            return
        alive_np = self.alive.cpu().numpy()
        keep = []
        for e, ok in zip(entries_np.tolist(), entry_alive.tolist()):
            if ok and e not in keep:
                keep.append(int(e))
        if len(keep) < E:
            alive_ids = np.flatnonzero(alive_np[:self.n_total])
            pool = np.setdiff1d(alive_ids, np.asarray(keep, np.int64))
            if len(pool):
                picked = self._rng.choice(len(pool), size=min(E - len(keep), len(pool)),
                                          replace=False)
                keep += [int(pool[j]) for j in np.sort(picked)]
        while len(keep) < E:
            # pad with tombstoned slots, masked to (inf, -1) by the engine
            dead_ids = np.flatnonzero(~alive_np[:max(self.n_total, 1)])
            keep.append(int(dead_ids[0]) if len(dead_ids) else 0)
        self.entries = torch.as_tensor(np.asarray(keep[:E], np.int32), device=self.X.device)
