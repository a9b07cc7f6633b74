"""High-level ANN index API (PyTorch port of ``repro.core.index``).

    spec = RetrievalSpec(distance="kl", builder="nndescent", ef_search=96)
    idx = ANNIndex.build(X, spec=spec)      # X on the card (or the CPU)
    dists, ids, n_evals, hops = idx.searcher()(Q)

The historical keyword arguments (``index_sym``/``query_sym`` strings and
the loose builder knobs) still build through ``repro``'s shim, which folds
the arguments passed into the equivalent spec (a ``DeprecationWarning`` on
the two strings); the result is the ``spec=`` build's.

Builders: NN-descent, and SW-graph with the wave-parallel or the
sequential engine, under any build policy (the graph-construction
distance).  Engines: the batched lock-step engine and the single-query
reference engine, under the original distance, or under a bound search
policy whose k_c candidates are re-ranked under the original distance
(the paper's full-symmetrization scenario).  With a ``capacity`` (in the
spec, or on the first mutation) the index is MUTABLE: ``insert``,
``delete`` and ``compact`` go through ``core.online.OnlineIndex`` and the
batched searcher serves the live, tombstone-masked graph.  ``scheduler``
returns the continuous-batching ``core.scheduler.SlotScheduler`` over the
index, static or mutable.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from repro_torch.core.batched_beam import make_step_searcher, select_entries
from repro_torch.core.beam_search import make_batched_searcher
from repro_torch.core.build_engine import build_swgraph_wave
from repro_torch.core.filter_refine import rerank
from repro_torch.core.nndescent import build_nndescent
from repro_torch.core.online import OnlineIndex
from repro_torch.core.scheduler import GraphView, Rung, SlotScheduler
from repro_torch.core.spec import RetrievalSpec
from repro_torch.core.swgraph import build_swgraph
from repro_torch.core.trace import span
from repro_torch.kernels.ops import prepped


def bind_policies(spec: RetrievalSpec, dist, X, natural: Optional[Callable] = None):
    """``(build_policy, search_policy, build_dist, search_dist)`` for ``spec``
    over the base distance ``dist``.

    Data-calibrated parameters (rankblend without tau) resolve against X
    once; the spec itself stays as written.  ``search_dist`` is ``dist``
    unless the spec reranks.
    """
    build_policy = spec.build_policy.resolve(dist, X)
    search_policy = spec.search_policy.resolve(dist, X)
    build_dist = build_policy.bind(dist, natural=natural)
    search_dist = search_policy.bind(dist, natural=natural) if spec.needs_rerank else dist
    return build_policy, search_policy, build_dist, search_dist


def _legacy_spec(index_sym, query_sym, builder, build_engine, wave, build_frontier, NN,
                 ef_construction, M_max, nnd_iters, n_entries, capacity) -> RetrievalSpec:
    """Deprecation shim: the old loose keyword arguments folded into one
    spec.  Only the arguments passed are forwarded, so the spec's own field
    defaults apply once."""
    if index_sym is not None or query_sym is not None:
        warnings.warn(
            "index_sym/query_sym string kwargs are deprecated; pass a "
            "RetrievalSpec (spec=...) with build_policy/search_policy instead",
            DeprecationWarning,
            stacklevel=3,
        )
    passed = {
        "build_policy": index_sym,
        "search_policy": query_sym,
        "builder": builder,
        "build_engine": build_engine,
        "wave": wave,
        "build_frontier": build_frontier,
        "NN": NN,
        "ef_construction": ef_construction,
        "M_max": M_max,
        "nnd_iters": nnd_iters,
        "n_entries": n_entries,
        "capacity": capacity,
    }
    return RetrievalSpec(**{k: v for k, v in passed.items() if v is not None})


@dataclasses.dataclass
class ANNIndex:
    """A built neighborhood-graph index over a database X.

    With a ``capacity`` (set at build time or on the first mutation) the
    index becomes mutable through ``online``, an ``OnlineIndex``.
    """

    X: torch.Tensor
    neighbors: torch.Tensor  # (n, M) int32
    dist: object  # original distance
    search_dist: object  # distance guiding the beam (may equal dist)
    query_sym: str
    entries: Optional[torch.Tensor] = None  # (E,) int32 beam entry points
    build_info: dict = dataclasses.field(default_factory=dict)
    build_dist: object = None  # index-time distance
    capacity: Optional[int] = None  # mutable-index slot budget
    online: Optional[OnlineIndex] = None  # created on the first mutation
    spec: RetrievalSpec = dataclasses.field(default_factory=RetrievalSpec)

    @property
    def entry(self) -> int:
        """Primary entry node (the medoid when entries were selected)."""
        return 0 if self.entries is None else int(self.entries[0])

    @classmethod
    def build(cls, X, dist=None, *, spec: Optional[RetrievalSpec] = None,
              index_sym: Optional[str] = None, query_sym: Optional[str] = None,
              builder: Optional[str] = None, build_engine: Optional[str] = None,
              wave: Optional[int] = None, build_frontier: Optional[int] = None,
              NN: Optional[int] = None, ef_construction: Optional[int] = None,
              M_max: Optional[int] = None, nnd_iters: Optional[int] = None,
              n_entries: Optional[int] = None, capacity: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              natural: Optional[Callable] = None) -> "ANNIndex":
        """Build an index from a ``RetrievalSpec``, or from the legacy keyword
        arguments (``index_sym`` ... ``capacity``, folded into the equivalent
        spec; ``spec.distance`` then records ``dist.name`` when ``dist`` is
        given).  Passing both raises ``ValueError``.

        Args:
            X: (n, m) float32 database on the device the index should live on.
            dist: optional explicit base distance (e.g. a ``ViewedDistance``
                such as BM25, which the registry cannot name); otherwise
                ``spec.distance``.
            spec: the scenario (defaults to ``RetrievalSpec()``).  A
                rankblend policy without tau is calibrated on X; the
                concrete policies land in ``build_info["index_sym_resolved"]``
                / ``["query_sym_resolved"]``.
            generator: ``torch.Generator`` on X's device for the NN-descent
                and entry-point draws (a fixed seed 0 when omitted); the
                SW-graph builders draw nothing.
            natural: optional callable returning the distance-specific
                natural symmetrization (Eq. 4), for the ``natural`` policy.

        Recorded as the span ``index.build`` (``core.trace``).
        """
        with span("index.build"):
            legacy = (index_sym, query_sym, builder, build_engine, wave, build_frontier, NN,
                      ef_construction, M_max, nnd_iters, n_entries, capacity)
            if spec is None:
                spec = _legacy_spec(*legacy)
                if dist is not None and getattr(dist, "name", None):
                    # record the distance actually run, so build_info and its
                    # fingerprint describe the scenario
                    spec = spec.replace(distance=dist.name)
            elif any(v is not None for v in legacy):
                raise ValueError("pass EITHER spec=... or the legacy kwargs, not both "
                                 "(use spec.replace(...) to tweak a spec)")
            if dist is None:
                dist = spec.base_distance()
            if generator is None:
                generator = torch.Generator(device=X.device).manual_seed(0)
            build_policy, search_policy, build_dist, search_dist = bind_policies(
                spec, dist, X, natural)

            if spec.builder == "swgraph" and spec.build_engine == "wave":
                neighbors, degrees = build_swgraph_wave(
                    build_dist, X, NN=spec.NN, ef_construction=spec.ef_construction,
                    M_max=spec.M_max, wave=spec.wave, frontier=spec.build_frontier,
                )
            elif spec.builder == "swgraph":
                neighbors, degrees = build_swgraph(
                    build_dist, X, NN=spec.NN, ef_construction=spec.ef_construction,
                    M_max=spec.M_max,
                )
            else:
                neighbors, degrees = build_nndescent(
                    build_dist, X, generator, K=spec.NN, iters=spec.nnd_iters, M_out=spec.M_max,
                )
            entries = select_entries(search_dist, X, n_entries=spec.n_entries, generator=generator)
            idx = cls(
                X=X,
                neighbors=neighbors,
                dist=dist,
                search_dist=search_dist,
                query_sym=str(spec.search_policy),
                entries=entries,
                build_info=make_build_info(spec, degrees, build_policy, search_policy),
                build_dist=build_dist,
                capacity=spec.capacity,
                spec=spec,
            )
            if spec.capacity is not None:
                idx.ensure_online()
            return idx

    # ----------------------------------------------------------------- online

    def ensure_online(self, capacity: Optional[int] = None) -> OnlineIndex:
        """Convert to a mutable index (idempotent); the slot budget is
        ``capacity``, else the index's, else 2 n.  See ``OnlineIndex``."""
        if self.online is None:
            cap = capacity or self.capacity or 2 * int(self.X.shape[0])
            self.online = OnlineIndex.from_graph(
                self.X, self.neighbors, self.build_dist or self.dist, self.search_dist,
                capacity=cap, entries=self.entries,
                NN=self.build_info.get("NN") or self.neighbors.shape[1] // 2,
                ef_construction=self.build_info.get("ef_construction") or 100,
                wave=self.build_info.get("wave") or 32, spec=self.spec)
            self.capacity = self.online.capacity
        return self.online

    def insert(self, X_new):
        """Insert points into the live graph; returns their slot ids (a deleted
        id's slot may be recycled, see ``OnlineIndex.insert``)."""
        ids = self.ensure_online().insert(X_new)
        self._sync_from_online()
        return ids

    def delete(self, ids) -> int:
        """Tombstone points by id; returns how many were newly deleted."""
        n = self.ensure_online().delete(ids)
        # tombstoning changes only the alive mask: resync just the entries
        self.entries = self.online.entries
        return n

    def compact(self) -> dict:
        """Re-link the graph around tombstones (no full rebuild)."""
        stats = self.ensure_online().compact()
        self._sync_from_online()
        return stats

    def _sync_from_online(self) -> None:
        """Mirror the mutable state so X/neighbors stay inspectable (views that
        include tombstoned rows: serving goes through the online searcher)."""
        o = self.online
        self.X = o.X[:o.n_total]
        self.neighbors = o.adj[:o.n_total]
        self.entries = o.entries

    # ----------------------------------------------------------------- search

    def _check_search_policy(self, spec: Optional[RetrievalSpec]):
        if spec is not None and str(spec.search_policy) != self.query_sym:
            raise ValueError(
                f"spec.search_policy {str(spec.search_policy)!r} does not match this "
                f"index's bound search policy {self.query_sym!r}; rebuild with "
                f"ANNIndex.build(X, spec=spec) to change the search scenario")

    def searcher(self, k: Optional[int] = None, ef_search: Optional[int] = None,
                 k_c: Optional[int] = None, engine: Optional[str] = None,
                 frontier: Optional[int] = None, *, adaptive: Optional[bool] = None,
                 patience: Optional[int] = None, spec: Optional[RetrievalSpec] = None):
        """Return ``search(Q) -> (dists, ids, n_evals, hops)``.

        Knobs resolve spec-first: explicit arguments override ``spec``
        (default: the spec the index was built with).  Under a rerank spec
        (``search_policy != none``) the beam runs under the bound search
        distance with ef >= k_c, and its k_c candidates are re-ranked under
        the original distance (counted into n_evals).
        """
        self._check_search_policy(spec)
        spec = spec if spec is not None else self.spec
        k = spec.k if k is None else k
        ef_search = spec.ef_search if ef_search is None else ef_search
        engine = spec.engine if engine is None else engine
        frontier = spec.frontier if frontier is None else frontier
        adaptive = spec.adaptive if adaptive is None else adaptive
        patience = spec.patience if patience is None else patience
        k_c = spec.k_c if k_c is None else k_c
        if engine not in ("batched", "reference"):
            raise ValueError(f"unknown engine {engine!r}; known: batched, reference")
        if engine == "reference" and adaptive:
            raise ValueError("adaptive frontier requires engine='batched'")
        if self.query_sym == "none":
            return self._make_searcher(self.dist, max(ef_search, k), k, engine, frontier,
                                       adaptive, patience)

        k_c = k_c or max(ef_search, k)
        inner = self._make_searcher(self.search_dist, max(ef_search, k_c), k_c, engine,
                                    frontier, adaptive, patience)
        if self.online is not None:
            # the live rows, prepped on every call: inserts rewrite them
            online = self.online

            def search(Q):
                _, cand, n_evals, hops = inner(Q)
                d, ids = rerank(self.dist, Q, online.X, cand, k)
                return d, ids, n_evals + k_c, hops

            return search
        consts = prepped(self.dist.prep_scan(self.X))  # the original distance, prepped once

        def search(Q):
            _, cand, n_evals, hops = inner(Q)
            d, ids = rerank(self.dist, Q, self.X, cand, k, consts=consts)
            return d, ids, n_evals + k_c, hops

        return search

    def _make_searcher(self, dist, ef: int, k: int, engine: str, frontier: int,
                       adaptive: bool, patience: int):
        if self.online is not None:
            if engine != "batched":
                raise ValueError(f"engine {engine!r} does not support the online mutable "
                                 f"index; use engine='batched'")
            return self.online.searcher(k, ef, frontier=frontier, adaptive=adaptive,
                                        patience=patience)
        if engine == "reference":
            return make_batched_searcher(dist, self.neighbors, self.X, ef, k, entry=self.entry)
        return make_step_searcher(dist, self.neighbors, self.X, ef, k, entries=self.entries,
                                  frontier=frontier, adaptive=adaptive, patience=patience)

    def search(self, Q, k: Optional[int] = None, ef_search: Optional[int] = None,
               k_c: Optional[int] = None, engine: Optional[str] = None,
               frontier: Optional[int] = None):
        """One-shot ``searcher(...)(Q)`` with the same knob resolution."""
        return self.searcher(k, ef_search, k_c, engine=engine, frontier=frontier)(Q)

    # ---------------------------------------------------------------- serving

    def scheduler(self, k: Optional[int] = None, ef_search: Optional[int] = None, *,
                  slots: Optional[int] = None, frontier: Optional[int] = None,
                  adaptive: Optional[bool] = None, patience: Optional[int] = None,
                  steps_per_sync: Optional[int] = None, compact: Optional[int] = None,
                  k_c: Optional[int] = None, spec: Optional[RetrievalSpec] = None,
                  ladder: Optional[list] = None, slo_ms: Optional[float] = None,
                  shed: bool = True, tenant_weights: Optional[dict] = None, background=False,
                  service_prior: Optional[float] = None,
                  admission_margin: float = 1.0) -> SlotScheduler:
        """Continuous-batching slot scheduler over this index (``core.scheduler``).

        Knobs resolve spec-first (``frontier`` defaults to
        ``spec.sched_frontier``).  On a mutable index the scheduler reads the
        live graph every tick and re-masks retired results against the
        current ``alive`` set; a scheduler made before the index became
        mutable raises on its next tick.  A rerank spec runs the beams under
        the bound search policy and re-ranks each retired request's k_c
        candidates under the original distance, as ``searcher()`` does.
        ``ladder`` (a ``spec.demotion_ladder`` list, rung 0 the serving
        point) becomes the scheduler's ``Rung``s, cost scales the ef ratio;
        ``slo_ms``, ``shed``, ``service_prior`` and ``admission_margin``
        configure admission, ``tenant_weights`` the DRR fairness.
        ``background=True`` hangs one ``OnlineIndex.compact_slice`` on each
        idle tick (a mutable index only; a callable is used as the hook).
        """
        self._check_search_policy(spec)
        spec = spec if spec is not None else self.spec
        k = spec.k if k is None else k
        ef_search = spec.ef_search if ef_search is None else ef_search
        slots = spec.slots if slots is None else slots
        frontier = spec.sched_frontier if frontier is None else frontier
        adaptive = spec.adaptive if adaptive is None else adaptive
        patience = spec.patience if patience is None else patience
        steps_per_sync = spec.steps_per_sync if steps_per_sync is None else steps_per_sync
        compact = spec.compact if compact is None else compact

        rerank_fn = None
        if self.query_sym != "none":
            k_c = k_c or spec.k_c or max(ef_search, k)
            ef = max(ef_search, k_c)
            beam_dist = self.search_dist
            orig, online = self.dist, self.online
            consts = None if online is not None else prepped(orig.prep_scan(self.X))

            def rerank_fn(q, cand):
                if online is not None:
                    return rerank(orig, q, online.X, cand, k)
                return rerank(orig, q, self.X, cand, k, consts=consts)
        else:
            k_c = None
            ef = max(ef_search, k)
            beam_dist = self.dist

        if self.online is not None:
            online = self.online

            def graph_fn():
                return GraphView(online.adj, online._search_consts(), online.alive,
                                 online.entries, epoch=online.mutation_epoch,
                                 killed_epoch=online.killed_epoch)
        else:
            entries = (self.entries if self.entries is not None
                       else torch.zeros((1,), dtype=torch.int32, device=self.X.device))
            view = GraphView(self.neighbors, prepped(beam_dist.prep_scan(self.X)), None,
                             entries)

            def graph_fn():
                if self.online is not None:
                    # the slot state is shaped for the frozen graph and cannot
                    # adopt the capacity-padded arrays; serving the stale
                    # snapshot would surface deleted points
                    raise RuntimeError("index became mutable after this scheduler was "
                                       "created; create a new scheduler (it will read the "
                                       "live graph)")
                return view

        rungs = None
        if ladder is not None:
            rungs = []
            for s in ladder:
                self._check_search_policy(s)
                if s.k != k:
                    raise ValueError(f"ladder spec k {s.k} != serving k {k}; every rung must "
                                     f"honor the same result contract")
                if s.k_c != spec.k_c:
                    raise ValueError(f"ladder spec k_c {s.k_c} != serving k_c {spec.k_c}; "
                                     f"rerank width cannot vary per rung")
                r_ef = min(max(s.ef_search, k_c or k), ef)
                name = f"ef{s.ef_search}" + ("+adaptive" if s.adaptive else "")
                rungs.append(Rung(ef=r_ef, adaptive=bool(s.adaptive), name=name,
                                  scale=r_ef / ef))

        background_fn = None
        if callable(background):
            background_fn = background
        elif background:
            if self.online is None:
                raise ValueError("background=True hangs OnlineIndex.compact_slice on idle "
                                 "ticks and requires a mutable index; call ensure_online() "
                                 "first (or pass a callable hook)")
            background_fn = self.online.compact_slice

        return SlotScheduler(
            beam_dist, graph_fn, dim=int(self.X.shape[1]), slots=slots, ef=ef, k=k,
            frontier=frontier, adaptive=adaptive, patience=patience,
            steps_per_sync=steps_per_sync, compact=compact, k_c=k_c, rerank_fn=rerank_fn,
            ladder=rungs, slo_ms=slo_ms, shed=shed, tenant_weights=tenant_weights,
            background_fn=background_fn, service_prior=service_prior,
            admission_margin=admission_margin)


def make_build_info(spec: RetrievalSpec, degrees, build_policy, search_policy) -> dict:
    """``build_info`` with the keys and values ``repro`` records for ``spec``
    and the policies as resolved (``bind_policies``)."""
    swgraph = spec.builder == "swgraph"
    return dict(
        builder=spec.builder,
        build_engine=spec.build_engine if swgraph else "nndescent",
        wave=spec.wave if swgraph and spec.build_engine == "wave" else None,
        index_sym=str(spec.build_policy),
        query_sym=str(spec.search_policy),
        index_sym_resolved=str(build_policy),
        query_sym_resolved=str(search_policy),
        NN=spec.NN,
        ef_construction=spec.ef_construction,
        mean_degree=float(degrees.float().mean()),
        spec=spec.to_dict(),
        spec_fingerprint=spec.fingerprint(),
    )
