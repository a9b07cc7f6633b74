"""High-level ANN index API (PyTorch port of ``repro.core.index``).

    spec = RetrievalSpec(distance="kl", builder="nndescent", ef_search=96)
    idx = ANNIndex.build(X, spec=spec)      # X on the card (or the CPU)
    dists, ids, n_evals, hops = idx.searcher()(Q)

Builders: NN-descent, and SW-graph with the wave-parallel or the
sequential engine, under any build policy (the graph-construction
distance).  Engines: the batched lock-step engine and the single-query
reference engine, under the original distance, or under a bound search
policy whose k_c candidates are re-ranked under the original distance
(the paper's full-symmetrization scenario).  Online mutation and the
scheduler of ``repro`` raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.batched_beam import make_step_searcher, select_entries
from repro_torch.core.beam_search import make_batched_searcher
from repro_torch.core.build_engine import build_swgraph_wave
from repro_torch.core.filter_refine import rerank
from repro_torch.core.nndescent import build_nndescent
from repro_torch.core.spec import RetrievalSpec
from repro_torch.core.swgraph import build_swgraph
from repro_torch.kernels.ops import prepped

_ITEM_ONLINE = "ROADMAP item M11 (online.py)"
_ITEM_SCHEDULER = "ROADMAP item M12 (scheduler.py)"


def check_supported(spec: RetrievalSpec) -> None:
    if spec.capacity is not None:
        raise NotImplementedError(f"capacity / online mutation is not ported yet: {_ITEM_ONLINE}")


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


@dataclasses.dataclass
class ANNIndex:
    """A built neighborhood-graph index over a database X."""

    X: torch.Tensor
    neighbors: torch.Tensor  # (n, M) int32
    dist: object  # original distance
    search_dist: object  # distance guiding the beam (may equal dist)
    query_sym: str
    entries: Optional[torch.Tensor] = None  # (E,) int32 beam entry points
    build_info: dict = dataclasses.field(default_factory=dict)
    build_dist: object = None  # index-time distance
    spec: RetrievalSpec = dataclasses.field(default_factory=RetrievalSpec)

    @property
    def entry(self) -> int:
        """Primary entry node (the medoid when entries were selected)."""
        return 0 if self.entries is None else int(self.entries[0])

    @classmethod
    def build(cls, X, dist=None, *, spec: Optional[RetrievalSpec] = None,
              generator: Optional[torch.Generator] = None,
              natural: Optional[Callable] = None) -> "ANNIndex":
        """Build an index from a ``RetrievalSpec``.

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
        """
        spec = spec if spec is not None else RetrievalSpec()
        check_supported(spec)
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
        return cls(
            X=X,
            neighbors=neighbors,
            dist=dist,
            search_dist=search_dist,
            query_sym=str(spec.search_policy),
            entries=entries,
            build_info=make_build_info(spec, degrees, build_policy, search_policy),
            build_dist=build_dist,
            spec=spec,
        )

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
        consts = prepped(self.dist.prep_scan(self.X))  # the original distance, prepped once

        def search(Q):
            _, cand, n_evals, hops = inner(Q)
            d, ids = rerank(self.dist, Q, self.X, cand, k, consts=consts)
            return d, ids, n_evals + k_c, hops

        return search

    def _make_searcher(self, dist, ef: int, k: int, engine: str, frontier: int,
                       adaptive: bool, patience: int):
        if engine == "reference":
            return make_batched_searcher(dist, self.neighbors, self.X, ef, k, entry=self.entry)
        return make_step_searcher(dist, self.neighbors, self.X, ef, k, entries=self.entries,
                                  frontier=frontier, adaptive=adaptive, patience=patience)

    def search(self, Q, k: Optional[int] = None, ef_search: Optional[int] = None,
               k_c: Optional[int] = None, engine: Optional[str] = None,
               frontier: Optional[int] = None):
        """One-shot ``searcher(...)(Q)`` with the same knob resolution."""
        return self.searcher(k, ef_search, k_c, engine=engine, frontier=frontier)(Q)

    def scheduler(self, *args, **kwargs):
        raise NotImplementedError(f"the slot scheduler is not ported yet: {_ITEM_SCHEDULER}")

    def ensure_online(self, capacity: Optional[int] = None):
        raise NotImplementedError(f"online mutation is not ported yet: {_ITEM_ONLINE}")


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
