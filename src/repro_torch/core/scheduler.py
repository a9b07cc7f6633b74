"""Continuous-batching query scheduler: the slot-recycling beam engine
(PyTorch port of ``repro.core.scheduler``).

The lock-step engine retires a batch only when its slowest query converges;
under KL or Itakura-Saito one straggler holds back every query of its batch.
The slot scheduler serves queries as they arrive instead:

  * the device state is S fixed SLOTS, each an independent query with its
    own beam, visited set and convergence flag, in tensors of fixed shape
    (S, ef, ceil(n / 32));
  * each host tick runs ``steps_per_sync`` lock-steps of the batched
    engine's ``beam_step``, reads the ``done`` mask once, and retires every
    slot whose query converged;
  * freed slots are refilled from the pending queue.  Admission seeds with
    the engine's ``seed_beams``, so a query's result does not depend on
    when it was admitted: a run with every query submitted up front and
    S >= B gives the one-shot batch search's ids, evals and hops.

Every score goes through ``ops.gathered_scores``, the scoring function of
``make_step_searcher``: one ``gather_scores`` launch per branch of the
distance on the card (the admission's seeding over the entries for all S
slots, every lock-step), the plain version on the CPU.  ``repro`` scores
its steps with ``frontier_gather_scores``; the port's batched steps all go
through ``gather_scores``, so there is no ``use_pallas`` switch.

Per-query ADAPTIVE FRONTIER (``adaptive=True``): each slot carries its own
frontier width in [1, frontier]: one candidate per step while the beam
radius improves, doubling back to ``frontier`` once it stalls for
``patience`` steps (``adaptive_width_update``).

Mutability: ``graph_fn`` is read every tick, so an ``OnlineIndex`` can
insert, delete and compact between ticks.  Retired results are re-masked
against the current ``alive`` mask (gathered on the device at the retired
ids, never copied whole) and against ``killed_epoch``, so a point deleted
mid-flight, or a slot reused for a new point, never reaches a response.

Rerank: with ``k_c``/``rerank_fn`` the beams run under the bound search
policy and each retired request's ``k_c`` best candidates are re-ranked
under the original distance, one B = 1 call per request, ``k_c`` counted
into ``n_evals``.

SLO admission and multi-tenant QoS: per-tenant queues drained by deficit
round-robin, and an ``AdmissionController`` that demotes a request down a
ladder of cheaper operating points (``Rung``: a lower effective ef and/or
the adaptive frontier) before it sheds it.  Demotion runs inside the fixed
(S, ef) tensors through ``beam_step``'s ``ef_active``, so a demoted
request's result equals a scheduler's built at the rung's ef.
``background_fn`` hangs index maintenance (one
``OnlineIndex.compact_slice``) on idle ticks.

The host logic (queues, DRR, admission, the stream driver and its virtual
clock) is ``repro``'s, line for line in numpy and Python.
"""

from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.batched_beam import (BatchBeamState, adaptive_width_update, beam_step,
                                           frontier_compact_width, seed_beams)
from repro_torch.core.trace import span
from repro_torch.kernels.ops import gathered_scores, prepped

INF = float("inf")


class GraphView(NamedTuple):
    """One tick's snapshot of the (possibly mutable) index state."""

    neighbors: torch.Tensor  # (n, M) int32 adjacency, -1 padding
    consts: Any  # prepped(dist.prep_scan(X)), leading axis n
    alive: Optional[torch.Tensor]  # (n,) bool tombstone mask on the device, or None
    entries: torch.Tensor  # (E,) int32 beam entry nodes
    epoch: int = 0  # mutation epoch at snapshot time
    killed_epoch: Optional[np.ndarray] = None  # (n,) host int64: the epoch each
    # slot was last tombstoned, which guards retired results against slots that
    # died (and were possibly reused for a new point) mid-flight


class SlotState(NamedTuple):
    """Device state of the S slots (every tensor of fixed shape)."""

    core: BatchBeamState  # per-slot beam state, leading axis S
    qc: Any  # per-slot prepped query constants, leading axis S
    q: torch.Tensor  # (S, dim) raw queries, for the retire-time rerank
    t_cur: torch.Tensor  # (S,) int32 adaptive frontier width (== T when fixed)
    stall: torch.Tensor  # (S,) int32 steps since the slot's beam radius improved
    worst: torch.Tensor  # (S,) f32 beam radius watermark for the policy
    ef_act: torch.Tensor  # (S,) int32 effective beam width (== ef when undemoted)
    adapt: torch.Tensor  # (S,) bool: the slot runs the adaptive frontier policy


@dataclass
class SlotResult:
    """One retired request (distances ascending, -1/inf padded)."""

    rid: int
    dists: np.ndarray  # (k,) f32
    ids: np.ndarray  # (k,) i64 stable slot/database ids
    n_evals: int
    hops: int
    t_arrival: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    tenant: int = 0
    priority: int = 0
    level: int = 0  # demotion-ladder rung served at (-1 for shed requests)
    shed: bool = False  # load-shed: no search ran, ids/dists are -1/inf

    @property
    def latency(self) -> float:
        return self.t_done - self.t_arrival


@dataclass(frozen=True)
class Rung:
    """One operating point on the QoS demotion ladder (cheapest last).

    ``scale`` is the rung's expected service cost relative to rung 0, which
    the admission controller uses until the rung has retired a request;
    ``ANNIndex.scheduler`` sets it to the ef ratio.
    """

    ef: int
    adaptive: bool = False
    name: str = ""
    scale: float = 1.0


@dataclass
class _Request:
    """A pending queue entry (host side only)."""

    rid: int
    q: np.ndarray
    t_arrival: float
    tenant: int
    priority: int
    slo_s: Optional[float]
    level: Optional[int]  # pinned operating point (bypasses admission)


class ServiceRateEstimator:
    """EWMA estimates of per-request service time, overall and per rung.

    Each occupied slot retires ``1 / mean`` requests per second, so a full
    scheduler drains its queue at ``slots / mean`` requests per second.
    Each rung also keeps its own mean, falling back to ``rung-0 mean x
    scale`` until its first retire; every prediction is 0 until the first
    observation (admission is optimistic while cold).
    """

    def __init__(self, slots: int, alpha: float = 0.25, prior: Optional[float] = None,
                 n_rungs: int = 1):
        self.slots = int(slots)
        self.alpha = float(alpha)
        self.mean: Optional[float] = None if prior is None else float(prior)
        self._rung: list[Optional[float]] = [None] * max(1, int(n_rungs))
        if prior is not None:
            self._rung[0] = float(prior)

    def observe(self, service_s: float, level: int = 0) -> None:
        if not service_s > 0.0:
            return
        a = self.alpha
        self.mean = service_s if self.mean is None else (1.0 - a) * self.mean + a * service_s
        lvl = min(max(int(level), 0), len(self._rung) - 1)
        m = self._rung[lvl]
        self._rung[lvl] = service_s if m is None else (1.0 - a) * m + a * service_s

    @property
    def rate_per_slot(self) -> Optional[float]:
        """Retires per second per occupied slot (None until the first observation)."""
        return None if self.mean is None else 1.0 / max(self.mean, 1e-12)

    def service_s(self, level: int = 0, scale: float = 1.0) -> float:
        """Predicted service seconds at a rung (0 while fully cold)."""
        lvl = min(max(int(level), 0), len(self._rung) - 1)
        if self._rung[lvl] is not None:
            return self._rung[lvl]
        base = self._rung[0] if self._rung[0] is not None else self.mean
        return 0.0 if base is None else base * scale

    def predicted_wait(self, position: int, free_slots: int) -> float:
        """Predicted queue wait of the request at 0-indexed ``position`` with
        ``free_slots`` idle slots: ``(position - free + 1) * mean / slots``."""
        if self.mean is None or position < free_slots:
            return 0.0
        return (position - free_slots + 1) * self.mean / max(self.slots, 1)


class AdmissionController:
    """SLO admission: demote to a cheaper rung before shedding.

    ``decide`` walks down the ladder from the request's class rung until
    the predicted completion (elapsed wait + queue wait + ``margin`` x the
    rung's predicted service) fits the SLO budget.  A request is shed only
    when even the cheapest rung does not fit; with ``shed=False`` it runs
    best-effort at the cheapest rung instead.
    """

    def __init__(self, rungs: list[Rung], slots: int, *, shed: bool = True,
                 alpha: float = 0.25, prior: Optional[float] = None, margin: float = 1.0):
        self.rungs = list(rungs)
        self.shed = bool(shed)
        if not margin > 0:
            raise ValueError(f"admission margin must be > 0, got {margin}")
        self.margin = float(margin)
        self.estimator = ServiceRateEstimator(slots, alpha=alpha, prior=prior,
                                              n_rungs=len(self.rungs))
        self.n_demoted = 0
        self.n_shed = 0

    def decide(self, *, elapsed: float, slo_s: Optional[float], base_level: int = 0,
               queue_wait: float = 0.0) -> Optional[int]:
        """Rung index to serve the request at, or None to shed it."""
        last = len(self.rungs) - 1
        base = min(max(int(base_level), 0), last)
        if slo_s is None:
            return base
        remaining = slo_s - elapsed - queue_wait
        for lvl in range(base, last + 1):
            planned = self.estimator.service_s(lvl, self.rungs[lvl].scale)
            if planned * self.margin <= remaining:
                if lvl > base:
                    self.n_demoted += 1
                return lvl
        if self.shed:
            self.n_shed += 1
            return None
        if last > base:
            self.n_demoted += 1
        return last


class SchedulerHost:
    """Host-side serving machinery: the per-tenant DRR queues with strict
    priority within a tenant, ``submit``, and the ``drain`` / ``warmup`` /
    ``run_stream`` drivers.  A subclass provides the device state, ``tick``,
    ``reset``, the ``dim`` / ``rungs`` / ``slo_s`` attributes, the host-side
    ``_slot_rid`` occupancy array and the ``_background`` idle hook."""

    def _init_host_queue(self, tenant_weights=None):
        """Validate tenant weights and create the (empty) queue state."""
        self._rid_gen = itertools.count()
        self._weights = {int(t): float(w) for t, w in (tenant_weights or {}).items()}
        for t, w in self._weights.items():
            if not w > 0:
                raise ValueError(f"tenant {t} weight must be > 0, got {w}")
        self._queues: dict[int, dict[int, collections.deque]] = {}
        self._tenant_order: list[int] = []
        self._deficit: dict[int, float] = {}
        self._n_pending = 0

    def _clear_host_queue(self):
        self._queues.clear()
        self._tenant_order.clear()
        self._deficit.clear()
        self._n_pending = 0

    @property
    def n_inflight(self) -> int:
        return int((self._slot_rid >= 0).sum())

    @property
    def n_pending(self) -> int:
        return self._n_pending

    def submit(self, q, rid: Optional[int] = None, t_arrival: float = 0.0, *, tenant: int = 0,
               priority: int = 0, slo_ms: Optional[float] = None,
               level: Optional[int] = None) -> int:
        """Enqueue one query row ``q`` (dim,); returns the request id.

        ``rid`` names the request (a counter otherwise); ``t_arrival`` is
        echoed into its ``SlotResult``.  ``tenant`` selects the DRR queue;
        ``priority`` is the QoS class (0 = highest), which starts at ladder
        rung min(priority, len(ladder) - 1) and, within a tenant, precedes
        every higher-numbered class.  ``slo_ms`` overrides the scheduler's
        SLO for this request; ``level`` pins a rung, bypassing admission.
        """
        if rid is None:
            rid = next(self._rid_gen)
        tenant, priority = int(tenant), max(0, int(priority))
        slo_s = self.slo_s if slo_ms is None else float(slo_ms) / 1e3
        if level is not None:
            level = min(max(int(level), 0), len(self.rungs) - 1)
        tq = self._queues.get(tenant)
        if tq is None:
            tq = self._queues[tenant] = {}
            self._tenant_order.append(tenant)
            self._deficit[tenant] = 0.0
        dq = tq.get(priority)
        if dq is None:
            dq = tq[priority] = collections.deque()
        dq.append(_Request(int(rid), np.asarray(q), float(t_arrival), tenant, priority, slo_s,
                           level))
        self._n_pending += 1
        return int(rid)

    def _tenant_pending(self, tenant: int) -> bool:
        return any(self._queues[tenant][p] for p in self._queues[tenant])

    def _pop_tenant(self, tenant: int) -> _Request:
        tq = self._queues[tenant]
        for prio in sorted(tq):
            if tq[prio]:
                self._n_pending -= 1
                return tq[prio].popleft()
        raise LookupError(f"tenant {tenant} has no pending requests")

    def _drr_select(self, n: int) -> list[_Request]:
        """Pop up to ``n`` requests: deficit round-robin over the tenants in
        first-seen order (quantum = weight, cost 1 per request), strict
        priority within a tenant.  A tenant's deficit resets when its queue
        drains, so no burst credit is banked."""
        out: list[_Request] = []
        while len(out) < n and self._n_pending:
            active = [t for t in self._tenant_order if self._tenant_pending(t)]
            for t in active:
                self._deficit[t] += self._weights.get(t, 1.0)
            for t in active:
                while len(out) < n and self._deficit[t] >= 1.0 and self._tenant_pending(t):
                    out.append(self._pop_tenant(t))
                    self._deficit[t] -= 1.0
                if not self._tenant_pending(t):
                    self._deficit[t] = 0.0
        return out

    def drain(self, now: float = 0.0) -> list[SlotResult]:
        """Run ticks until the queue and every slot are empty."""
        out = []
        while self._n_pending or (self._slot_rid >= 0).any():
            out.extend(self.tick(now))
        return out

    def warmup(self, q=None):
        """Run one request through admit, step and retire, then ``reset``
        (the kernels build on their first launch)."""
        if q is None:
            q = np.full((self.dim,), 1.0 / self.dim, np.float32)
        self.submit(np.asarray(q))
        self.drain()
        self.reset()

    def _agree(self, clock: float) -> float:
        """The clock this scheduler reads: its own.  A scheduler run as one
        replica per rank (``core.distributed``) agrees on one value instead,
        so that every replica submits the same requests; ``run_stream``
        asks only while arrivals remain to be submitted."""
        return clock

    def run_stream(self, Q, arrivals=None, realtime: bool = False, warm: bool = True,
                   tenants=None, priorities=None, slo_ms: Optional[float] = None,
                   tick_cost: Optional[float] = None) -> list[SlotResult]:
        """Serve a request stream with per-request arrival times.

        ``Q`` (n, dim): numpy, or a tensor copied to the host once.
        ``arrivals=None`` submits everything at t=0.  The clock is VIRTUAL
        by default: it advances by each tick's measured compute time (the
        tick ends with a device sync), so percentiles reflect the scheduler,
        not host sleep jitter.  ``realtime=True`` uses the wall clock and
        sleeps through idle gaps; ``tick_cost`` advances the virtual clock
        by a fixed cost per tick, which makes queueing deterministic.
        ``tenants`` / ``priorities`` (per-request arrays) and ``slo_ms``
        forward to ``submit``.  Returns results in request order with
        ``t_arrival`` / ``t_admit`` / ``t_done`` on the chosen clock.

        Spans (``core.trace``): ``sched.submit`` per burst of arrivals
        handed in, ``sched.wait`` while idle, the tick, ``sched.collect``
        over its results.
        """
        if realtime and tick_cost is not None:
            raise ValueError("tick_cost is a virtual-clock mode; incompatible with realtime=True")
        Q = Q.detach().cpu().numpy() if isinstance(Q, torch.Tensor) else np.asarray(Q)
        n_req = Q.shape[0]
        if arrivals is None:
            arrivals = np.zeros((n_req,), float)
        arrivals = np.asarray(arrivals, float)
        order = np.argsort(arrivals, kind="stable")
        if warm:
            self.warmup(Q[0])
        else:
            self.reset()
        results: dict[int, SlotResult] = {}
        t0 = time.perf_counter()
        clock = 0.0
        i = 0
        while len(results) < n_req:
            if realtime:
                clock = time.perf_counter() - t0
                if i < n_req:
                    clock = self._agree(clock)
            if i < n_req and arrivals[order[i]] <= clock:
                with span("sched.submit"):  # the burst of arrivals now due
                    while i < n_req and arrivals[order[i]] <= clock:
                        rid = int(order[i])
                        self.submit(Q[rid], rid=rid, t_arrival=float(arrivals[rid]),
                                    tenant=0 if tenants is None else int(tenants[rid]),
                                    priority=0 if priorities is None else int(priorities[rid]),
                                    slo_ms=slo_ms)
                        i += 1
            if not self._n_pending and not (self._slot_rid >= 0).any():
                # idle: background maintenance, then jump (or sleep) to the next arrival
                with span("sched.wait"):
                    if self._background is not None:
                        self._background()
                    nxt = float(arrivals[order[i]])
                    if realtime:
                        time.sleep(max(0.0, nxt - (time.perf_counter() - t0)))
                    else:
                        clock = nxt
                continue
            tick_t0 = time.perf_counter()
            finished = self.tick(now=clock)
            if realtime:
                clock = time.perf_counter() - t0
            elif tick_cost is not None:
                clock += tick_cost
            else:
                clock += time.perf_counter() - tick_t0
                if i < n_req:
                    clock = self._agree(clock)
            with span("sched.collect"):
                for r in finished:
                    r.t_done = clock
                    results[r.rid] = r
        return [results[j] for j in range(n_req)]


class SlotScheduler(SchedulerHost):
    """Slot-recycling continuous-batching searcher over a neighborhood graph.

    Parameters
    ----------
    dist : the distance guiding the beams (any distance of the port)
    graph_fn : () -> GraphView, read every tick; tensor SHAPES must stay fixed
        (capacity-padded for a mutable index); the device is the graph's
    dim : query dimensionality
    slots : S, concurrent in-flight queries
    ef, k : beam width and results per query (ef >= k)
    frontier : most beam candidates expanded per slot and lock-step
    adaptive, patience : the per-slot adaptive frontier
    steps_per_sync : lock-steps per host tick (retire/refill granularity)
    k_c, rerank_fn : the rerank scenario: ``rerank_fn(q (1, dim), cand (1, k_c)
        int32) -> (dists (1, k), ids (1, k))`` tensors on the graph's device,
        one call per retired request, ``k_c`` counted into ``n_evals``
    ladder : ``Rung`` list (or kwargs dicts), full fidelity first, cheapest
        last; rung 0 must be the scheduler's own point and every rung needs
        ``max(k, k_c) <= ef_rung <= ef``.  Default: the one full rung
    slo_ms : default SLO budget per request (admission control when set)
    shed : drop requests no rung can save (False: cheapest rung, best effort)
    tenant_weights : tenant -> DRR weight (> 0); unlisted tenants get 1.0
    background_fn : called once per idle tick (``OnlineIndex.compact_slice``)
    service_alpha, service_prior, admission_margin : the admission controller's
        EWMA smoothing, initial mean service seconds and planning slack
    """

    def __init__(self, dist, graph_fn: Callable[[], GraphView], *, dim: int, slots: int = 32,
                 ef: int = 96, k: int = 10, frontier: int = 4, compact: int = 32,
                 adaptive: bool = False, patience: int = 1, max_steps: Optional[int] = None,
                 steps_per_sync: int = 1, k_c: Optional[int] = None,
                 rerank_fn: Optional[Callable] = None, ladder: Optional[list] = None,
                 slo_ms: Optional[float] = None, shed: bool = True,
                 tenant_weights: Optional[dict] = None,
                 background_fn: Optional[Callable[[], Any]] = None,
                 service_alpha: float = 0.25, service_prior: Optional[float] = None,
                 admission_margin: float = 1.0):
        if ef < k:
            raise ValueError(f"ef {ef} < k {k}")
        if frontier < 1:
            raise ValueError(f"frontier must be >= 1, got {frontier}")
        if (k_c is None) != (rerank_fn is None):
            raise ValueError("k_c and rerank_fn must be provided together")
        if k_c is not None and not (k <= k_c <= ef):
            raise ValueError(f"need k {k} <= k_c {k_c} <= ef {ef}")
        self.k_c = None if k_c is None else int(k_c)
        self._rerank_fn = rerank_fn
        g = graph_fn()
        n, M = g.neighbors.shape
        self.dist = dist
        self.graph_fn = graph_fn
        self.dim = int(dim)
        self.S = int(slots)
        self.ef = int(ef)
        self.k = int(k)
        self.T = int(min(frontier, ef))
        self.C = frontier_compact_width(self.T, M, compact)
        self.adaptive = bool(adaptive)
        self.patience = int(max(1, patience))
        self.max_steps = int(n if max_steps is None else max_steps)
        self.steps_per_sync = int(max(1, steps_per_sync))
        self._masked = g.alive is not None
        self._n = n
        self._dev = g.neighbors.device

        # ---- QoS: demotion ladder, admission control, tenant fairness
        rungs = [r if isinstance(r, Rung) else Rung(**r) for r in ladder or []]
        if not rungs:
            rungs = [Rung(ef=self.ef, adaptive=self.adaptive, name="full")]
        if rungs[0].ef != self.ef or rungs[0].adaptive != self.adaptive:
            raise ValueError("ladder rung 0 must be the scheduler's own operating point "
                             f"(ef={self.ef}, adaptive={self.adaptive}), got {rungs[0]}")
        floor = self.k_c or self.k
        for r in rungs:
            if not floor <= r.ef <= self.ef:
                raise ValueError(f"ladder rung ef {r.ef} outside [{floor}, {self.ef}]")
        if any(rungs[i].ef < rungs[i + 1].ef for i in range(len(rungs) - 1)):
            raise ValueError("ladder rungs must be cheapest-last (ef non-increasing)")
        self.rungs = rungs
        self.slo_s = None if slo_ms is None else float(slo_ms) / 1e3
        # a single-rung ladder without an SLO steps exactly as the one-shot
        # engine does (no ef_active, no radius override)
        self._qos = len(rungs) > 1 or self.slo_s is not None
        self._any_adaptive = self.adaptive or any(r.adaptive for r in rungs)
        self.admission = AdmissionController(rungs, self.S, shed=shed, alpha=service_alpha,
                                             prior=service_prior, margin=admission_margin)
        self._background = background_fn
        self._init_host_queue(tenant_weights)
        self.reset()

    # ------------------------------------------------------------ device steps

    def _score_fn(self, consts, qc):
        dist = self.dist

        def score_rows(ids):
            return gathered_scores(dist, ids, qc, consts)

        return score_rows

    def _admit(self, state: SlotState, Q_new, write, ef_new, ad_new, g: GraphView) -> SlotState:
        """Seed all S rows from the entries, then keep the rows ``write`` selects."""
        S, ef, T = self.S, self.ef, self.T
        qc_new = prepped(self.dist.prep_queries(Q_new))
        fresh = seed_beams(self._score_fn(g.consts, qc_new), g.entries, S, ef, self._n,
                           alive=g.alive)
        if self._qos:
            # demoted slots seed as an ef_new-wide engine: void entries past it
            off = torch.arange(ef, device=self._dev)[None, :] >= ef_new[:, None]
            fresh = fresh._replace(beam_d=torch.where(off, INF, fresh.beam_d),
                                   beam_i=torch.where(off, -1, fresh.beam_i),
                                   expanded=fresh.expanded | off)

        def sel(a, b):
            return torch.where(write.reshape((S,) + (1,) * (a.dim() - 1)), a, b)

        # adaptive slots start at width 1: admission begins the descent phase
        t_new = torch.where(ad_new, 1, T).to(torch.int32) if self._any_adaptive else T
        return SlotState(
            core=BatchBeamState(*(sel(a, b) for a, b in zip(fresh, state.core))),
            qc=_tree_map2(sel, qc_new, state.qc),
            q=sel(Q_new, state.q),
            t_cur=torch.where(write, t_new, state.t_cur),
            stall=torch.where(write, 0, state.stall),
            worst=torch.where(write, INF, state.worst),
            ef_act=torch.where(write, ef_new, state.ef_act),
            adapt=torch.where(write, ad_new, state.adapt),
        )

    def _step(self, state: SlotState, g: GraphView) -> SlotState:
        """``steps_per_sync`` lock-steps of every slot (done slots are frozen)."""
        ef, T = self.ef, self.T
        score_rows = self._score_fn(g.consts, state.qc)
        core, t_cur, stall, worst = state.core, state.t_cur, state.stall, state.worst
        ef_act = state.ef_act if self._qos else None
        for _ in range(self.steps_per_sync):
            t_act = t_cur if self._any_adaptive else None
            core = beam_step(core, g.neighbors, score_rows, ef, T, self.C, self.max_steps,
                             t_active=t_act, ef_active=ef_act)
            if self._any_adaptive:
                # demoted slots watch the radius at their effective width;
                # non-adaptive rungs stay pinned at T
                radius = None
                if self._qos:
                    wi = torch.clamp(state.ef_act - 1, 0, ef - 1).long()[:, None]
                    radius = torch.gather(core.beam_d, 1, wi)[:, 0]
                t_cur, stall, worst = adaptive_width_update(core, t_cur, stall, worst, T,
                                                            self.patience, radius=radius)
                t_cur = torch.where(state.adapt, t_cur, T)
        return state._replace(core=core, t_cur=t_cur, stall=stall, worst=worst)

    # ------------------------------------------------------------ state

    def reset(self):
        """Clear every slot, the pending queue and the per-request bookkeeping."""
        S, ef, dev = self.S, self.ef, self._dev
        nw = -(-self._n // 32)
        core = BatchBeamState(
            beam_d=torch.full((S, ef), INF, dtype=torch.float32, device=dev),
            beam_i=torch.full((S, ef), -1, dtype=torch.int32, device=dev),
            expanded=torch.ones((S, ef), dtype=torch.bool, device=dev),
            visited=torch.zeros((S, nw), dtype=torch.int32, device=dev),
            n_evals=torch.zeros((S,), dtype=torch.int32, device=dev),
            hops=torch.zeros((S,), dtype=torch.int32, device=dev),
            done=torch.ones((S,), dtype=torch.bool, device=dev),
        )
        # a uniform histogram in idle slots: valid under every registry
        # distance, so idle slots never score NaNs (KL over zero rows would)
        q0 = torch.full((S, self.dim), 1.0 / self.dim, dtype=torch.float32, device=dev)
        self.state = SlotState(
            core=core,
            qc=prepped(self.dist.prep_queries(q0)),
            q=q0,
            t_cur=torch.full((S,), self.T, dtype=torch.int32, device=dev),
            stall=torch.zeros((S,), dtype=torch.int32, device=dev),
            worst=torch.full((S,), INF, dtype=torch.float32, device=dev),
            ef_act=torch.full((S,), self.ef, dtype=torch.int32, device=dev),
            adapt=torch.full((S,), self.adaptive, dtype=torch.bool, device=dev),
        )
        self._clear_host_queue()
        # the learned service rate survives reset (it describes the hardware,
        # not the stream); the per-run QoS counters do not
        self.admission.n_demoted = 0
        self.admission.n_shed = 0
        # the occupancy: the rid each slot serves, -1 when idle
        self._slot_rid = np.full((S,), -1, np.int64)
        # rid -> (arrival, admit time, admission epoch, tenant, priority, rung)
        self._meta: dict[int, tuple] = {}

    @property
    def qos_stats(self) -> dict:
        """Per-run admission counters (zeroed by ``reset``)."""
        est = self.admission.estimator
        return {"demoted": self.admission.n_demoted, "shed": self.admission.n_shed,
                "mean_service_s": est.mean, "rate_per_slot": est.rate_per_slot}

    # ------------------------------------------------------------ serving

    def tick(self, now: float = 0.0) -> list[SlotResult]:
        """Admit pending requests into free slots (DRR across tenants, SLO
        admission per request), run ``steps_per_sync`` lock-steps, retire
        every converged slot.  Returns the retired results and any load-shed
        responses (``t_done`` is left to the caller's clock).

        Host syncs: one read of ``done``; when something retires, one copy
        of the retiring rows (distances, ids, evals, hops and, on a mutable
        index, ``alive`` at those ids), and for the rerank one copy back.

        Spans (``core.trace``): ``sched.tick`` (timed on the card too) over
        ``sched.admit`` (DRR selection to the seeding's launches),
        ``sched.step``, ``sched.sync`` (the read of ``done``) and
        ``sched.retire`` (the retiring rows' copy to the last result).
        """
        with span("sched.tick", device=True):
            g = self.graph_fn()
            shed_out: list[SlotResult] = []
            free = np.flatnonzero(self._slot_rid < 0)
            if len(free) and self._n_pending:
                with span("sched.admit"):
                    shed_out = self._admit_pending(free, g, now)
            if (self._background is not None and not self._n_pending
                    and (self._slot_rid < 0).any()):
                # idle capacity this tick: one slice of background maintenance
                self._background()
            if not (self._slot_rid >= 0).any():
                return shed_out
            with span("sched.step"):
                self.state = self._step(self.state, g)
            with span("sched.sync"):
                done = self.state.core.done.cpu().numpy()  # the tick's sync
            finished = done & (self._slot_rid >= 0)
            if not finished.any():
                return shed_out
            with span("sched.retire"):
                return shed_out + self._retire(finished, g, now)

    def _admit_pending(self, free, g: GraphView, now: float) -> list[SlotResult]:
        """Fill the ``free`` slots from the queues (DRR, then SLO admission per
        request) and seed them; returns the load-shed responses."""
        shed_out: list[SlotResult] = []
        Q_new = np.full((self.S, self.dim), 1.0 / self.dim, np.float32)
        # rows: write, ef_new, ad_new (one upload)
        ctl = np.zeros((3, self.S), np.int32)
        ctl[1] = self.ef
        ctl[2] = self.adaptive
        fi = 0
        # a shed frees no slot: keep drawing until the free slots are
        # filled or the queues drain
        while fi < len(free) and self._n_pending:
            for req in self._drr_select(len(free) - fi):
                lvl = req.level
                if lvl is None:
                    lvl = self.admission.decide(
                        elapsed=now - req.t_arrival, slo_s=req.slo_s,
                        base_level=min(req.priority, len(self.rungs) - 1))
                if lvl is None:
                    # load-shed: answered at once without a slot; demotion
                    # was already ruled out by decide()
                    shed_out.append(SlotResult(
                        rid=req.rid, dists=np.full((self.k,), np.inf, np.float32),
                        ids=np.full((self.k,), -1, np.int64), n_evals=0, hops=0,
                        t_arrival=req.t_arrival, t_admit=now, tenant=req.tenant,
                        priority=req.priority, level=-1, shed=True))
                    continue
                rung = self.rungs[lvl]
                s = free[fi]
                fi += 1
                Q_new[s] = req.q
                ctl[:, s] = (1, rung.ef, rung.adaptive)
                self._slot_rid[s] = req.rid
                self._meta[req.rid] = (req.t_arrival, now, g.epoch, req.tenant,
                                       req.priority, lvl)
        if ctl[0].any():
            ctl_d = torch.as_tensor(ctl, device=self._dev)
            self.state = self._admit(self.state, torch.as_tensor(Q_new, device=self._dev),
                                     ctl_d[0].bool(), ctl_d[1], ctl_d[2].bool(), g)
        return shed_out

    def _retire(self, finished, g: GraphView, now: float) -> list[SlotResult]:
        """The results of the ``finished`` slots, which are freed."""
        idx = np.flatnonzero(finished)
        rows = torch.as_tensor(idx, device=self._dev)
        # a mutable index reads the whole ef-wide beam: voided entries
        # backfill from the alive candidates ranked at k..ef
        width = self.ef if self._masked else (self.k_c or self.k)
        core = self.state.core
        beam_i = core.beam_i[rows, :width]
        parts = [core.beam_d[rows, :width].view(torch.int32), beam_i, core.n_evals[rows, None],
                 core.hops[rows, None]]
        if self._masked:
            parts.append(g.alive[beam_i.clamp(min=0).long()].to(torch.int32))
        block = torch.cat(parts, dim=1).cpu().numpy()  # the retiring rows, one copy
        d = np.ascontiguousarray(block[:, :width]).view(np.float32)
        ids = block[:, width:2 * width].astype(np.int64)
        evals, hops = block[:, 2 * width], block[:, 2 * width + 1]
        metas = [self._meta.pop(int(self._slot_rid[s]), (0.0, 0.0, 0, 0, 0, 0)) for s in idx]
        if self._masked:
            # points tombstoned while the query was in flight must not surface:
            # void them and compact each row (stable order).  The killed-epoch
            # guard also catches a slot that died AND was reused for another
            # point since admission, which `alive` alone would vouch for.
            dead = block[:, 2 * width + 2:] == 0
            if g.killed_epoch is not None:
                safe = np.where(ids >= 0, ids, 0)
                admit_epoch = np.asarray([m[2] for m in metas])[:, None]
                dead |= g.killed_epoch[safe] > admit_epoch
            dead &= ids >= 0
            if dead.any():
                d = np.where(dead, np.inf, d)
                ids = np.where(dead, -1, ids)
                order = np.argsort(np.where(np.isfinite(d), 0, 1), axis=1, kind="stable")
                d = np.take_along_axis(d, order, axis=1)
                ids = np.take_along_axis(ids, order, axis=1)
        if self.k_c is not None:
            # the beam ran under the bound search policy: re-rank its k_c best
            # candidates under the original distance, one B = 1 call each
            cand = torch.as_tensor(ids[:, :self.k_c], dtype=torch.int32, device=self._dev)
            outs = [self._rerank_fn(self.state.q[s:s + 1], cand[j:j + 1])
                    for j, s in enumerate(idx.tolist())]
            back = torch.cat([torch.cat([rd.float().view(torch.int32), ri.to(torch.int32)], dim=1)
                              for rd, ri in outs]).cpu().numpy()
            d = np.ascontiguousarray(back[:, :self.k]).view(np.float32)
            ids = back[:, self.k:].astype(np.int64)
            evals = evals + self.k_c
        else:
            d, ids = d[:, :self.k], ids[:, :self.k]

        out = []
        for j, s in enumerate(idx):
            rid = int(self._slot_rid[s])
            t_arr, t_adm, _, tenant, priority, lvl = metas[j]
            if now > t_adm:
                # feed the admission controller's per-rung service estimate
                self.admission.estimator.observe(now - t_adm, level=lvl)
            out.append(SlotResult(rid=rid, dists=d[j], ids=ids[j], n_evals=int(evals[j]),
                                  hops=int(hops[j]), t_arrival=t_arr, t_admit=t_adm,
                                  tenant=tenant, priority=priority, level=lvl))
            self._slot_rid[s] = -1
        return out


def _tree_map2(fn, a, b):
    """``fn(x, y)`` over the tensors of two nested dicts of the same structure."""
    if isinstance(a, dict):
        return {key: _tree_map2(fn, a[key], b[key]) for key in a}
    return fn(a, b)
