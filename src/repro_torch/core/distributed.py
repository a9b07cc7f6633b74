"""Scatter-gather retrieval over DB shards on ``torch.distributed`` (PyTorch
port of ``repro.core.distributed``).

Each rank of a process group owns one shard of the database rows and a
LOCAL subgraph over them (local row ids).  A query batch is replicated on
every rank; each rank runs a local beam search (or an exact scan) over its
block, and the per-shard top-k are merged with one all-gather and a stable
re-sort.  The merge is exact: the global top-k is a subset of the union of
the per-shard top-k.

Every entry point is called on EVERY rank of ``group`` (default: the
default group).  The shard count is the group's size and the shard is the
rank; results are replicated on every rank.  A rank's device holds only its
own block: its ``n_local`` rows of the padded layout, their scan constants
and its local adjacency, plus the replicated queries and merged top-k.

Non-divisible corpora: the row count is padded up to a multiple of the
shard count with WRAP-AROUND duplicates (``pad_to_shards``: row j of the
pad is ``X[j % n]``).  A padded row is a harmless Steiner node for
construction and traversal; its global id (>= the real row count) is
voided to (inf, -1) before any merge, so it never surfaces.

``drop_shards`` simulates stragglers: the LAST s ranks are dead, their
candidates void to (inf, -1) and their distance evaluations are zeroed out
of the sum.

``ShardedSlotScheduler`` is the continuous-batching slot engine
(``core.scheduler``) run on every rank over its shard, with one
cross-shard exchange per tick: each rank voids and re-top-ks its beams,
one all-gather carries every rank's candidates and its live, eval and hop
counts, and each rank merges them into the slots' replicated global
top-k.  A slot retires when every surviving shard's beam converged.

Scoring follows the tensors' device, as everywhere in the port: the
batched steps, ``seed_beams`` and the reference engine through
``ops.gathered_scores`` (``gather_scores`` on the card), the local scan
through ``ops.query_distance_matrix`` (``distance_matrix``), the local
NN-descent build through ``ops.round_scores`` (``two_hop_scores`` and
``frontier_scores``), one launch per branch of the distance.

Collectives: NCCL where each rank has a card of its own, gloo otherwise
(``pick_backend``), both on the ranks' tensors as they lie (gloo copies a
CUDA tensor through host memory itself).  These counted collectives are the
only ones in the port (``sharding.api`` runs the mesh's on them, over its
subgroups).  Each is counted by kind with its bytes on this rank (an
all-reduce's operand, an all-gather's result, a reduce-scatter's operand)
and timed: on the card between two CUDA events on the current stream, read
once they have passed (each collective, once queued, drains the finished
ones, so only those in flight are held) and so adding no sync; on the CPU on the
host clock.  So ``collective_stats()["seconds"]`` is the collectives
alone, the wait for the slowest rank included.  Each call also records its
group's size and whether the group spans nodes of ``CARDS_PER_NODE``
cards, which a roofline needs for the bytes on the wire.

Backends: NCCL, and the ``fake`` test backend (a process group that moves
nothing: one rank of a large mesh run alone, as the dry run does), take the
tensor forms (``all_gather_into_tensor``, ``reduce_scatter_tensor``); gloo
takes the list form and a composed reduce-scatter.  Any other backend
raises.  A meta tensor (the dry run's counting pass) is counted and timed
on the host clock.
"""

from __future__ import annotations

import datetime
import math
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.batched_beam import (BatchBeamState, _smallest, batched_beam_search,
                                           beam_step, frontier_compact_width, seed_beams)
from repro_torch.core.beam_search import beam_search_impl
from repro_torch.core.brute_force import _merge_topk
from repro_torch.core.scheduler import Rung, SchedulerHost, SlotResult, _tree_map2
from repro_torch.kernels.ops import gathered_scores, prepped, query_distance_matrix
from repro_torch.kernels.ref import exact_float32_matmul

INF = float("inf")
DEFAULT_TIMEOUT_S = 300.0
CARDS_PER_NODE = 8  # a DGX H100 node: 8 cards on one NVLink switch fabric

_SPANS: dict = {}  # process group -> (its size, whether its ranks span nodes)


# ---------------------------------------------------------------------------
# the process group and its collectives
# ---------------------------------------------------------------------------


def pick_backend(world: int, device) -> tuple[str, Optional[int]]:
    """``(backend, ranks_per_card)`` for ``world`` ranks on ``device``'s type.

    NCCL where every rank has a card of its own (NCCL refuses two ranks on
    one card); gloo otherwise, with CUDA tensors.  Decided once, before any
    rank starts.  ``ranks_per_card`` is None on the CPU.
    """
    if torch.device(device).type != "cuda":
        return "gloo", None
    cards = torch.cuda.device_count()
    if cards < 1:
        raise RuntimeError("a CUDA device was asked for and none is available")
    return ("nccl" if cards >= world else "gloo"), math.ceil(world / cards)


def rank_device(rank: int, device) -> torch.device:
    """Rank ``rank``'s device: card ``rank % cards`` for a CUDA ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_group(backend: str, init_method: str, rank: int, world: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``init_process_group`` with a timeout: a rank left waiting in a
    collective fails after ``timeout_s`` instead of hanging."""
    import torch.distributed as tdist

    tdist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                             timeout=datetime.timedelta(seconds=timeout_s))


def world_and_rank(group=None) -> tuple[int, int]:
    import torch.distributed as tdist

    return tdist.get_world_size(group), tdist.get_rank(group)


def collective_stats() -> dict:
    """Collectives so far in this process: ``calls``, ``bytes`` and
    ``seconds`` in all, and ``kinds``: {kind: {"calls", "bytes",
    "max_bytes", "seconds", "groups"}}, ``groups`` a list of {"size",
    "spans_nodes", "calls", "bytes"} by the groups the calls ran over.
    Waits for those still in flight on the card.  Read from the
    ``collective.<kind>.<field>`` and ``collective.<kind>.<size>.<spans
    nodes>.<field>`` counters of ``core.trace``."""
    stats: dict = {}
    for key, v in trace.counters("collective.").items():
        kind, *rest = key.split(".")
        st = stats.setdefault(kind, {"calls": 0, "bytes": 0, "max_bytes": 0, "seconds": 0.0,
                                     "groups": {}})
        if len(rest) == 1:
            st[rest[0]] = v
        else:
            size, spans, field = rest
            st["groups"].setdefault((int(size), spans == "1"), {"calls": 0, "bytes": 0})[field] = v
    kinds = {}
    for k, v in stats.items():
        kinds[k] = dict(v, groups=[{"size": g, "spans_nodes": spans, **c}
                                   for (g, spans), c in sorted(v["groups"].items())])
    return {"calls": sum(v["calls"] for v in kinds.values()),
            "bytes": sum(v["bytes"] for v in kinds.values()),
            "seconds": sum(v["seconds"] for v in kinds.values()), "kinds": kinds}


def reset_collective_stats() -> None:
    trace.reset("collective.")
    _SPANS.clear()


def _group_span(group) -> tuple:
    """(size, spans nodes) of ``group``: whether its global ranks lie on more
    than one node of ``CARDS_PER_NODE`` consecutive ranks."""
    import torch.distributed as tdist

    key = (group, tdist.get_world_size(group))  # the default group's size may change
    if key not in _SPANS:
        ranks = (tdist.get_process_group_ranks(group) if group is not None
                 else range(key[1]))
        _SPANS[key] = (len(ranks), len({r // CARDS_PER_NODE for r in ranks}) > 1)
    return _SPANS[key]


def _collective(kind: str, nbytes: int, t, run, group=None):
    """``run(t)``, counted under ``kind`` with ``nbytes`` and ``group``'s size
    and node span, and timed (on the card by two CUDA events around it on
    the current stream: the span from the end of the work queued before it
    to its result; a meta or CPU tensor on the host clock)."""
    src = t.contiguous()
    key = f"collective.{kind}."
    size, spans = _group_span(group)
    trace.count(key + "calls")
    trace.count(key + "bytes", nbytes)
    trace.high(key + "max_bytes", nbytes)
    trace.count(f"{key}{size}.{int(spans)}.calls")
    trace.count(f"{key}{size}.{int(spans)}.bytes", nbytes)
    with trace.timed(key + "seconds", torch.cuda.current_stream(src.device) if src.is_cuda
                     else None):
        return run(src)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_nccl(group) -> bool:
    """Whether ``group`` takes the tensor forms of the collectives: NCCL, and
    the ``fake`` backend, which stands in for NCCL ranks; gloo takes the list
    forms.  ``ValueError`` for any other backend."""
    import torch.distributed as tdist

    backend = str(tdist.get_backend(group))
    if backend not in ("nccl", "fake", "gloo"):
        raise ValueError(f"no counted collectives for backend {backend!r}: "
                         "nccl, gloo or fake")
    return backend != "gloo"


def all_gather(t, group=None, kind: str = "all_gather"):
    """(world, *t.shape): every rank's ``t``, in rank order, on every rank
    (NCCL: ``all_gather_into_tensor``; gloo: ``all_gather`` into its rows);
    counted under ``kind`` (FSDP's weight gathers as ``fsdp_gather``)."""
    import torch.distributed as tdist

    world = tdist.get_world_size(group)

    def run(src):
        out = torch.empty((world,) + tuple(src.shape), dtype=src.dtype, device=src.device)
        if _is_nccl(group):
            tdist.all_gather_into_tensor(out, src, group=group)
        else:
            tdist.all_gather(list(out.unbind(0)), src, group=group)
        return out

    return _collective(kind, world * _nbytes(t), t, run, group)


def all_reduce(t, op: str = "sum", group=None):
    """Elementwise ``op`` ("sum" or "max") of every rank's ``t``; a new tensor,
    counted as a ``psum`` or a ``pmax``."""
    import torch.distributed as tdist

    ops = {"sum": tdist.ReduceOp.SUM, "max": tdist.ReduceOp.MAX}

    _is_nccl(group)  # an unknown backend raises

    def run(src):
        out = src.clone()
        tdist.all_reduce(out, op=ops[op], group=group)
        return out

    return _collective({"sum": "psum", "max": "pmax"}[op], _nbytes(t), t, run, group)


def reduce_scatter(t, group=None):
    """(t.shape[0] // world, ...): the sum of every rank's ``t``, this rank's
    block of rows.  NCCL: ``reduce_scatter_tensor``.  Gloo has no
    reduce-scatter for CUDA tensors, so there, decided by the backend, it is
    composed of an all-reduce and the rank's block (counted as one
    ``psum_scatter``, with the all-reduce's operand)."""
    import torch.distributed as tdist

    world, rank = world_and_rank(group)
    if t.shape[0] % world:
        raise ValueError(f"{t.shape[0]} rows do not split over {world} ranks")
    rows = t.shape[0] // world

    def run(src):
        if _is_nccl(group):
            out = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                              device=src.device)
            tdist.reduce_scatter_tensor(out, src, group=group)
            return out
        out = src.clone()
        tdist.all_reduce(out, group=group)
        return out[rank * rows:(rank + 1) * rows].clone()

    return _collective("psum_scatter", _nbytes(t), t, run, group)


# ---------------------------------------------------------------------------
# padding, voiding and the merge
# ---------------------------------------------------------------------------


def _merge(all_d, all_i, k: int):
    """The k smallest of each row and their ids; the lower position first on
    equal distances (``jax.lax.top_k``'s rule), positions rank-major."""
    d, pos = _smallest(all_d, k)
    return d, torch.gather(all_i, 1, pos)


def pad_to_shards(X, n_shards: int):
    """Pad rows up to a multiple of ``n_shards`` with wrap-around duplicates.

    Returns ``(X_pad, n_real, n_local)``; row j of the pad is ``X[j % n]``.
    The same tensor comes back when the row count already divides.
    """
    n = X.shape[0]
    n_local = -(-n // n_shards)
    n_pad = n_local * n_shards
    if n_pad == n:
        return X, n, n_local
    return X[torch.arange(n_pad, device=X.device) % n], n, n_local


def local_block(X, shard: int, n_shards: int):
    """Shard ``shard``'s rows of ``pad_to_shards(X, n_shards)`` without
    padding the whole of X: ``(X_local, n_real, n_local)`` on X's device."""
    n = X.shape[0]
    n_local = -(-n // n_shards)
    rows = (shard * n_local + torch.arange(n_local, device=X.device)) % n
    return X[rows], n, n_local


def _check_layout(n_local: int, n_real: int, world: int, nbrs_rows: Optional[int] = None):
    if n_local != -(-n_real // world):
        raise ValueError(f"a shard of {n_local} rows does not fit the padded layout of "
                         f"{n_real} rows over {world} shards ({-(-n_real // world)} each)")
    if nbrs_rows is not None and nbrs_rows != n_local:
        raise ValueError(f"neighbors rows {nbrs_rows} != the shard's padded rows {n_local}; "
                         f"build them with build_local_subgraphs over the same shards")


def _globalize_void_topk(dloc, iloc, shard: int, n_local: int, n_real: int, k: int,
                         dead: bool = False):
    """Local ids -> global ids, void pads and a dead shard, re-top-k to width k.

    Padded rows map to global ids >= ``n_real`` and are voided to (inf, -1)
    with a dead shard's whole contribution BEFORE the top-k, so voided
    entries backfill from positions k..ef of the beam.  On an ascending beam
    with nothing voided this is the first-k slice.
    """
    gid = torch.where(iloc >= 0, iloc + shard * n_local, -1)
    void = (gid < 0) | (gid >= n_real) | dead
    return _merge(torch.where(void, INF, dloc), torch.where(void, -1, gid), k)


def _exchange(dloc, iloc, counts, k: int, group):
    """One all-gather of every rank's (B, kk) candidates and (B, c) int32
    counts: the merged (B, k) top-k and the (world, B, c) counts."""
    B, kk = dloc.shape
    packed = torch.cat([dloc.view(torch.int32), iloc.to(torch.int32), counts], dim=1)
    g = all_gather(packed, group)  # (world, B, 2 kk + c)
    all_d = g[:, :, :kk].permute(1, 0, 2).reshape(B, -1).view(torch.float32)
    all_i = g[:, :, kk:2 * kk].permute(1, 0, 2).reshape(B, -1)
    d, i = _merge(all_d, all_i, k)
    return d, i, g[:, :, 2 * kk:]


# ---------------------------------------------------------------------------
# one-shot entry points
# ---------------------------------------------------------------------------


def sharded_knn_scan(dist, Q, X_local, k: int, n_real: int, *, group=None, chunk: int = 8192):
    """Exact distributed k-NN: each rank scans its block in chunks of
    ``chunk`` rows (``ops.query_distance_matrix``), masks its padded rows to
    inf BEFORE its local top-k, and one all-gather + merge gives the
    replicated (dists (B, k), ids (B, k)) in GLOBAL row ids < ``n_real``.
    """
    world, shard = world_and_rank(group)
    n_local, B = X_local.shape[0], Q.shape[0]
    _check_layout(n_local, n_real, world)
    kk = min(k, n_local)
    dev = Q.device
    best_d = torch.full((B, kk), INF, dtype=torch.float32, device=dev)
    best_i = torch.full((B, kk), -1, dtype=torch.int32, device=dev)
    with exact_float32_matmul():
        for base in range(0, n_local, chunk):
            xblk = X_local[base:base + chunk]
            pos = torch.arange(base, base + xblk.shape[0], dtype=torch.int32, device=dev)
            d = query_distance_matrix(dist, Q, xblk)
            d = torch.where(pos[None, :] + shard * n_local >= n_real, INF, d)
            best_d, best_i = _merge_topk(best_d, best_i, d, pos.expand(B, -1), kk)
    iloc = torch.where(torch.isfinite(best_d), best_i + shard * n_local, -1)
    d, i, _ = _exchange(best_d, iloc, best_i[:, :0], k, group)
    return d, i


def sharded_graph_search(dist, Q, X_local, neighbors_local, k: int, ef: int, n_real: int, *,
                         drop_shards: int = 0, engine: str = "batched", frontier: int = 1,
                         group=None):
    """Distributed graph search: a local beam per shard from entry 0, then the
    global merge.  Returns ``(dists (B, k), ids (B, k), n_evals (B,))``,
    replicated.

    ``neighbors_local``: this rank's (n_local, M) adjacency in LOCAL row ids,
    from ``build_local_subgraphs`` over the same shards.
    ``engine="batched"`` runs the lock-step engine at ``frontier``;
    ``"reference"`` the single-query engine (equal to batched at frontier 1).
    ``drop_shards``: the last s ranks are dead; their candidates void and
    their evaluations do not count.
    """
    if engine not in ("batched", "reference"):
        raise ValueError(f"unknown engine {engine!r}; known: batched, reference")
    world, shard = world_and_rank(group)
    n_local, B = X_local.shape[0], Q.shape[0]
    _check_layout(n_local, n_real, world, neighbors_local.shape[0])
    consts = prepped(dist.prep_scan(X_local))
    qc = prepped(dist.prep_queries(Q))
    if engine == "batched":
        st = batched_beam_search(
            neighbors_local, lambda ids: gathered_scores(dist, ids, qc, consts),
            torch.zeros((1,), dtype=torch.int32, device=Q.device), B, ef, frontier=frontier)
    else:
        st = beam_search_impl(neighbors_local, consts, qc, dist, 0, ef)
    dloc, iloc, evals = st.beam_d, st.beam_i, st.n_evals
    dead = bool(drop_shards) and shard >= world - drop_shards
    if dead:
        evals = torch.zeros_like(evals)
    # full ef-wide beams go through the void + re-top-k, so a voided
    # (padded / dead) candidate backfills from positions k..ef
    dloc, iloc = _globalize_void_topk(dloc, iloc, shard, n_local, n_real, min(k, ef), dead)
    d, i, counts = _exchange(dloc, iloc, evals[:, None].to(torch.int32), k, group)
    return d, i, counts[:, :, 0].sum(dim=0, dtype=torch.int32)


def rank_seed(seed: int, shard: int) -> int:
    """The seed of shard ``shard``'s draws: ``(seed, shard)`` through numpy's
    ``SeedSequence``, the port's ``fold_in(key, axis_index)``."""
    return int(np.random.SeedSequence([seed, shard]).generate_state(1, np.uint64)[0] >> 1)


def build_local_subgraphs(dist, X_local, *, NN: int = 15, nnd_iters: int = 8,
                          builder: str = "nndescent", wave: int = 32, seed: int = 0,
                          nnd_draws=None, group=None):
    """This rank's (n_local, M) subgraph over its block, in LOCAL row ids.

    ``builder="nndescent"`` draws from a generator on X_local's device seeded
    with ``rank_seed(seed, rank)``, so identical shards still give different
    subgraphs; ``nnd_draws`` replaces those draws (a test replays the JAX
    package's).  ``builder="wave"`` is the wave-parallel SW-graph builder.
    """
    from repro_torch.core.build_engine import build_swgraph_wave
    from repro_torch.core.nndescent import build_nndescent

    if builder not in ("wave", "nndescent"):
        raise ValueError(f"unknown builder {builder!r}; known: wave, nndescent")
    _, shard = world_and_rank(group)
    if builder == "wave":
        nbrs, _ = build_swgraph_wave(dist, X_local, NN=NN, wave=wave)
    else:
        gen = torch.Generator(device=X_local.device).manual_seed(rank_seed(seed, shard))
        nbrs, _ = build_nndescent(dist, X_local, gen, K=NN, iters=nnd_iters, draws=nnd_draws)
    return nbrs


# ---------------------------------------------------------------------------
# sharded serving: the slot scheduler on every rank
# ---------------------------------------------------------------------------


class ShardSlotState(NamedTuple):
    """One rank's scheduler state (every tensor of fixed shape)."""

    core: BatchBeamState  # this shard's per-slot beam state, leading axis S
    qc: Any  # per-slot prepped query constants (replicated)
    glob_d: torch.Tensor  # (S, k) f32 merged global top-k distances (replicated)
    glob_i: torch.Tensor  # (S, k) i32 merged global top-k ids (replicated)


class ShardedSlotScheduler(SchedulerHost):
    """Slot-recycling continuous batching over a SHARDED corpus.

    One instance per rank, each over its own block and local subgraph, all
    driven through the same calls (``submit``, ``tick``, ``run_stream``).
    A tick admits from the DRR queue into free slots (``seed_beams`` from
    local entry 0; a dead shard's slots are born done), runs
    ``steps_per_sync`` ``beam_step``s, then syncs: each rank voids and
    re-top-ks its beams, and ONE all-gather carries every rank's candidates
    with its live, eval and hop counts; every rank merges them into the
    replicated global top-k, a slot is done when no rank has it live, evals
    are summed and hops maxed.  The host reads ``done`` once per tick and
    copies the retiring rows only when something retires.  No QoS ladder:
    one full rung, and no admission control: ``slo_ms`` is the default SLO
    that ``submit`` stamps on a request, as in ``repro``, and the tick serves
    every request in full.  The host state stays identical on every rank:
    while arrivals remain to be submitted the stream's clock is agreed
    across ranks (``_agree``), so every rank admits the same requests into
    the same slots; after the last submission each rank keeps its own
    clock, which only stamps ``t_admit`` and ``t_done``.

    ``neighbors_local=None`` builds this rank's subgraph here with
    ``build_local_subgraphs`` (``NN``, ``nnd_iters``, ``builder``, ``seed``,
    ``nnd_draws``).  ``compact`` bounds a lock-step's merge width,
    ``max_steps`` a beam's steps (default ``n_local``), ``tenant_weights``
    sets the DRR weights and ``background_fn`` is called once per idle tick.
    """

    def __init__(self, dist, X_local, neighbors_local, n_real: int, *, slots: int = 32,
                 ef: int = 96, k: int = 10, frontier: int = 1, compact: int = 32,
                 steps_per_sync: int = 1, max_steps: Optional[int] = None,
                 drop_shards: int = 0, NN: int = 15, nnd_iters: int = 8,
                 builder: str = "nndescent", seed: int = 0, nnd_draws=None,
                 slo_ms: Optional[float] = None, tenant_weights: Optional[dict] = None,
                 background_fn=None, group=None):
        if ef < k:
            raise ValueError(f"ef {ef} < k {k}")
        if frontier < 1:
            raise ValueError(f"frontier must be >= 1, got {frontier}")
        self.group = group
        self.n_shards, self.shard = world_and_rank(group)
        if not 0 <= drop_shards < self.n_shards:
            raise ValueError(f"drop_shards {drop_shards} outside [0, {self.n_shards})")
        self.n_local = int(X_local.shape[0])
        if neighbors_local is None:
            neighbors_local = build_local_subgraphs(
                dist, X_local, NN=NN, nnd_iters=nnd_iters, builder=builder, seed=seed,
                nnd_draws=nnd_draws, group=group)
        _check_layout(self.n_local, n_real, self.n_shards, neighbors_local.shape[0])
        self.n_real = int(n_real)
        self.drop_shards = int(drop_shards)
        self._dead = bool(drop_shards) and self.shard >= self.n_shards - drop_shards
        self.dist = dist
        self.dim = int(X_local.shape[1])
        self.S, self.ef, self.k = int(slots), int(ef), int(k)
        self.T = int(min(frontier, ef))
        self.C = frontier_compact_width(self.T, int(neighbors_local.shape[1]), compact)
        self.max_steps = int(self.n_local if max_steps is None else max_steps)
        self.steps_per_sync = int(max(1, steps_per_sync))
        self._dev = X_local.device
        self._neighbors = neighbors_local.to(torch.int32).contiguous()
        self._consts = prepped(dist.prep_scan(X_local))
        self._entries = torch.zeros((1,), dtype=torch.int32, device=self._dev)
        self.rungs = [Rung(ef=self.ef, name="full")]
        self.slo_s = None if slo_ms is None else float(slo_ms) / 1e3
        self._background = background_fn
        self._init_host_queue(tenant_weights)
        self.reset()

    # ------------------------------------------------------------ device steps

    def _score_fn(self, qc):
        dist, consts = self.dist, self._consts

        def score_rows(ids):
            return gathered_scores(dist, ids, qc, consts)

        return score_rows

    def _admit(self, state: ShardSlotState, Q_new, write) -> ShardSlotState:
        """Seed all S rows from entry 0, then keep the rows ``write`` selects."""
        S = self.S
        qc_new = prepped(self.dist.prep_queries(Q_new))
        fresh = seed_beams(self._score_fn(qc_new), self._entries, S, self.ef, self.n_local)
        if self._dead:
            # a dead shard's slots are born done: beam_step freezes them
            fresh = fresh._replace(done=torch.ones_like(fresh.done))

        def sel(a, b):
            return torch.where(write.reshape((S,) + (1,) * (a.dim() - 1)), a, b)

        return ShardSlotState(
            core=BatchBeamState(*(sel(a, b) for a, b in zip(fresh, state.core))),
            qc=_tree_map2(sel, qc_new, state.qc),
            glob_d=torch.where(write[:, None], INF, state.glob_d),
            glob_i=torch.where(write[:, None], -1, state.glob_i),
        )

    def _step(self, state: ShardSlotState):
        """``steps_per_sync`` lock-steps, then the sync point.  Returns the new
        state and the replicated (S,) done, evals and hops."""
        score_rows = self._score_fn(state.qc)
        core = state.core
        for _ in range(self.steps_per_sync):
            core = beam_step(core, self._neighbors, score_rows, self.ef, self.T, self.C,
                             self.max_steps)
        evals = torch.zeros_like(core.n_evals) if self._dead else core.n_evals
        dloc, iloc = _globalize_void_topk(core.beam_d, core.beam_i, self.shard, self.n_local,
                                          self.n_real, min(self.k, self.ef), self._dead)
        counts = torch.stack([(~core.done).to(torch.int32), evals, core.hops], dim=1)
        glob_d, glob_i, g = _exchange(dloc, iloc, counts, self.k, self.group)
        done = g[:, :, 0].sum(dim=0) == 0
        evals_g = g[:, :, 1].sum(dim=0, dtype=torch.int32)
        hops_g = g[:, :, 2].max(dim=0).values
        return state._replace(core=core, glob_d=glob_d, glob_i=glob_i), done, evals_g, hops_g

    def _agree(self, clock: float) -> float:
        """The latest of the ranks' clocks, so that every rank submits alike
        (one all-reduce, outside the tick)."""
        t = torch.tensor([clock], dtype=torch.float64, device=self._dev)
        return float(all_reduce(t, "max", self.group)[0])

    # ------------------------------------------------------------ state

    def reset(self):
        """Clear every slot, the pending queue and the per-request bookkeeping."""
        S, ef, k, dev = self.S, self.ef, self.k, self._dev
        nw = -(-self.n_local // 32)
        core = BatchBeamState(
            beam_d=torch.full((S, ef), INF, dtype=torch.float32, device=dev),
            beam_i=torch.full((S, ef), -1, dtype=torch.int32, device=dev),
            expanded=torch.ones((S, ef), dtype=torch.bool, device=dev),
            visited=torch.zeros((S, nw), dtype=torch.int32, device=dev),
            n_evals=torch.zeros((S,), dtype=torch.int32, device=dev),
            hops=torch.zeros((S,), dtype=torch.int32, device=dev),
            done=torch.ones((S,), dtype=torch.bool, device=dev),
        )
        # a uniform histogram in idle slots: KL scores it finite
        q0 = torch.full((S, self.dim), 1.0 / self.dim, dtype=torch.float32, device=dev)
        self.state = ShardSlotState(
            core=core, qc=prepped(self.dist.prep_queries(q0)),
            glob_d=torch.full((S, k), INF, dtype=torch.float32, device=dev),
            glob_i=torch.full((S, k), -1, dtype=torch.int32, device=dev))
        self._clear_host_queue()
        self._slot_rid = np.full((S,), -1, np.int64)
        # rid -> (arrival, admit time, tenant, priority)
        self._meta: dict[int, tuple] = {}
        # this stream's stepping ticks, their host seconds (each ends with
        # the read of done) and the seconds of their exchanges
        self.ticks, self.tick_s, self.exchange_s = 0, 0.0, 0.0

    # ------------------------------------------------------------ serving

    def tick(self, now: float = 0.0) -> list[SlotResult]:
        """Admit pending requests into free slots (DRR across tenants), run
        ``steps_per_sync`` lock-steps on every shard, exchange and merge at
        the sync point, retire every globally converged slot."""
        free = np.flatnonzero(self._slot_rid < 0)
        if len(free) and self._n_pending:
            Q_new = np.full((self.S, self.dim), 1.0 / self.dim, np.float32)
            write = np.zeros((self.S,), bool)
            for fi, req in enumerate(self._drr_select(len(free))):
                s = free[fi]
                Q_new[s] = req.q
                write[s] = True
                self._slot_rid[s] = req.rid
                self._meta[req.rid] = (req.t_arrival, now, req.tenant, req.priority)
            if write.any():
                self.state = self._admit(self.state, torch.as_tensor(Q_new, device=self._dev),
                                         torch.as_tensor(write, device=self._dev))
        if (self._background is not None and not self._n_pending
                and (self._slot_rid < 0).any()):
            # idle capacity this tick: the maintenance hook
            self._background()
        if not (self._slot_rid >= 0).any():
            return []

        t0, c0 = time.perf_counter(), collective_stats()["seconds"]
        self.state, done_g, evals_g, hops_g = self._step(self.state)
        finished = done_g.cpu().numpy() & (self._slot_rid >= 0)  # the tick's sync
        self.ticks += 1
        self.exchange_s += collective_stats()["seconds"] - c0
        self.tick_s += time.perf_counter() - t0
        if not finished.any():
            return []
        idx = np.flatnonzero(finished)
        rows = torch.as_tensor(idx, device=self._dev)
        st, k = self.state, self.k
        block = torch.cat([st.glob_d[rows].view(torch.int32), st.glob_i[rows],
                           evals_g[rows, None], hops_g[rows, None]], dim=1).cpu().numpy()
        d = np.ascontiguousarray(block[:, :k]).view(np.float32)
        ids = block[:, k:2 * k].astype(np.int64)
        out = []
        for j, s in enumerate(idx):
            rid = int(self._slot_rid[s])
            t_arr, t_adm, tenant, priority = self._meta.pop(rid, (0.0, 0.0, 0, 0))
            out.append(SlotResult(rid=rid, dists=d[j], ids=ids[j], n_evals=int(block[j, 2 * k]),
                                  hops=int(block[j, 2 * k + 1]), t_arrival=t_arr, t_admit=t_adm,
                                  tenant=tenant, priority=priority))
            self._slot_rid[s] = -1
        return out
