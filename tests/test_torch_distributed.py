"""Port parity: scatter-gather over shards (``repro_torch.core.distributed``)
against ``repro.core.distributed``, and serve's sharded path.

One JAX subprocess with 4 forced host devices (the count must be set
before JAX starts, as in ``tests/test_multidevice.py``) writes every
oracle: ``pad_to_shards``, ``sharded_knn_scan``, ``build_local_subgraphs``
(NN-descent and wave), ``sharded_graph_search`` and
``ShardedSlotScheduler`` at n = 512 and n = 509 (three rows of padding),
and the scheduler's options at n = 512: a self-built local subgraph with
``compact`` and ``max_steps`` set, ``tenant_weights``' DRR order on a
fixed-cost clock, and ``slo_ms`` (the scheduler's and a stream's), which
``repro``'s sharded tick carries on each request and does not enforce.
One spawn of 4 gloo ranks, one intra-op thread each, runs every port side
while the subprocess compiles its searches: the rows and ``repro``'s
adjacency (written first) are carried across by ``convert.shard_from_jax``
and the NN-descent draws are replayed from ``repro``'s key splits.  A
module fixture holds both; each case below reads them.

``background_fn``, which runs on the host clock's idle ticks, is checked
on one rank in this process.

Tolerances: ids, adjacency, evals and admission times exactly equal; searched distances
within rtol 1e-6 (float32 summation order); the exact scan's distances
within rtol 1e-4 and >= 0.98 of its ids equal, the tolerance of
``tests/test_multidevice.py`` (ties may reorder).
"""

import os
import pathlib
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as tmp

from repro_torch.convert import shard_from_jax
from repro_torch.core import distances as td
from repro_torch.core import distributed as tdd
from repro_torch.core.nndescent import NNDescentDraws

from test_torch_nndescent import replay_draws

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHARDS, N, N_ODD, DIM, NQ = 4, 512, 509, 16, 24
K, EF, NN, NND_ITERS, WAVE, KEY = 10, 64, 10, 6, 16, 5
SLOTS, STEPS = 4, 2
# the scheduler's options: frontier 4 makes compact bind (C = min(4 M, 48)
# against the default's 32), max_steps cuts the beams short; DRR weights 3:1
# over alternating tenants
COMPACT, MAX_STEPS, WEIGHTS = 48, 6, {0: 3.0, 1: 1.0}
# an SLO no request could meet: repro's sharded scheduler sheds nothing all the same
SLO_MS = 1e-6
TENANTS = [i % 2 for i in range(NQ)]
SEARCHES = {"f1": dict(), "f4": dict(frontier=4), "reference": dict(engine="reference"),
            "drop1": dict(drop_shards=1), "drop3": dict(drop_shards=3)}
# repro's reference engine equals its batched engine at frontier 1
# (tests/test_multidevice.py::test_sharded_graph_search_engines_agree): the
# port's reference engine is held to repro's frontier-1 search, one compile
# fewer here
JAX_SEARCHES = {name: kw for name, kw in SEARCHES.items() if name != "reference"}

# The graphs first, written to argv[1] (the port's ranks start from them
# while the searches compile here), then every oracle to argv[2].
JAX_ORACLES = f"""
import os, sys
import jax, numpy as np
from repro.core import get_distance
from repro.core.distributed import (ShardedSlotScheduler, build_local_subgraphs, pad_to_shards,
                                    sharded_graph_search, sharded_knn_scan)
from repro.data.synthetic import lda_like_histograms

def save(path, out):
    np.savez(path + ".tmp.npz", **{{k: np.asarray(v) for k, v in out.items()}})
    os.replace(path + ".tmp.npz", path)

mesh = jax.make_mesh(({SHARDS},), ("data",))
dist = get_distance("kl")
X = lda_like_histograms(jax.random.PRNGKey(0), {N}, {DIM})
Q = lda_like_histograms(jax.random.PRNGKey(1), {NQ}, {DIM})
key = jax.random.PRNGKey({KEY})
out = {{"X": X, "Q": Q}}
for n in ({N}, {N_ODD}):
    out[f"nnd{{n}}"] = build_local_subgraphs(mesh, dist, X[:n], NN={NN}, nnd_iters={NND_ITERS},
                                             key=key)
save(sys.argv[1], out)
for n in ({N}, {N_ODD}):
    Xn, nbrs = X[:n], out[f"nnd{{n}}"]
    Xp, n_real, n_local = pad_to_shards(Xn, {SHARDS})
    out[f"pad{{n}}"], out[f"pad{{n}}_meta"] = Xp, np.array([n_real, n_local])
    out[f"knn_d{{n}}"], out[f"knn_i{{n}}"] = sharded_knn_scan(mesh, dist, Q, Xn, {K})
    runs = {JAX_SEARCHES!r} if n == {N} else {{"f1": dict()}}
    for name, kw in runs.items():
        out[f"d_{{name}}{{n}}"], out[f"i_{{name}}{{n}}"], out[f"e_{{name}}{{n}}"] = (
            sharded_graph_search(mesh, dist, Q, Xn, nbrs, k={K}, ef={EF}, **kw))
    for drop in ((0, 1) if n == {N} else (0,)):
        sched = ShardedSlotScheduler(mesh, dist, Xn, neighbors=nbrs, slots={SLOTS}, ef={EF},
                                     k={K}, steps_per_sync={STEPS}, drop_shards=drop)
        res = sched.run_stream(np.asarray(Q))
        tag = f"sched{{n}}_drop{{drop}}"
        out[f"{{tag}}_i"] = np.stack([r.ids for r in res])
        out[f"{{tag}}_d"] = np.stack([r.dists for r in res])
        out[f"{{tag}}_e"] = np.asarray([r.n_evals for r in res])
sched = ShardedSlotScheduler(mesh, dist, X, slots={SLOTS}, ef={EF}, k={K}, frontier=4,
                             compact={COMPACT}, max_steps={MAX_STEPS}, steps_per_sync={STEPS},
                             NN={NN}, nnd_iters={NND_ITERS}, key=key)
res = sched.run_stream(np.asarray(Q))
out["opts_i"] = np.stack([r.ids for r in res])
out["opts_d"] = np.stack([r.dists for r in res])
out["opts_e"] = np.asarray([r.n_evals for r in res])
sched = ShardedSlotScheduler(mesh, dist, X, neighbors=out["nnd{N}"], slots={SLOTS}, ef={EF},
                             k={K}, tenant_weights={WEIGHTS!r}, slo_ms={SLO_MS})
res = sched.run_stream(np.asarray(Q), tenants={TENANTS!r}, tick_cost=1.0)
out["drr_i"] = np.stack([r.ids for r in res])
out["drr_t"] = np.asarray([[r.t_admit, r.t_done] for r in res])
res = sched.run_stream(np.asarray(Q), tick_cost=1.0, slo_ms={SLO_MS})
out["slo_i"] = np.stack([r.ids for r in res])
out["slo_t"] = np.asarray([[r.t_admit, r.t_done] for r in res])
out["slo_shed"] = np.asarray([r.shed for r in res])
out["wave{N}"] = build_local_subgraphs(mesh, dist, X, NN={NN}, builder="wave", wave={WAVE})
save(sys.argv[2], out)
"""


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the port's lock-step loops launch many tiny ops,
    and a thread pool per test worker oversubscribes the cores (~10x slower
    under parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draws(n: int):
    """Per shard: the NN-descent draws ``repro``'s ``build_local_subgraphs``
    takes from ``fold_in(key, shard)``, as numpy arrays."""
    n_local = -(-n // SHARDS)
    K_ = min(NN, n_local - 1)
    return [[np.asarray(a) for a in replay_draws(
        jax.random.fold_in(jax.random.PRNGKey(KEY), shard), n_local, K_, NND_ITERS, 8, 2 * K_)]
        for shard in range(SHARDS)]


def _rank_main(rank, store, graphs_path, draws, out_dir):
    """One rank of the spawned gloo group: every port side, results to
    ``out_dir/rank<r>.npz``."""
    torch.set_num_threads(1)
    tdd.init_group("gloo", f"file://{store}", rank, SHARDS, timeout_s=120)
    try:
        o = np.load(graphs_path)
        kl = td.get_distance("kl")
        Q = torch.from_numpy(o["Q"])
        out = {}
        for n in (N, N_ODD):
            X = torch.from_numpy(o["X"][:n])
            Xp, n_real, n_local = tdd.pad_to_shards(X, SHARDS)
            out[f"pad{n}"], out[f"pad{n}_meta"] = Xp.numpy(), np.array([n_real, n_local])
            X_local, n_real, _ = tdd.local_block(X, rank, SHARDS)
            d, i = tdd.sharded_knn_scan(kl, Q, X_local, K, n_real)
            out[f"knn_d{n}"], out[f"knn_i{n}"] = d.numpy(), i.numpy()
            nnd = tdd.build_local_subgraphs(
                kl, X_local, NN=NN, nnd_iters=NND_ITERS,
                nnd_draws=NNDescentDraws(*(torch.from_numpy(a) for a in draws[n][rank])))
            out[f"nnd{n}"] = nnd.numpy()  # this rank's block
            # the searches run on repro's adjacency, carried across
            blk = shard_from_jax({"X": o["X"][:n], "neighbors": o[f"nnd{n}"]}, rank, SHARDS,
                                 device="cpu")
            for name, kw in (SEARCHES.items() if n == N else [("f1", {})]):
                d, i, e = tdd.sharded_graph_search(kl, Q, blk.X, blk.neighbors, K, EF,
                                                   blk.n_real, **kw)
                out[f"d_{name}{n}"], out[f"i_{name}{n}"], out[f"e_{name}{n}"] = (
                    d.numpy(), i.numpy(), e.numpy())
            for drop in ((0, 1) if n == N else (0,)):
                sched = tdd.ShardedSlotScheduler(kl, blk.X, blk.neighbors, blk.n_real,
                                                 slots=SLOTS, ef=EF, k=K, steps_per_sync=STEPS,
                                                 drop_shards=drop)
                res = sched.run_stream(o["Q"])
                tag = f"sched{n}_drop{drop}"
                out[f"{tag}_i"] = np.stack([r.ids for r in res])
                out[f"{tag}_d"] = np.stack([r.dists for r in res])
                out[f"{tag}_e"] = np.asarray([r.n_evals for r in res])
                if n == N and drop == 0:
                    # a Poisson trace on the default measured virtual clock
                    arrivals = np.cumsum(np.random.default_rng(3).exponential(2e-3, NQ))
                    res = sched.run_stream(o["Q"], arrivals)
                    out["poisson_i"] = np.stack([r.ids for r in res])
                    out["poisson_e"] = np.asarray([r.n_evals for r in res])
                    out["poisson_t"] = np.asarray([[r.t_admit, r.t_done] for r in res])
                    out["poisson_last"] = arrivals[-1]
        blk = shard_from_jax({"X": o["X"][:N], "neighbors": o[f"nnd{N}"]}, rank, SHARDS,
                             device="cpu")
        sched = tdd.ShardedSlotScheduler(
            kl, blk.X, None, blk.n_real, slots=SLOTS, ef=EF, k=K, frontier=4, compact=COMPACT,
            max_steps=MAX_STEPS, steps_per_sync=STEPS, NN=NN, nnd_iters=NND_ITERS,
            nnd_draws=NNDescentDraws(*(torch.from_numpy(a) for a in draws[N][rank])))
        out["opts_nbrs"] = sched._neighbors.numpy()
        res = sched.run_stream(o["Q"])
        out["opts_i"] = np.stack([r.ids for r in res])
        out["opts_d"] = np.stack([r.dists for r in res])
        out["opts_e"] = np.asarray([r.n_evals for r in res])
        sched = tdd.ShardedSlotScheduler(kl, blk.X, blk.neighbors, blk.n_real, slots=SLOTS,
                                         ef=EF, k=K, tenant_weights=WEIGHTS, slo_ms=SLO_MS)
        res = sched.run_stream(o["Q"], tenants=TENANTS, tick_cost=1.0)
        out["drr_i"] = np.stack([r.ids for r in res])
        out["drr_t"] = np.asarray([[r.t_admit, r.t_done] for r in res])
        res = sched.run_stream(o["Q"], tick_cost=1.0, slo_ms=SLO_MS)
        out["slo_i"] = np.stack([r.ids for r in res])
        out["slo_t"] = np.asarray([[r.t_admit, r.t_done] for r in res])
        out["slo_shed"] = np.asarray([r.shed for r in res])
        X_local, _, _ = tdd.local_block(torch.from_numpy(o["X"]), rank, SHARDS)
        out[f"wave{N}"] = tdd.build_local_subgraphs(kl, X_local, NN=NN, builder="wave",
                                                    wave=WAVE).numpy()
        # four identical shards, the port's own draws (one generator per rank)
        out["same_rows"] = tdd.build_local_subgraphs(kl, torch.from_numpy(o["X"][:128]), NN=NN,
                                                     nnd_iters=2).numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        tdist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's oracles, [each rank's port results]).  The port's ranks run
    while the JAX subprocess compiles its searches."""
    tmp_path = tmp_path_factory.mktemp("distributed")
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    graphs, oracles = tmp_path / "graphs.npz", tmp_path / "jax.npz"
    with open(tmp_path / "jax.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", JAX_ORACLES, str(graphs), str(oracles)],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            draws = {n: _draws(n) for n in (N, N_ODD)}
            t0 = time.monotonic()
            while not graphs.exists():
                assert proc.poll() is None, (tmp_path / "jax.log").read_text()
                assert time.monotonic() - t0 < 600, "no JAX graphs after 600 s"
                time.sleep(0.2)
            tmp.start_processes(_rank_main, args=(str(tmp_path / "store"), str(graphs), draws,
                                                  str(tmp_path)),
                                nprocs=SHARDS, join=True, start_method="spawn")
            rc = proc.wait(timeout=600)
        finally:
            proc.kill()
    assert rc == 0, (tmp_path / "jax.log").read_text()
    return dict(np.load(oracles)), [dict(np.load(tmp_path / f"rank{r}.npz"))
                                    for r in range(SHARDS)]


@pytest.mark.parametrize("n", [N, N_ODD])
def test_pad_to_shards(runs, n):
    want, ranks = runs
    got = ranks[0]
    np.testing.assert_array_equal(got[f"pad{n}_meta"], want[f"pad{n}_meta"])
    np.testing.assert_array_equal(got[f"pad{n}"], want[f"pad{n}"])
    assert got[f"pad{n}"].shape[0] == 512
    if n == N:  # a no-op when the rows divide
        np.testing.assert_array_equal(got[f"pad{n}"], want["X"])


@pytest.mark.parametrize("n", [N, N_ODD])
def test_sharded_knn_scan(runs, n):
    want, ranks = runs
    got = ranks[0]
    np.testing.assert_allclose(got[f"knn_d{n}"], want[f"knn_d{n}"], rtol=1e-4)
    assert (got[f"knn_i{n}"] == want[f"knn_i{n}"]).mean() >= 0.98
    assert got[f"knn_i{n}"].min() >= 0 and got[f"knn_i{n}"].max() < n


@pytest.mark.parametrize("n", [N, N_ODD])
def test_build_local_subgraphs_nndescent_equals_repro(runs, n):
    want, ranks = runs
    got = np.concatenate([r[f"nnd{n}"] for r in ranks])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want[f"nnd{n}"])


def test_build_local_subgraphs_wave_equals_repro(runs):
    want, ranks = runs
    np.testing.assert_array_equal(np.concatenate([r[f"wave{N}"] for r in ranks]),
                                  want[f"wave{N}"])


def test_identical_shards_give_different_subgraphs(runs):
    """The per-rank seed decorrelates the draws, as ``fold_in(key, axis_index)``."""
    _, ranks = runs
    graphs = [r["same_rows"] for r in ranks]
    assert all(not np.array_equal(graphs[a], graphs[b])
               for a in range(SHARDS) for b in range(a + 1, SHARDS))


@pytest.mark.parametrize("case", [f"{name}{N}" for name in SEARCHES] + [f"f1{N_ODD}"])
def test_sharded_graph_search_equals_repro(runs, case):
    want, ranks = runs
    for r in ranks:  # replicated on every rank
        np.testing.assert_array_equal(r[f"i_{case}"], ranks[0][f"i_{case}"])
    got = ranks[0]
    oracle = case.replace("reference", "f1")  # see JAX_SEARCHES
    np.testing.assert_array_equal(got[f"i_{case}"], want[f"i_{oracle}"])
    np.testing.assert_array_equal(got[f"e_{case}"], want[f"e_{oracle}"])
    np.testing.assert_allclose(got[f"d_{case}"], want[f"d_{oracle}"], rtol=1e-6)


def test_sharded_graph_search_voiding(runs):
    """repro's voiding checks: padded ids never surface, dead shards' ids
    never surface and their evals are not billed, short rows pad (inf, -1)."""
    _, ranks = runs
    got = ranks[0]
    n_local = N // SHARDS
    assert got[f"i_f1{N_ODD}"].max() < N_ODD
    for row in got[f"i_f1{N_ODD}"]:
        assert len(np.unique(row[row >= 0])) == (row >= 0).sum()
    assert (got[f"e_drop1{N}"] < got[f"e_f1{N}"]).all()
    assert (got[f"i_drop1{N}"] < 3 * n_local).all()
    i3, d3 = got[f"i_drop3{N}"], got[f"d_drop3{N}"]
    assert (i3 < n_local).all() and ((i3 >= 0) == np.isfinite(d3)).all()
    assert (got[f"e_drop3{N}"] < got[f"e_drop1{N}"]).all()
    # the batched engine at frontier 1 equals the reference engine
    for key in ("i", "e"):
        np.testing.assert_array_equal(got[f"{key}_f1{N}"], got[f"{key}_reference{N}"])


@pytest.mark.parametrize("tag", [f"sched{N}_drop0", f"sched{N}_drop1", f"sched{N_ODD}_drop0"])
def test_sharded_scheduler_equals_repro(runs, tag):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r[f"{tag}_i"], ranks[0][f"{tag}_i"])
    got = ranks[0]
    np.testing.assert_array_equal(got[f"{tag}_i"], want[f"{tag}_i"])
    np.testing.assert_array_equal(got[f"{tag}_e"], want[f"{tag}_e"])
    np.testing.assert_allclose(got[f"{tag}_d"], want[f"{tag}_d"], rtol=1e-6)


@pytest.mark.parametrize("n,drop", [(N, 0), (N, 1), (N_ODD, 0)])
def test_sharded_scheduler_equals_the_one_shot_search(runs, n, drop):
    """Retired results do not depend on admission: bit-identical to the
    port's own one-shot sharded search at frontier 1."""
    _, ranks = runs
    got = ranks[0]
    one = "f1" if drop == 0 else f"drop{drop}"
    tag = f"sched{n}_drop{drop}"
    np.testing.assert_array_equal(got[f"{tag}_i"], got[f"i_{one}{n}"])
    np.testing.assert_array_equal(got[f"{tag}_e"], got[f"e_{one}{n}"])
    np.testing.assert_array_equal(got[f"{tag}_d"], got[f"d_{one}{n}"])


def test_poisson_trace_on_the_measured_clock(runs):
    """Each rank measures its own tick times; the clock, agreed while
    arrivals remain to be submitted, keeps the ranks admitting alike, so
    every rank retires the same results, equal to the all-at-once
    stream's, and stamps every time before the last arrival alike (after
    it each rank keeps its own clock)."""
    _, ranks = runs
    agreed = ranks[0]["poisson_t"] < ranks[0]["poisson_last"]
    assert agreed.any()
    for r in ranks:
        np.testing.assert_array_equal(r["poisson_i"], ranks[0]["poisson_i"])
        np.testing.assert_array_equal(r["poisson_e"], ranks[0]["poisson_e"])
        np.testing.assert_array_equal(r["poisson_t"][agreed], ranks[0]["poisson_t"][agreed])
    np.testing.assert_array_equal(ranks[0]["poisson_i"], ranks[0][f"sched{N}_drop0_i"])
    t = ranks[0]["poisson_t"]
    assert (t[:, 1] >= t[:, 0]).all()


def test_sharded_scheduler_options_equal_repro(runs):
    """A self-built local subgraph (the NN-descent draws replayed), with
    ``compact`` and ``max_steps`` set: the subgraph equals ``repro``'s, and
    the retired results equal its scheduler's; they differ from the
    defaults' (the options bind)."""
    want, ranks = runs
    np.testing.assert_array_equal(np.concatenate([r["opts_nbrs"] for r in ranks]),
                                  want[f"nnd{N}"])
    for r in ranks:
        np.testing.assert_array_equal(r["opts_i"], ranks[0]["opts_i"])
    got = ranks[0]
    np.testing.assert_array_equal(got["opts_i"], want["opts_i"])
    np.testing.assert_array_equal(got["opts_e"], want["opts_e"])
    np.testing.assert_allclose(got["opts_d"], want["opts_d"], rtol=1e-6)
    assert (got["opts_e"] != got[f"sched{N}_drop0_e"]).any()


def test_sharded_scheduler_tenant_weights_equal_repro(runs):
    """DRR at weights 3:1 over alternating tenants on a fixed-cost clock
    (the scheduler built with ``slo_ms``): every request's admission and
    retire time, and its ids, as ``repro``'s."""
    want, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r["drr_t"], ranks[0]["drr_t"])
    got = ranks[0]
    np.testing.assert_array_equal(got["drr_t"], want["drr_t"])
    np.testing.assert_array_equal(got["drr_i"], want["drr_i"])
    np.testing.assert_array_equal(got["drr_i"], got[f"sched{N}_drop0_i"])
    t_admit, tenants = got["drr_t"][:, 0], np.asarray(TENANTS)
    first = np.sort(t_admit)[NQ // 2]  # by the median admission, tenant 0 leads 3:1
    assert (t_admit[tenants == 0] <= first).sum() > (t_admit[tenants == 1] <= first).sum()


def test_sharded_slo_is_carried_as_repro_does(runs):
    """``slo_ms``, the scheduler's and a stream's, at a budget no request
    could meet: ``repro``'s sharded tick sheds nothing and serves every
    request in full, and so does the port's, with the same ids and times."""
    want, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r["slo_t"], ranks[0]["slo_t"])
    got = ranks[0]
    assert not want["slo_shed"].any() and not got["slo_shed"].any()
    np.testing.assert_array_equal(got["slo_t"], want["slo_t"])
    np.testing.assert_array_equal(got["slo_i"], want["slo_i"])
    np.testing.assert_array_equal(got["slo_i"], got[f"sched{N}_drop0_i"])


# ---------------------------------------------------------------------------
# one rank in this process: the refusals, the SLO's default and the idle hook
# ---------------------------------------------------------------------------


@pytest.fixture
def one_rank_group(tmp_path):
    tdd.init_group("gloo", f"file://{tmp_path / 'store'}", 0, 1, timeout_s=60)
    yield
    tdist.destroy_process_group()


def test_layout_and_argument_refusals(one_rank_group):
    kl = td.get_distance("kl")
    X = torch.full((40, 8), 1 / 8)
    nbrs = torch.zeros((40, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="neighbors rows 39"):
        tdd.sharded_graph_search(kl, X[:2], X, nbrs[:39], 2, 8, 40)
    with pytest.raises(ValueError, match="padded layout"):
        tdd.sharded_knn_scan(kl, X[:2], X, 2, 41)
    with pytest.raises(ValueError, match="unknown engine"):
        tdd.sharded_graph_search(kl, X[:2], X, nbrs, 2, 8, 40, engine="hnsw")
    with pytest.raises(ValueError, match="unknown builder"):
        tdd.build_local_subgraphs(kl, X, builder="hnsw")
    with pytest.raises(ValueError, match="drop_shards 1 outside"):
        tdd.ShardedSlotScheduler(kl, X, nbrs, 40, drop_shards=1)
    with pytest.raises(ValueError, match="ef 4 < k 10"):
        tdd.ShardedSlotScheduler(kl, X, nbrs, 40, ef=4)


def _one_rank_scheduler(**kw):
    rng = np.random.default_rng(0)
    X = torch.from_numpy(rng.dirichlet(np.full(16, 0.1), 300).astype(np.float32)).clamp(min=1e-6)
    Q = rng.dirichlet(np.full(16, 0.1), 24).astype(np.float32).clip(1e-6)
    kl = td.get_distance("kl")
    return tdd.ShardedSlotScheduler(kl, X, None, 300, slots=4, ef=32, k=5, NN=8, nnd_iters=3,
                                    **kw), Q


def test_sharded_slo_is_the_default_submit_stamps(one_rank_group):
    """``slo_ms`` becomes ``slo_s``, which ``submit`` stamps on a request that
    names no SLO of its own; the tick serves it in full all the same."""
    sched, Q = _one_rank_scheduler(slo_ms=1e-6)
    plain, _ = _one_rank_scheduler()
    assert sched.slo_s == 1e-6 / 1e3 and plain.slo_s is None
    sched.submit(Q[0])
    sched.submit(Q[1], slo_ms=5.0)
    queued = [req.slo_s for q in sched._queues[0].values() for req in q]
    assert queued == [1e-6 / 1e3, 5.0 / 1e3]
    res = sched.run_stream(Q)
    assert not any(r.shed for r in res)
    for r, w in zip(res, plain.run_stream(Q)):
        np.testing.assert_array_equal(r.ids, w.ids)


def test_sharded_background_fn_runs_on_idle_ticks(one_rank_group):
    calls = []
    sched, Q = _one_rank_scheduler(background_fn=lambda: calls.append(sched.n_pending))
    plain, _ = _one_rank_scheduler()
    arrivals = np.arange(len(Q)) * 10.0  # every request alone: idle gaps between them
    res = sched.run_stream(Q, arrivals)
    assert len(calls) >= len(Q) - 1 and set(calls) == {0}  # never with a request waiting
    for r, w in zip(res, plain.run_stream(Q, arrivals)):
        np.testing.assert_array_equal(r.ids, w.ids)


def test_shard_from_jax_validates_the_layout():
    X = np.full((10, 4), 0.25, np.float32)
    blk = shard_from_jax({"X": X, "neighbors": np.zeros((12, 3), np.int32)}, 3, 4, device="cpu")
    assert (blk.n_real, blk.n_local) == (10, 3) and blk.X.shape == (3, 4)
    with pytest.raises(ValueError, match="pad to 12"):
        shard_from_jax({"X": X, "neighbors": np.zeros((10, 3), np.int32)}, 0, 4, device="cpu")
    with pytest.raises(ValueError, match="local row ids"):
        shard_from_jax({"X": X, "neighbors": np.full((12, 3), 3, np.int32)}, 0, 4,
                       device="cpu")


def test_pick_backend_on_the_cpu():
    assert tdd.pick_backend(4, "cpu") == ("gloo", None)
    assert tdd.rank_device(3, "cpu") == torch.device("cpu")


# ---------------------------------------------------------------------------
# serve's sharded path
# ---------------------------------------------------------------------------


def test_serve_main_shards():
    from repro_torch.launch.serve import main

    st = main(["--shards", "2", "--device", "cpu", "--n-db", "600", "--queries", "32"])
    for key in ("shards", "n_db", "rows_per_shard", "build_s", "slots", "steps_per_sync",
                "drop_shards", "recall@k", "eval_reduction", "p50_ms", "p95_ms", "p99_ms",
                "replicated_recall@k", "recall_gap", "backend", "ranks_per_card"):
        assert key in st, key
    assert "step_executables" not in st and "admit_executables" not in st
    assert (st["shards"], st["rows_per_shard"], st["backend"]) == (2, 300, "gloo")
    assert st["recall@k"] >= 0.85 and st["recall_gap"] <= 0.005
    assert st["max_id"] < 600
    assert len(st["kernel_launches_by_rank"]) == 2


@pytest.mark.parametrize("flags", [["--spec", "TUNED_spec.json"], ["--continuous"],
                                   ["--churn-rounds", "2"], ["--slo-ms", "40"]])
def test_serve_shards_refuses_the_other_paths(flags, capsys):
    from repro_torch.launch.serve import main

    with pytest.raises(SystemExit):
        main(["--shards", "2", "--device", "cpu", *flags])
    assert "--shards is its own serving path" in capsys.readouterr().err
