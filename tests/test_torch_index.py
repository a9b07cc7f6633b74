"""Port parity for the slice as a whole: index, spec, ground truth, serving.

* A ``repro``-built index carried across by ``index_from_jax`` returns the
  same ids, eval counts and hops as ``repro``'s own searcher.
* The port's own NN-descent build (its own random draws) recalls within
  0.005 of ``repro``'s build on the same data.
* ``knn_scan`` ids are exactly equal; ``RetrievalSpec`` JSON and
  fingerprints are byte-identical.
* The legacy ``ANNIndex.build`` keyword arguments build what ``spec=`` builds
  (fingerprint, adjacency, entries), through the spec ``repro``'s shim folds.
* ``order_aware_recall`` and ``make_histogram_dataset`` equal ``repro``'s on
  its ids and its Dirichlet draws.
* The serve entry point runs end to end on the CPU when asked to.
* Nothing in ``src/repro_torch/`` or ``chip_smoke.py`` imports JAX or ``repro``.
"""

import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import ANNIndex, get_distance, knn_scan, recall_at_k
from repro.core import distances as jd
from repro.core import spec as jspec
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch import default_device, resolve_device
from repro_torch.convert import index_from_jax
from repro_torch.core import brute_force as tbf
from repro_torch.core import distances as td
from repro_torch.core import metrics as tmetrics
from repro_torch.core import spec as tspec
from repro_torch.core.index import ANNIndex as TIndex
from repro_torch.launch import serve as tserve

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_DB, N_Q, DIM, K = 2000, 200, 16, 10


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the port's lock-step loops launch many tiny ops,
    and a thread pool per test worker oversubscribes the cores (~10x slower
    under parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def data():
    X = lda_like_histograms(jax.random.PRNGKey(0), N_DB + N_Q, DIM)
    Q, db = split_queries(X, N_Q, jax.random.PRNGKey(1))
    return Q, db


@pytest.fixture(scope="module")
def jax_index(data):
    _, db = data
    spec = jspec.RetrievalSpec(distance="kl", builder="nndescent", frontier=4)
    return ANNIndex.build(db, spec=spec, key=jax.random.PRNGKey(2))


@pytest.fixture(scope="module")
def truth(data):
    Q, db = data
    return np.asarray(knn_scan(get_distance("kl"), Q, db, K)[1])


def test_index_from_jax_returns_the_same_ids(data, jax_index):
    Q, _ = data
    arrays = {a: np.asarray(getattr(jax_index, a)) for a in ("X", "neighbors", "entries")}
    tidx = index_from_jax(arrays, jax_index.spec.to_dict(), device="cpu")
    assert tidx.build_info.keys() == jax_index.build_info.keys()
    assert tidx.build_info["spec_fingerprint"] == jax_index.build_info["spec_fingerprint"]
    want = [np.asarray(a) for a in jax_index.searcher()(Q)]
    got = [a.numpy() for a in tidx.searcher()(_t(Q))]
    for name, g, w in zip(("ids", "evals", "hops"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    # one-shot search resolves the same knobs
    np.testing.assert_array_equal(tidx.search(_t(Q[:8]))[1].numpy(), want[1][:8])


def test_own_build_recalls_like_repro(data, jax_index, truth):
    Q, db = data
    want = recall_at_k(np.asarray(jax_index.searcher()(Q)[1]), truth)
    tidx = TIndex.build(_t(db), spec=tspec.RetrievalSpec.from_dict(jax_index.spec.to_dict()),
                        generator=torch.Generator().manual_seed(2))
    assert tidx.build_info.keys() == jax_index.build_info.keys()
    for key in ("builder", "build_engine", "wave", "index_sym", "query_sym", "NN",
                "ef_construction", "spec", "spec_fingerprint"):
        assert tidx.build_info[key] == jax_index.build_info[key], key
    got = tmetrics.recall_at_k(tidx.searcher()(_t(Q))[1], truth)
    assert got >= 0.9
    assert abs(got - want) <= 0.005, (got, want)


def test_legacy_build_kwargs_equal_the_spec_build(data):
    from repro.core.index import _legacy_spec as jax_legacy_spec

    _, db = data
    X, kl = _t(db[:500]), td.get_distance("kl")
    kw = dict(builder="nndescent", NN=8, nnd_iters=4, n_entries=2)
    spec = tspec.RetrievalSpec(distance="kl", **kw)
    legacy = TIndex.build(X, kl, generator=torch.Generator().manual_seed(3), **kw)
    direct = TIndex.build(X, spec=spec, generator=torch.Generator().manual_seed(3))
    assert legacy.spec == spec
    assert legacy.build_info["spec_fingerprint"] == direct.build_info["spec_fingerprint"]
    assert torch.equal(legacy.neighbors, direct.neighbors)
    assert torch.equal(legacy.entries, direct.entries)
    # repro's shim folds the same arguments into the same spec
    want = jax_legacy_spec(None, None, "nndescent", None, None, None, 8, None, None, 4, 2,
                           None).replace(distance="kl")
    assert legacy.build_info["spec_fingerprint"] == want.fingerprint()
    assert legacy.build_info["spec"] == want.to_dict()
    with pytest.warns(DeprecationWarning, match="index_sym/query_sym"):
        sym = TIndex.build(X, kl, index_sym="min", generator=torch.Generator().manual_seed(3),
                           **kw)
    with pytest.warns(DeprecationWarning, match="index_sym/query_sym"):  # repro's, alike
        want = jax_legacy_spec("min", None, "nndescent", None, None, None, 8, None, None, 4, 2,
                               None).replace(distance="kl")
    assert sym.build_info["spec_fingerprint"] == want.fingerprint()
    assert sym.build_info["index_sym"] == "min"
    with pytest.raises(ValueError, match="EITHER spec"):
        TIndex.build(X, spec=spec, NN=8)
    # the distance actually run names the spec, as repro records it
    assert TIndex.build(X, td.get_distance("l2"), NN=8, nnd_iters=2).spec.distance == "l2"


def test_order_aware_recall_equals_repro(data, jax_index, truth):
    from repro.core.metrics import order_aware_recall as jax_order_aware_recall

    Q, _ = data
    found = np.asarray(jax_index.searcher()(Q)[1])
    for f, t in ((found, truth), (truth, truth), (found[:, ::-1], truth),
                 (np.full_like(found, -1), truth)):
        assert tmetrics.order_aware_recall(_t(f), t) == jax_order_aware_recall(f, t)
    assert tmetrics.order_aware_recall(truth, truth) == pytest.approx(1.0)


class _Replay:
    """A stand-in for ``np.random.Generator`` whose ``dirichlet`` returns
    ``repro``'s draw for the same alpha (its ``jax.random.dirichlet``)."""

    def __init__(self, key):
        self.key = key

    def dirichlet(self, alpha, size):
        return np.asarray(jax.random.dirichlet(self.key, np.asarray(alpha, np.float32), (size,)))


@pytest.mark.parametrize("name", ["randhist-8", "wiki-8", "rcv-8"])
def test_make_histogram_dataset_equals_repro(name):
    from repro.data.synthetic import make_histogram_dataset as jax_make
    from repro_torch.data.synthetic import make_histogram_dataset

    key = jax.random.PRNGKey(4)
    got = make_histogram_dataset(name, _Replay(key), 300, 8, device="cpu")
    want = np.asarray(jax_make(name, key, 300, 8))
    assert got.dtype == torch.float32 and tuple(got.shape) == (300, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError):
        make_histogram_dataset("manner", np.random.default_rng(0), 3, 8, device="cpu")


@pytest.mark.parametrize("name", ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"])
def test_knn_scan_ids_exact(name, data):
    Q, db = data
    want_d, want_i = knn_scan(get_distance(name), Q[:64], db, K, chunk=512)
    got_d, got_i = tbf.knn_scan(td.get_distance(name), _t(Q[:64]), _t(db), K, chunk=512)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)
    g2 = tbf.ground_truth(td.get_distance(name), _t(Q[:64]), _t(db), K)[1]
    np.testing.assert_array_equal(g2.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("mode", ["left", "right"])
@pytest.mark.parametrize("name", ["kl", "itakura_saito", "renyi_0.25", "l2", "negdot"])
def test_knn_scan_through_query_distance_matrix(name, mode, data, monkeypatch):
    """Every chunk goes through ops.query_distance_matrix (the card's
    distance_matrix kernel), in both modes, and the ids equal repro's."""
    from repro_torch.kernels import ops

    Q, db = data
    calls = []
    real = ops.query_distance_matrix
    monkeypatch.setattr(tbf, "query_distance_matrix",
                        lambda *a, **k: calls.append(k.get("mode")) or real(*a, **k))
    want_d, want_i = knn_scan(get_distance(name), Q[:64], db, K, chunk=512, mode=mode)
    got_d, got_i = tbf.knn_scan(td.get_distance(name), _t(Q[:64]), _t(db), K, chunk=512,
                                mode=mode)
    assert calls == [mode] * -(-db.shape[0] // 512)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-5, atol=1e-5)


def test_knn_scan_restores_the_callers_tf32_setting():
    tf32, precision = torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        X = torch.rand(50, 8)
        tbf.knn_scan(td.get_distance("l2"), X[:4], X, 3)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)


def test_synthetic_histograms_and_split():
    from repro_torch.data import synthetic as ts

    for make in (ts.random_histograms, lambda r, n, d, device: ts.lda_like_histograms(
            r, n, d, alpha=0.08, device=device)):
        X = make(np.random.default_rng(3), 500, 24, device="cpu")
        assert X.dtype == torch.float32 and X.shape == (500, 24)
        assert float(X.min()) >= 1e-6 * 0.99
        torch.testing.assert_close(X.sum(1), torch.ones(500), rtol=0, atol=1e-5)
        torch.testing.assert_close(make(np.random.default_rng(3), 500, 24, device="cpu"), X)
    Q, rest = ts.split_queries(X, 40, np.random.default_rng(0))
    assert Q.shape == (40, 24) and rest.shape == (460, 24)
    # a permutation: every row lands in exactly one side
    both = torch.cat([Q, rest]).numpy()
    assert len({r.tobytes() for r in both}) == len({r.tobytes() for r in X.numpy()})


def test_metrics_match():
    from repro.core import metrics as jm

    rng = np.random.default_rng(0)
    found = rng.integers(-1, 30, (12, 10))
    true = rng.integers(0, 30, (12, 10))
    assert tmetrics.recall_at_k(torch.from_numpy(found), true) == jm.recall_at_k(found, true)
    evals = rng.integers(50, 400, 12)
    assert tmetrics.speedup_model(5000, torch.from_numpy(evals)) == jm.speedup_model(5000, evals)


SPECS = [
    {},
    {"distance": "renyi_0.25", "ef_search": 64, "frontier": 4},
    {"builder": "swgraph", "build_engine": "sequential", "M_max": 24, "wave": 16},
    {"build_policy": "blend(0.25)", "search_policy": "min", "k_c": 40, "adaptive": True},
]


@pytest.mark.parametrize("changes", SPECS, ids=["default", "renyi", "swgraph", "policies"])
def test_spec_json_and_fingerprint_byte_identical(changes):
    j = jspec.RetrievalSpec(**changes)
    t = tspec.RetrievalSpec(**changes)
    assert t.to_json() == j.to_json()
    assert t.fingerprint() == j.fingerprint()
    assert tspec.RetrievalSpec.from_json(j.to_json()) == t
    assert tspec.RetrievalSpec.from_dict(t.to_dict()).replace(k=12).k == 12


def test_spec_validation_matches():
    for bad in ({"builder": "hnsw"}, {"engine": "x"}, {"ef_search": 0}, {"k_c": 3},
                {"build_policy": "blend(2)"}):
        with pytest.raises(ValueError):
            jspec.RetrievalSpec(**bad)
        with pytest.raises(ValueError):
            tspec.RetrievalSpec(**bad)
    with pytest.raises(ValueError):
        tspec.RetrievalSpec.from_dict({"nope": 1})


@pytest.mark.parametrize("text", ["none", "avg", "min", "reverse", "l2", "natural", "max",
                                  "blend(0.25)", "rankblend(0.5)", "rankblend(0.5,2.0)",
                                  "learned(0123456789ab)"])
def test_policy_round_trip_and_bind(text):
    t = tspec.DistancePolicy.parse(text)
    j = jspec.DistancePolicy.parse(text)
    assert str(t) == str(j) == text
    assert tspec.DistancePolicy.parse(str(t)) == t
    assert t.is_none == j.is_none == (text == "none")
    base = td.get_distance("kl")
    if t.is_none:
        assert t.bind(base) is base
    elif text == "natural":  # needs a dataset-supplied distance in both packages
        for p, b in ((t, base), (j, jd.get_distance("kl"))):
            with pytest.raises(ValueError, match="natural"):
                p.bind(b)
    elif text.startswith("learned"):  # no weights registered under this ref
        for p, b in ((t, base), (j, jd.get_distance("kl"))):
            with pytest.raises(KeyError, match="no learned weights"):
                p.bind(b)
    else:
        assert t.bind(base).name == j.bind(jd.get_distance("kl")).name


def test_unported_paths_raise_naming_their_roadmap_item(data, tmp_path):
    _, db = data
    X = _t(db)[:200]
    # online mutation (ROADMAP M11) is ported: a capacity spec builds a mutable index
    mutable = TIndex.build(X, spec=tspec.RetrievalSpec(capacity=400, NN=8, nnd_iters=2))
    assert mutable.online is not None and mutable.online.capacity == mutable.capacity == 400
    idx = TIndex.build(X, spec=tspec.RetrievalSpec(NN=8, nnd_iters=2))
    # the slot scheduler (ROADMAP M12) is ported: with no refill it serves the
    # searcher's results
    res = idx.scheduler(slots=8, frontier=idx.spec.frontier).run_stream(X[:8])
    _, ids, n_evals, _ = idx.searcher()(X[:8])
    assert [r.ids.tolist() for r in res] == ids.tolist()
    assert [r.n_evals for r in res] == n_evals.tolist()
    with pytest.raises(ValueError, match="adaptive"):
        idx.searcher(engine="reference", adaptive=True)
    with pytest.raises(ValueError, match="unknown engine"):
        idx.searcher(engine="beam")
    # rerank (ROADMAP M8) is ported: k_c without a search policy is ignored, as in repro
    Q = X[:8]
    for a, b in zip(idx.searcher(k_c=20)(Q), idx.searcher()(Q)):
        assert torch.equal(a, b)
    # ensure_online converts lazily (2 n by default) and serves the same ids
    want = idx.searcher()(Q)
    online = idx.ensure_online()
    assert online.capacity == 400 and idx.ensure_online() is online
    for a, b in zip(idx.searcher()(Q), want):
        assert torch.equal(a, b)
    # the model/training substrate off the mesh is ported (M17's LM, MoE, GNN and
    # recsys items); the mesh waits for ROADMAP M17's sharding item
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.base import MoEConfig
    from repro_torch.data.synthetic import recsys_batch
    from repro_torch.launch import train as ttrain
    from repro_torch.models import gnn as tgnn
    from repro_torch.models import moe as tmoe
    from repro_torch.models import recsys as trecsys
    from repro_torch.models import transformer as ttransformer
    from repro_torch.train.train_step import recsys_loss

    # the other recsys models and the paper's retrieval configs resolve (M17's recsys
    # item): each family as repro's, the ranking models train through the launcher
    for arch, family in (("din", "recsys"), ("dcn-v2", "recsys"), ("autoint", "recsys"),
                         ("swgraph-retrieval", "retrieval")):
        assert configs.get_family(arch) == family
        assert configs.get_config(arch).name == ("wiki128-kl" if family == "retrieval"
                                                 else arch)
        assert configs.get_smoke_config(arch).name.endswith("smoke")
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    smoke = configs.get_smoke_config("two-tower-retrieval")
    for interaction, arch in (("self-attn", "autoint"), ("target-attn", "din"),
                              ("cross", "dcn-v2")):
        cfg = configs.get_smoke_config(arch)
        assert cfg.interaction == interaction
        model = trecsys.init_params(cfg, device="cpu")
        batch = recsys_batch(np.random.default_rng(0), 8, cfg.vocab_sizes, "cpu",
                             n_dense=cfg.n_dense, seq_len=cfg.seq_len)
        loss, _ = recsys_loss(model, batch, cfg)
        assert torch.isfinite(loss)
        with pytest.raises(ValueError):  # the ranking models have no towers
            trecsys.init_params(dataclasses.replace(smoke, interaction=interaction + "?"),
                                device="cpu")
    with pytest.raises(SystemExit, match="family retrieval"):
        ttrain.main(["--device", "cpu", "--arch", "swgraph-retrieval", "--smoke", "--steps", "1"])
    # the MoE LMs and the GCN are ported (M17's MoE and GNN items): an MoE variant of a
    # dense config initialises with the MoE layer's names, and the three archs resolve
    moe = dataclasses.replace(configs.get_smoke_config("llama3.2-1b"),
                              moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32))
    moe_lm = ttransformer.init_params(moe, device="cpu")
    assert {"router", "e_gate", "e_up", "e_down"} <= set(moe_lm.layers)
    assert "w_gate" not in moe_lm.layers
    assert sum(p.numel() for p in moe_lm.parameters()) == moe.n_params()
    for arch, family in (("phi3.5-moe-42b-a6.6b", "lm"), ("kimi-k2-1t-a32b", "lm"),
                         ("gcn-cora", "gnn")):
        assert configs.get_family(arch) == family
        assert configs.get_config(arch).name == arch
    assert tgnn.init_params(configs.get_smoke_config("gcn-cora"), device="cpu") is not None
    # the mesh is ported (M17's sharding item): the mesh-only pieces run on a
    # world-1 gloo mesh, where each equals its off-mesh path
    import torch.distributed as tdist

    from repro_torch.sharding.api import P, Mesh, use_mesh

    tdist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                             world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"))
        expert = P(None, "model", "data", None)
        assert tmoe.moe_layer_specs(moe)["e_gate"] == expert
        assert ttransformer.param_specs(moe)["layers"]["e_gate"] == expert
        assert tgnn.param_specs(configs.get_smoke_config("gcn-cora"))["w"][0] == P(None, None)
        assert trecsys.param_specs(configs.get_smoke_config("din"))["table"] == P(
            ("model", "data"), None)
        lp = {k: w[0] for k, w in moe_lm.layers.items()}
        h = torch.randn((2, 4, moe.d_model), generator=torch.Generator().manual_seed(0))
        with use_mesh(mesh):
            got = tmoe.moe_ffn(h, lp, moe)
        for a, b in zip(got, tmoe.moe_ffn(h, lp, moe)):
            torch.testing.assert_close(a, b)
        # the dense LM's sequence-parallel decode over the mesh equals the local one
        dense = configs.get_smoke_config("llama3.2-1b")
        lm = ttransformer.init_params(dense, device="cpu")
        caches = [ttransformer.init_kv_cache(dense, 1, 4, device="cpu") for _ in range(2)]
        with use_mesh(mesh):
            on_mesh, _ = ttransformer.decode_step(lm, caches[0], torch.zeros(1, dtype=torch.long),
                                                  dense, mesh=mesh)
        off_mesh, _ = ttransformer.decode_step(lm, caches[1], torch.zeros(1, dtype=torch.long),
                                               dense)
        torch.testing.assert_close(on_mesh, off_mesh)
        torch.testing.assert_close(caches[0]["k"], caches[1]["k"])
        assert ttransformer.kv_cache_specs()["k"] == P(None, ("data",), ("model",), None, None)
    finally:
        tdist.destroy_process_group()


def test_m9_gate_kl_4096_equals_repro():
    """ROADMAP M9's gate at its workload, the ``bench_spec`` cell (KL,
    n = 4,096, d = 32, SW-graph wave 64, NN 15, frontier 1): the port's own
    ``ANNIndex.build`` gives repro's adjacency, and with repro's entry draws
    replayed ``searcher()`` returns repro's ids, evals and hops."""
    key = jax.random.PRNGKey(0)
    data = lda_like_histograms(key, 4096 + 128, 32)
    Q, X = split_queries(data, 128, jax.random.fold_in(key, 1))
    changes = dict(distance="kl", builder="swgraph", build_engine="wave", wave=64, NN=15,
                   ef_construction=100, k=10, frontier=1)
    jidx = ANNIndex.build(X, spec=jspec.RetrievalSpec(**changes), key=jax.random.fold_in(key, 2))
    tidx = TIndex.build(_t(X), spec=tspec.RetrievalSpec(**changes))
    np.testing.assert_array_equal(tidx.neighbors.numpy(), np.asarray(jidx.neighbors))
    tidx.entries = _t(jidx.entries)  # repro's entry draws (jax.random) replayed
    want = [np.asarray(a) for a in jidx.searcher()(Q)]
    got = [a.numpy() for a in tidx.searcher()(_t(Q))]
    for name, g, w in zip(("ids", "evals", "hops"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


N_SW = 300
SW_SPEC = dict(distance="kl", builder="swgraph", NN=8, ef_construction=40, wave=16,
               ef_search=48, frontier=4)


@pytest.mark.parametrize("build_engine", ["wave", "sequential"])
def test_swgraph_index_matches_jax(build_engine, data):
    """``builder="swgraph"``: the same adjacency and build_info as ``repro``;
    with ``repro``'s entries carried across, both engines return ``repro``'s
    ids, eval counts and hops."""
    Q, db = data
    db = db[:N_SW]
    changes = dict(SW_SPEC, build_engine=build_engine)
    jidx = ANNIndex.build(db, spec=jspec.RetrievalSpec(**changes))
    tidx = TIndex.build(_t(db), spec=tspec.RetrievalSpec(**changes))
    np.testing.assert_array_equal(tidx.neighbors.numpy(), np.asarray(jidx.neighbors))
    for key in ("builder", "build_engine", "wave", "NN", "ef_construction", "mean_degree",
                "spec", "spec_fingerprint"):
        assert tidx.build_info[key] == jidx.build_info[key], key
    tidx.entries = _t(jidx.entries)
    assert tidx.entry == jidx.entry
    for engine in ("batched", "reference"):
        want = [np.asarray(a) for a in jidx.searcher(engine=engine)(Q[:32])]
        got = [a.numpy() for a in tidx.searcher(engine=engine)(_t(Q[:32]))]
        for name, g, w in zip(("ids", "evals", "hops"), got[1:], want[1:]):
            np.testing.assert_array_equal(g, w, err_msg=f"{engine} {name}")
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_index_from_jax_carries_a_swgraph_index(data):
    Q, db = data
    jidx = ANNIndex.build(db[:N_SW], spec=jspec.RetrievalSpec(**SW_SPEC, engine="reference"))
    arrays = {a: np.asarray(getattr(jidx, a)) for a in ("X", "neighbors", "entries")}
    tidx = index_from_jax(arrays, jidx.spec.to_dict(), device="cpu")
    assert tidx.build_info["build_engine"] == "wave" and tidx.build_info["wave"] == 16
    want = [np.asarray(a) for a in jidx.searcher()(Q[:32])]
    got = [a.numpy() for a in tidx.searcher()(_t(Q[:32]))]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g, w)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        tserve.build_and_serve(n_db=100, n_queries=8)
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_main_on_cpu():
    stats = tserve.main(["--device", "cpu", "--n-db", "2000", "--queries", "96",
                         "--batch", "32", "--ef", "64", "--frontier", "4", "--seed", "1"])
    assert stats["device"] == "cpu"
    assert stats["served"] == 96
    assert stats["recall@k"] >= 0.9
    assert stats["eval_reduction"] > 1.0
    assert stats["build_kernel_launches"] == stats["search_kernel_launches"] == 0
    assert stats["spec"]["builder"] == "nndescent"


@pytest.mark.parametrize("engine,build_engine", [("batched", "wave"),
                                                 ("reference", "sequential")])
def test_serve_main_swgraph_on_cpu(engine, build_engine):
    stats = tserve.main(["--device", "cpu", "--builder", "swgraph", "--wave", "32",
                         "--build-engine", build_engine, "--engine", engine,
                         "--n-db", "300", "--queries", "32", "--batch", "32", "--ef", "48",
                         "--seed", "1"])
    assert stats["builder"] == "swgraph" and stats["build_engine"] == build_engine
    assert stats["engine"] == engine and stats["spec"]["wave"] == 32
    assert stats["recall@k"] >= 0.9
    assert stats["kernel_launches"]["build"] == dict.fromkeys(
        ("frontier_scores", "two_hop_scores", "gather_scores", "distance_matrix"), 0)


def test_serve_main_takes_a_spec():
    spec = tspec.RetrievalSpec(distance="renyi_0.25", NN=10, nnd_iters=4, ef_search=48,
                               frontier=2)
    stats = tserve.main(["--device", "cpu", "--n-db", "800", "--queries", "32",
                         "--batch", "32", "--spec", spec.to_json()])
    assert stats["spec"] == spec.to_dict()
    assert stats["spec_fingerprint"] == spec.fingerprint()
    assert stats["recall@k"] >= 0.9


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f.relative_to(ROOT)} imports {mod}"
