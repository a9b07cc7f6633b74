"""Port parity for the GCN (``repro_torch.models.gnn``, ``gnn_loss``,
``convert.gnn_params_from_jax``, ``data.synthetic.random_graph``).

Against ``repro`` on the same arrays (``repro``'s ``random_graph`` and
``init_params`` carried across as numpy): ``gcn_aggregate`` for the ``sym``
norm and the ``mean``, ``max`` and ``sum`` aggregators on a graph with
isolated nodes; ``forward``, ``loss_fn`` with and without a mask,
``graph_classify_loss`` and their gradients (rtol = atol = 1e-5: segment sums
of a few float32 terms); ``build_csr`` exactly, nodes above ``max_degree``
included; ``sample_subgraph`` with ``repro``'s picks replayed (equal nodes and
edges) and ``sampled_forward``; five AdamW train steps (parameters within
2e-6, the two-tower gate's tolerance); ``launch.train.main`` exits for the
``gnn`` family as ``repro``'s does.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import random_graph as jax_random_graph
from repro.models import gnn as jgnn
from repro.train import optimizer as jopt
from repro.train.train_step import gnn_loss as jax_gnn_loss
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config, get_family, get_smoke_config
from repro_torch.convert import gnn_params_from_jax
from repro_torch.data.synthetic import random_graph
from repro_torch.models import gnn as tgnn
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import gnn_loss, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)
NORMS = [("sym", "mean"), ("none", "mean"), ("none", "max"), ("none", "sum")]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(seed=0, n=50, e=200, cfg=None):
    """``repro``'s random graph as numpy, and the same as CPU tensors."""
    cfg = cfg or jax_smoke_config("gcn-cora")
    g = {k: np.asarray(v) for k, v in jax_random_graph(
        jax.random.PRNGKey(seed), n_nodes=n, n_edges=e, d_feat=cfg.d_feat,
        n_classes=cfg.n_classes).items()}
    return g, {k: torch.from_numpy(np.array(v)) for k, v in g.items()}


def _params(cfg, jcfg, seed=1):
    jparams = jgnn.init_params(jcfg, jax.random.PRNGKey(seed))
    return jparams, gnn_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _assert_grads(model, jgrads, tol=TOL):
    got = dict(model.named_parameters())
    want = {f"{part}.{i}": a for part in ("w", "b") for i, a in enumerate(jgrads[part])}
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), **tol, err_msg=name)


def test_configs_mirror_repro():
    from repro.configs import get_config as jax_get_config
    from repro.configs.gcn_cora import with_shape as jax_with_shape
    from repro_torch.configs.gcn_cora import with_shape

    assert get_family("gcn-cora") == "gnn"
    # the fields the port reads; repro's dropout is read by neither package
    read = [f.name for f in dataclasses.fields(get_config("gcn-cora"))]
    assert read == ["name", "n_layers", "d_hidden", "d_feat", "n_classes", "aggregator", "norm"]
    for mine, theirs in ((get_config("gcn-cora"), jax_get_config("gcn-cora")),
                         (get_smoke_config("gcn-cora"), jax_smoke_config("gcn-cora")),
                         (with_shape(100, 47), jax_with_shape(100, 47))):
        assert {k: getattr(mine, k) for k in read} == {k: getattr(theirs, k) for k in read}


@pytest.mark.parametrize("norm,aggregator", NORMS)
def test_gcn_aggregate_matches_repro(norm, aggregator):
    """Nodes 30-39 have no in-edges (their aggregate is 0 under every rule),
    node 35 no edge at all; features of both signs."""
    rng = np.random.default_rng(0)
    n, e, d = 40, 150, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    senders = rng.integers(0, n, e).astype(np.int32)
    senders[senders == 35] = 0
    receivers = rng.integers(0, 30, e).astype(np.int32)
    want = jgnn.gcn_aggregate(jnp.asarray(x), jnp.asarray(senders), jnp.asarray(receivers), n,
                              norm=norm, aggregator=aggregator)
    got = tgnn.gcn_aggregate(torch.from_numpy(x), torch.from_numpy(senders),
                             torch.from_numpy(receivers), n, norm=norm, aggregator=aggregator)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not got[30:].any()


@pytest.mark.parametrize("norm,aggregator", NORMS)
def test_forward_loss_and_gradients_match_repro(norm, aggregator):
    jcfg = dataclasses.replace(jax_smoke_config("gcn-cora"), norm=norm, aggregator=aggregator)
    cfg = dataclasses.replace(get_smoke_config("gcn-cora"), norm=norm, aggregator=aggregator)
    g, tg = _graph()
    jparams, model = _params(cfg, jcfg)
    np.testing.assert_allclose(tgnn.forward(model, tg, cfg).detach().numpy(),
                               np.asarray(jgnn.forward(jparams, g, jcfg)), **TOL)
    mask = (np.arange(50) % 3 == 0).astype(np.float32)
    for m in (None, mask):
        jl, jgrads = jax.value_and_grad(
            lambda p: jgnn.loss_fn(p, g, jcfg, mask=None if m is None else jnp.asarray(m)))(
                jparams)
        model.zero_grad()
        tl = tgnn.loss_fn(model, tg, cfg, mask=None if m is None else torch.from_numpy(m))
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
        _assert_grads(model, jgrads)


def test_graph_classify_loss_matches_repro():
    """The molecule shape cut down: 6 graphs of 7 nodes and 12 edges each,
    block-diagonal over one flat node array."""
    jcfg, cfg = jax_smoke_config("gcn-cora"), get_smoke_config("gcn-cora")
    rng = np.random.default_rng(3)
    n_g, n_per, e_per = 6, 7, 12
    offsets = np.repeat(np.arange(n_g) * n_per, e_per)
    batch = {"features": rng.standard_normal((n_g * n_per, cfg.d_feat)).astype(np.float32),
             "senders": (rng.integers(0, n_per, n_g * e_per) + offsets).astype(np.int32),
             "receivers": (rng.integers(0, n_per, n_g * e_per) + offsets).astype(np.int32),
             "graph_ids": np.repeat(np.arange(n_g), n_per).astype(np.int32),
             "graph_labels": rng.integers(0, cfg.n_classes, n_g).astype(np.int32)}
    jparams, model = _params(cfg, jcfg, seed=4)
    (jl, jaux), jgrads = jax.value_and_grad(
        lambda p: jgnn.graph_classify_loss(p, batch, jcfg), has_aux=True)(jparams)
    tl, taux = tgnn.graph_classify_loss(model, {k: torch.from_numpy(v) for k, v in
                                                batch.items()}, cfg)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]), **TOL)
    _assert_grads(model, jgrads)


def test_build_csr_matches_repro_exactly():
    # the overflow case: node 0's in-degree 6 > max_degree 4 loses its last kept
    # neighbour to the -1 that repro's duplicate writes leave in the last column
    senders = np.array([10, 11, 12, 13, 14, 15, 20, 21], np.int32)
    receivers = np.array([0] * 6 + [1, 1], np.int32)
    want = np.asarray(jgnn.build_csr(jnp.asarray(senders), jnp.asarray(receivers), 3, 4))
    got = tgnn.build_csr(torch.from_numpy(senders), torch.from_numpy(receivers), 3, 4)
    np.testing.assert_array_equal(want[0], [10, 11, 12, -1])
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32
    # a skewed random graph: hubs far above the width, rows of every length
    g, tg = _graph(seed=5, n=80, e=900)
    for max_degree in (4, 16, 64):
        want = jgnn.build_csr(jnp.asarray(g["senders"]), jnp.asarray(g["receivers"]), 80,
                              max_degree)
        got = tgnn.build_csr(tg["senders"], tg["receivers"], 80, max_degree)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    deg = np.bincount(g["receivers"], minlength=80)
    assert (deg > 16).any() and (deg < 16).any()


def _repro_picks(key, n_seed, fanouts, max_degree):
    """The column draws of ``repro``'s ``sample_subgraph``, hop by hop."""
    picks, f = [], n_seed
    for fan in fanouts:
        key, k = jax.random.split(key)
        picks.append(np.array(jax.random.randint(k, (f, fan), 0, max_degree)))
        f *= fan
    return picks


def test_sample_subgraph_replays_repro_and_sampled_forward_matches():
    jcfg, cfg = jax_smoke_config("gcn-cora"), get_smoke_config("gcn-cora")
    g, tg = _graph(seed=0, n=80, e=400)
    table = jgnn.build_csr(jnp.asarray(g["senders"]), jnp.asarray(g["receivers"]), 80, 16)
    ttable = tgnn.build_csr(tg["senders"], tg["receivers"], 80, 16)
    seeds = np.arange(8, dtype=np.int32)
    key, fanouts = jax.random.PRNGKey(1), (4, 3)
    sub = {k: np.asarray(v) for k, v in
           jgnn.sample_subgraph(key, table, jnp.asarray(seeds), fanouts).items()}
    picks = [torch.from_numpy(p) for p in _repro_picks(key, 8, fanouts, 16)]
    tsub = tgnn.sample_subgraph(None, ttable, torch.from_numpy(seeds), fanouts, picks=picks)
    for name in ("nodes", "senders", "receivers"):
        np.testing.assert_array_equal(tsub[name].numpy(), sub[name], err_msg=name)
    assert (sub["senders"] == sub["receivers"]).any()  # a pad became a self edge

    jparams, model = _params(cfg, jcfg, seed=2)
    (jl, jlogits), jgrads = jax.value_and_grad(
        lambda p: jgnn.sampled_forward(p, g["features"], g["labels"], sub, jcfg, n_seed=8),
        has_aux=True)(jparams)
    tl, tlogits = tgnn.sampled_forward(model, tg["features"], tg["labels"], tsub, cfg,
                                       n_seed=8)
    tl.backward()
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    _assert_grads(model, jgrads)
    # drawn from a generator: the same seed gives the same subgraph, pads become self edges
    a, b = (tgnn.sample_subgraph(torch.Generator().manual_seed(7), ttable,
                                 torch.from_numpy(seeds), fanouts) for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["senders"].shape == (8 * 4 + 8 * 4 * 3,) and (a["senders"] >= 0).all()


def test_five_train_steps_match_repro():
    jcfg, cfg = jax_smoke_config("gcn-cora"), get_smoke_config("gcn-cora")
    g, tg = _graph()
    jparams, model = _params(cfg, jcfg)
    sched = (1e-2, 2, 5)
    jo, to = jopt.adamw(jopt.warmup_cosine(*sched)), topt.adamw(topt.warmup_cosine(*sched))
    jstep = jax.jit(jax_make_train_step(lambda p, b: jax_gnn_loss(p, b, jcfg), jo))
    tstep = make_train_step(lambda m, b: gnn_loss(m, b, cfg), to)
    jstate, tstate = jo.init(jparams), to.init(dict(model.named_parameters()))
    losses = []
    for _ in range(5):
        jparams, jstate, jm = jstep(jparams, jstate, g)
        model, tstate, tm = tstep(model, tstate, tg)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        losses.append(float(tm["loss"]))
    assert losses[-1] < losses[0]
    for part in ("w", "b"):
        for i, want in enumerate(jparams[part]):
            np.testing.assert_allclose(getattr(model, part)[i].detach().numpy(),
                                       np.asarray(want), **STEP_TOL, err_msg=f"{part}.{i}")


def test_train_main_exits_for_the_gnn_family_as_repro(monkeypatch):
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import main

    argv = ["--arch", "gcn-cora", "--smoke", "--steps", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as want:
        jax_main()
    with pytest.raises(SystemExit) as got:
        main(["--device", "cpu"] + argv)
    assert str(got.value) == str(want.value) == "use examples/ for family gnn"


def test_random_graph_dtypes_ranges_and_skew():
    g = random_graph(np.random.default_rng(0), 1000, 20_000, 6, n_classes=5, device="cpu")
    assert g["senders"].dtype == g["receivers"].dtype == g["labels"].dtype == torch.int32
    assert g["features"].dtype == torch.float32 and g["features"].shape == (1000, 6)
    for k in ("senders", "receivers"):
        assert g[k].shape == (20_000,) and 0 <= int(g[k].min()) and int(g[k].max()) < 999
    assert 0 <= int(g["labels"].min()) and int(g["labels"].max()) < 5
    # E[u^1.5] = 0.4 against E[u] = 0.5; the features' std 0.5
    assert abs(g["senders"].float().mean() / 999 - 0.4) < 0.01
    assert abs(g["receivers"].float().mean() / 999 - 0.5) < 0.01
    assert abs(float(g["features"].std()) - 0.5) < 0.01
    again = random_graph(np.random.default_rng(0), 1000, 20_000, 6, n_classes=5, device="cpu")
    assert all(torch.equal(g[k], again[k]) for k in g)


def test_params_conversion_and_mesh_paths():
    jcfg, cfg = jax_smoke_config("gcn-cora"), get_smoke_config("gcn-cora")
    jparams, model = _params(cfg, jcfg)
    assert sum(p.numel() for p in model.parameters()) == sum(
        p.size for p in jax.tree.leaves(jparams))
    fresh = tgnn.init_params(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.named_parameters()} == {
        k: tuple(v.shape) for k, v in model.named_parameters()}
    bad = jax.tree.map(np.asarray, jparams)
    bad["w"][0] = bad["w"][0][:, :3]
    with pytest.raises(ValueError, match="layer 0"):
        gnn_params_from_jax(bad, cfg, device="cpu")
    # the mesh paths are ported (tests/test_torch_mesh.py holds them on 8 ranks):
    # off a mesh the edge-sharded forward is the plain one, as repro's, and the
    # specs are repro's (replicated)
    _, tg = _graph()
    torch.testing.assert_close(tgnn.forward(model, tg, cfg, edge_sharded=True),
                               tgnn.forward(model, tg, cfg), rtol=0, atol=0)
    specs = tgnn.param_specs(cfg)
    jspecs = jgnn.param_specs(jcfg)
    assert [tuple(p) for p in specs["w"] + specs["b"]] == [
        tuple(p) for p in jspecs["w"] + jspecs["b"]]
