"""Port parity for the recsys ranking models (``repro_torch.models.recsys``:
AutoInt, DIN, DCN-v2), ``embedding_bag``, ``recsys_batch``'s dense and
history draws, the launcher and the registry (``repro_torch.configs``, the
paper's retrieval configs included).

``repro``'s ``init_params`` for each SMOKE config is carried across by
``convert.recsys_params_from_jax`` and ``repro``'s batches are replayed as
arrays.  Then, against ``repro`` on the same arrays: the configs field by
field, the init shapes, the logits (rtol = atol = 1e-5), ``bce_loss`` (1e-6)
and five AdamW train steps (loss and gradient norm rtol 1e-5, every
parameter atol 2e-6, the two-tower gate's tolerances).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import recsys_batch as jax_recsys_batch
from repro.models import recsys as jrecsys
from repro.models.embedding import embedding_bag as jax_embedding_bag
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import recsys_loss as jax_recsys_loss
from repro_torch import configs
from repro_torch.convert import recsys_params_from_jax
from repro_torch.data.synthetic import recsys_batch
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as trecsys
from repro_torch.models.embedding import embedding_bag
from repro_torch.sharding.api import flatten as _flatten
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step, recsys_loss

ARCHS = ["autoint", "din", "dcn-v2"]
TOL = dict(rtol=1e-5, atol=1e-5)
RETRIEVAL = ("WIKI8_KL", "WIKI128_KL", "RCV128_IS", "RANDHIST32_RENYI2", "MANNER_BM25", "SMOKE")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batch(arch, seed, batch=64):
    cfg = jax_smoke_config(arch)
    return jax_recsys_batch(jax.random.PRNGKey(seed), batch=batch, n_dense=cfg.n_dense,
                            vocab_sizes=cfg.vocab_sizes, seq_len=cfg.seq_len)


def _t_batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _pair(arch, seed=0):
    """``repro``'s SMOKE params and the port's model holding them."""
    jparams = jrecsys.init_params(jax_smoke_config(arch), jax.random.PRNGKey(seed))
    model = recsys_params_from_jax(_np_tree(jparams), configs.get_smoke_config(arch),
                                   device="cpu")
    return jparams, model


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_repro_field_by_field(arch):
    assert _fields(configs.get_config(arch)) == _fields(jax_get_config(arch))
    assert _fields(configs.get_smoke_config(arch)) == _fields(jax_smoke_config(arch))
    assert configs.get_family(arch) == "recsys"


def test_criteo_vocabs_and_the_retrieval_configs_equal_repro():
    from repro.configs import paper_swgraph as jpaper
    from repro.configs.vocabs import criteo_vocabs as jax_criteo_vocabs
    from repro_torch.configs import paper_swgraph
    from repro_torch.configs.vocabs import criteo_vocabs

    for n in (1, 5, 11, 12, 26, 39, 50):
        assert criteo_vocabs(n) == jax_criteo_vocabs(n)
    for name in RETRIEVAL:
        assert _fields(getattr(paper_swgraph, name)) == _fields(getattr(jpaper, name)), name
    two = "two-tower-retrieval"
    assert _fields(configs.get_config(two)) == _fields(jax_get_config(two))
    assert _fields(configs.get_smoke_config(two)) == _fields(jax_smoke_config(two))


def test_registry_equals_repro():
    from repro import configs as jconfigs

    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert "swgraph-retrieval" not in configs.ARCH_IDS
    for arch in jconfigs.ARCH_IDS + ["swgraph-retrieval"]:
        assert configs.get_family(arch) == jconfigs.get_family(arch), arch
    arch = "swgraph-retrieval"
    assert configs.get_family(arch) == "retrieval"
    # no FULL: get_config falls back to WIKI128_KL, as repro's
    assert configs.get_config(arch) is configs.get_module(arch).WIKI128_KL
    assert _fields(configs.get_config(arch)) == _fields(jconfigs.get_config(arch))
    assert _fields(configs.get_smoke_config(arch)) == _fields(jconfigs.get_smoke_config(arch))
    assert configs.get_module("dcn-v2").FULL is configs.get_config("dcn-v2")
    with pytest.raises(KeyError):
        configs.get_module("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_shapes_match_repro_and_the_table_is_padded(arch):
    cfg = configs.get_smoke_config(arch)
    want = _flatten(_np_tree(jrecsys.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))))
    model = trecsys.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = dict(model.named_parameters())
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert model.table.shape[0] % 512 == 0 and model.table.shape[0] >= cfg.table_rows()
    for name, p in got.items():  # biases start at zero, weights at dense_init's scale
        if name.endswith(".b") or ".b." in name:
            assert float(p.detach().abs().max()) == 0.0, name
        elif name != "table":
            assert abs(float(p.detach().std()) * p.shape[0] ** 0.5 - 1.0) < 0.35, name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seed", [0, 3])
def test_forward_and_bce_loss_match_repro(arch, seed):
    jcfg, cfg = jax_smoke_config(arch), configs.get_smoke_config(arch)
    jparams, model = _pair(arch, seed)
    jb = _jax_batch(arch, 10 + seed)
    tb = _t_batch(jb)
    with torch.no_grad():
        got = trecsys.forward(model, tb, cfg)
        loss = trecsys.bce_loss(model, tb, cfg)
    assert tuple(got.shape) == (64,)
    np.testing.assert_allclose(got.numpy(), np.asarray(jrecsys.forward(jparams, jb, jcfg)), **TOL)
    np.testing.assert_allclose(float(loss), float(jrecsys.bce_loss(jparams, jb, jcfg)),
                               rtol=1e-6, atol=1e-6)
    # recsys_loss dispatches every interaction but dot to bce_loss
    tl, aux = recsys_loss(model, tb, cfg)
    assert float(tl) == float(loss) and float(aux["nll"]) == float(loss)


def test_din_masks_the_history_past_hist_len():
    """Ids past ``hist_len`` change nothing: their scores are -1e30 before the
    softmax."""
    arch = "din"
    cfg = configs.get_smoke_config(arch)
    _, model = _pair(arch)
    tb = _t_batch(_jax_batch(arch, 5))
    gen = torch.Generator().manual_seed(0)
    tb["hist_len"] = torch.randint(1, cfg.seq_len, (64,), generator=gen, dtype=torch.int32)
    other = dict(tb)
    past = torch.arange(cfg.seq_len)[None, :] >= tb["hist_len"][:, None]
    other["history"] = torch.where(past, (tb["history"] + 7) % cfg.vocab_sizes[0], tb["history"])
    with torch.no_grad():
        torch.testing.assert_close(trecsys.forward(model, other, cfg),
                                   trecsys.forward(model, tb, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_match_repro(arch):
    jcfg, cfg = jax_smoke_config(arch), configs.get_smoke_config(arch)
    jparams, model = _pair(arch)
    jo = jopt.adamw(jopt.warmup_cosine(1e-3, 10, 60))
    to = topt.adamw(topt.warmup_cosine(1e-3, 10, 60))
    jstep = jax.jit(jax_make_train_step(lambda p, b: jax_recsys_loss(p, b, jcfg), jo))
    tstep = make_train_step(lambda m, b: recsys_loss(m, b, cfg), to)
    js, ts = jo.init(jparams), to.init(dict(model.named_parameters()))
    for step in range(5):
        jb = _jax_batch(arch, 100 + step, batch=128)
        jparams, js, jm = jstep(jparams, js, jb)
        model, ts, tm = tstep(model, ts, _t_batch(jb))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = _flatten(_np_tree(jparams))
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=2e-6,
                                   err_msg=name)


def test_recsys_batch_keeps_the_two_tower_draws_and_adds_dense_and_history():
    sizes = (512, 64, 256, 32)
    # the draws of a batch without dense features or history, as they were drawn
    rng = np.random.default_rng(0)
    ids = np.stack([(rng.random(4096, dtype=np.float32) ** 2 * (v - 1)).astype(np.int32)
                    for v in sizes], axis=1)
    label = (rng.random(4096) < 0.25).astype(np.float32)
    plain = recsys_batch(np.random.default_rng(0), 4096, sizes, device="cpu")
    assert set(plain) == {"sparse_ids", "label"}
    assert np.array_equal(plain["sparse_ids"].numpy(), ids)
    assert np.array_equal(plain["label"].numpy(), label)
    full = recsys_batch(np.random.default_rng(0), 4096, sizes, device="cpu", n_dense=13,
                        seq_len=100)
    assert torch.equal(full["sparse_ids"], plain["sparse_ids"])
    assert torch.equal(full["label"], plain["label"])
    dense = full["dense"]
    assert dense.dtype == torch.float32 and tuple(dense.shape) == (4096, 13)
    assert abs(float(dense.mean())) < 0.02 and abs(float(dense.std()) - 1.0) < 0.02
    hist, hist_len = full["history"], full["hist_len"]
    assert hist.dtype == hist_len.dtype == torch.int32 and tuple(hist.shape) == (4096, 100)
    assert int(hist.min()) >= 0 and int(hist.max()) <= sizes[0] - 1
    assert 0.45 < float((hist < (sizes[0] - 1) / 4).float().mean()) < 0.55  # uniform**2
    assert int(hist_len.min()) == 1 and int(hist_len.max()) == 100
    again = recsys_batch(np.random.default_rng(0), 4096, sizes, device="cpu", n_dense=13,
                         seq_len=100)
    assert all(torch.equal(again[k], full[k]) for k in full)


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_repro(mode, weighted):
    """Ragged bags with -1 ids, an empty bag (5), a bag of -1 ids only (7) and
    values of both signs."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((300, 6)).astype(np.float32)
    lengths = rng.integers(1, 9, 12)
    lengths[5] = 0
    seg = np.repeat(np.arange(12), lengths).astype(np.int32)
    ids = rng.integers(0, 300, seg.shape[0]).astype(np.int32)
    ids[rng.random(seg.shape[0]) < 0.2] = -1
    ids[seg == 7] = -1
    w = rng.uniform(-1.0, 2.0, seg.shape[0]).astype(np.float32) if weighted else None
    want = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 12,
                                        mode=mode, weights=None if w is None else jnp.asarray(w)))
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), 12,
                        mode=mode, weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert not got[5].any() and not got[7].any()
    with pytest.raises(ValueError):
        embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(seg), 12,
                      mode="median")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_on_the_cpu(arch):
    history = ttrain.main(["--device", "cpu", "--arch", arch, "--smoke", "--steps", "3"])
    assert [h["step"] for h in history] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_recsys_loss_falls(arch):
    cfg = configs.get_smoke_config(arch)
    _, history = ttrain.train_recsys(cfg, steps=30, batch=128, log_every=29, device="cpu")
    assert history[-1]["loss"] < history[0]["loss"]
    assert history[-1]["s"] >= history[0]["s"] >= 0.0


def test_train_main_exits_for_the_retrieval_family_as_repro(monkeypatch):
    from repro.launch.train import main as jax_main

    argv = ["--arch", "swgraph-retrieval", "--steps", "1"]
    for smoke in ([], ["--smoke"]):
        monkeypatch.setattr(sys, "argv", ["train"] + argv + smoke)
        with pytest.raises(SystemExit) as want:
            jax_main()
        with pytest.raises(SystemExit) as got:
            ttrain.main(["--device", "cpu"] + argv + smoke)
        assert str(got.value) == str(want.value) == "use examples/ for family retrieval"


def test_param_specs_waits_for_the_mesh():
    """The mesh is ported: the specs are ``repro``'s, the table row-sharded
    (every arch and config: tests/test_torch_specs.py)."""
    specs = _flatten(trecsys.param_specs(configs.get_smoke_config("dcn-v2")))
    jspecs = jax.tree_util.tree_flatten_with_path(
        jrecsys.param_specs(jax_smoke_config("dcn-v2")),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(p)
            for path, p in jspecs}
    assert {k: tuple(v) for k, v in specs.items()} == want
    assert want["table"] == (("model", "data"), None)


def test_convert_rejects_a_wrong_shape_or_name():
    jparams = _np_tree(jrecsys.init_params(jax_smoke_config("dcn-v2"), jax.random.PRNGKey(0)))
    cfg = configs.get_smoke_config("dcn-v2")
    bad = dict(jparams, cross=[dict(c) for c in jparams["cross"]])
    bad["cross"][0]["w"] = bad["cross"][0]["w"][:, :-1]
    with pytest.raises(ValueError, match="cross.0.w"):
        recsys_params_from_jax(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="param names"):
        recsys_params_from_jax(dict(jparams, extra=np.zeros(3)), cfg, device="cpu")
