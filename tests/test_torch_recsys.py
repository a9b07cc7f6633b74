"""Port parity for the two-tower path (``repro_torch.models``, ``train``, ``launch.train``).

``repro``'s ``init_params`` for the SMOKE two-tower config is carried across
by ``convert.recsys_params_from_jax``; ``repro``'s batches are replayed as
arrays.  Then, against ``repro`` on the same arrays: the tower embeddings
and the in-batch softmax loss agree within 1e-6, ``warmup_cosine``,
``clip_by_global_norm`` and ``adamw`` agree step by step (rtol 1e-6, the
float32 order of the update), and five ``make_train_step`` steps give the
same losses (rtol 1e-5) and parameters (atol 2e-6: Adam normalises each
step, so an ulp of gradient on a near-zero element moves it by up to lr x
its own rounding).  The launcher's ``main`` runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.synthetic import recsys_batch as jax_recsys_batch
from repro.models import recsys as jrecsys
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.train_step import recsys_loss as jax_recsys_loss
from repro_torch.configs import get_smoke_config
from repro_torch.convert import recsys_params_from_jax
from repro_torch.data.synthetic import recsys_batch
from repro_torch.launch import train as ttrain
from repro_torch.models import recsys as trecsys
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step, recsys_loss

ARCH = "two-tower-retrieval"
EMB_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg():
    return get_smoke_config(ARCH)


def _jax_params(cfg, seed=0):
    return jrecsys.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(seed))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_batch(seed, batch=64):
    cfg = jax_smoke_config(ARCH)
    return jax_recsys_batch(jax.random.PRNGKey(seed), batch=batch, n_dense=0,
                            vocab_sizes=cfg.vocab_sizes)


def _t_batch(jb):
    return {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _model(cfg, jparams):
    return recsys_params_from_jax(_np_tree(jparams), cfg, device="cpu")


def test_config_mirrors_repro(cfg):
    jcfg = jax_smoke_config(ARCH)
    for field in ("name", "interaction", "vocab_sizes", "embed_dim", "tower_mlp_dims"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    assert get_config(ARCH).vocab_sizes == jax_get_config(ARCH).vocab_sizes
    assert get_config(ARCH).tower_mlp_dims == jax_get_config(ARCH).tower_mlp_dims


def test_init_shapes_match_repro_and_the_table_is_padded(cfg):
    jparams = _np_tree(_jax_params(cfg))
    model = trecsys.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert tuple(model.table.shape) == jparams["table"].shape
    assert model.table.shape[0] % 512 == 0 and model.table.shape[0] >= cfg.table_rows()
    for tower in ("user_tower", "item_tower"):
        t = getattr(model, tower)
        assert [tuple(w.shape) for w in t.w] == [w.shape for w in jparams[tower]["w"]]
        assert [tuple(b.shape) for b in t.b] == [b.shape for b in jparams[tower]["b"]]
        assert all(float(b.detach().abs().max()) == 0.0 for b in t.b)
    # dense_init's scale: d_in ** -0.5, as repro's
    w0 = model.user_tower.w[0]
    assert abs(float(w0.std()) * w0.shape[0] ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("seed", [0, 3])
def test_tower_embeddings_and_loss_match_repro(cfg, seed):
    jparams = _jax_params(cfg, seed)
    jb = _jax_batch(10 + seed)
    model = _model(cfg, jparams)
    tb = _t_batch(jb)
    ju, jit = jrecsys.tower_embeddings(jparams, jb, jax_smoke_config(ARCH))
    u, it = trecsys.tower_embeddings(model, tb, cfg)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), **EMB_TOL)
    np.testing.assert_allclose(it.detach().numpy(), np.asarray(jit), **EMB_TOL)
    np.testing.assert_allclose(torch.linalg.norm(u, dim=1).detach().numpy(), 1.0, rtol=1e-6)
    jl = float(jrecsys.inbatch_softmax_loss(jparams, jb, jax_smoke_config(ARCH)))
    tl = float(trecsys.inbatch_softmax_loss(model, tb, cfg))
    np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6)
    # the serve-path scores: negdot of the user rows against the item rows
    jd = jrecsys.retrieval_scores(ju, jit)
    td = trecsys.retrieval_scores(u.detach(), it.detach())
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **EMB_TOL)


def test_recsys_batch_draws_zipf_ids_per_field():
    sizes = (512, 64, 256, 32)
    b = recsys_batch(np.random.default_rng(0), 4096, sizes, device="cpu")
    ids = b["sparse_ids"]
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (4096, 4)
    for f, v in enumerate(sizes):
        col = ids[:, f]
        assert int(col.min()) >= 0 and int(col.max()) <= v - 1
        # uniform**2: a half of the draws fall below a quarter of the range
        share = float((col < (v - 1) / 4).float().mean())
        assert 0.45 < share < 0.55
    assert set(b) == {"sparse_ids", "label"} and 0.2 < float(b["label"].mean()) < 0.3
    again = recsys_batch(np.random.default_rng(0), 4096, sizes, device="cpu")
    assert torch.equal(again["sparse_ids"], ids)


def test_warmup_cosine_matches_repro():
    jlr = jopt.warmup_cosine(1e-3, 10, 60)
    tlr = topt.warmup_cosine(1e-3, 10, 60)
    for step in range(0, 70):
        np.testing.assert_allclose(float(tlr(step)), float(jlr(step)), rtol=1e-6, atol=0)
    assert float(tlr(100)) == pytest.approx(1e-4, rel=1e-6)  # the floor of 0.1


def _rand_tree(rng, scale=1.0):
    return {"a": (rng.standard_normal((5, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal((7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [0.01, 10.0])  # under and over the clip
def test_clip_by_global_norm_matches_repro(scale):
    g = _rand_tree(np.random.default_rng(4), scale)
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    tg, tn = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), np.asarray(jg[k]), rtol=1e-6, atol=1e-7)


def test_adamw_matches_repro_step_by_step():
    rng = np.random.default_rng(5)
    p = _rand_tree(rng)
    jo = jopt.adamw(jopt.warmup_cosine(1e-2, 2, 10))
    to = topt.adamw(topt.warmup_cosine(1e-2, 2, 10))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    for step in range(5):
        g = _rand_tree(rng)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert ts["step"] == int(js["step"]) == step + 1
        for k in p:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts["mu"][k].numpy(), np.asarray(js["mu"][k]), rtol=1e-6)
            np.testing.assert_allclose(ts["nu"][k].numpy(), np.asarray(js["nu"][k]), rtol=1e-6)
        jp = {k: jp[k] + ju[k] for k in p}
        tp = {k: tp[k] + tu[k] for k in p}
    # repro's order: u = (m / bc1) / (sqrt(v / bc2) + eps) + wd p, then -lr u
    assert ts["step"] == 5


def test_five_train_steps_match_repro(cfg):
    jcfg = jax_smoke_config(ARCH)
    jparams = _jax_params(cfg)
    model = _model(cfg, jparams)
    jo = jopt.adamw(jopt.warmup_cosine(1e-3, 10, 60))
    to = topt.adamw(topt.warmup_cosine(1e-3, 10, 60))
    jstep = jax.jit(jax_make_train_step(lambda p, b: jax_recsys_loss(p, b, jcfg), jo))
    tstep = make_train_step(lambda m, b: recsys_loss(m, b, cfg), to)
    js, ts = jo.init(jparams), to.init(dict(model.named_parameters()))
    for step in range(5):
        jb = _jax_batch(100 + step, batch=128)
        jparams, js, jm = jstep(jparams, js, jb)
        model, ts, tm = tstep(model, ts, _t_batch(jb))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    want = _np_tree(jparams)
    got = dict(model.named_parameters())
    np.testing.assert_allclose(got["table"].detach().numpy(), want["table"], rtol=0, atol=2e-6)
    for tower in ("user_tower", "item_tower"):
        for part in ("w", "b"):
            for i, a in enumerate(want[tower][part]):
                np.testing.assert_allclose(got[f"{tower}.{part}.{i}"].detach().numpy(), a,
                                           rtol=0, atol=2e-6, err_msg=f"{tower}.{part}.{i}")


def test_train_main_runs_on_the_cpu():
    history = ttrain.main(["--device", "cpu", "--arch", ARCH, "--smoke", "--steps", "3"])
    assert [h["step"] for h in history] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in history)


def test_train_recsys_peak_lr(cfg):
    """``peak_lr`` scales the whole schedule: at 0 no parameter moves; the
    default is ``repro``'s."""
    import inspect

    from repro.launch.train import train_recsys as jax_train_recsys

    init = dict(ttrain.recsys.init_params(cfg, torch.Generator().manual_seed(0),
                                          "cpu").named_parameters())
    still, _ = ttrain.train_recsys(cfg, steps=2, batch=16, log_every=10, peak_lr=0.0,
                                   device="cpu")
    for name, p in still.named_parameters():
        assert torch.equal(p, init[name]), name
    moved, _ = ttrain.train_recsys(cfg, steps=2, batch=16, log_every=10, device="cpu")
    assert not torch.equal(moved.table, init["table"])
    default = inspect.signature(jax_train_recsys).parameters["peak_lr"].default
    assert inspect.signature(ttrain.train_recsys).parameters["peak_lr"].default == default


def test_train_recsys_loss_falls(cfg):
    model, history = ttrain.train_recsys(cfg, steps=30, batch=128, log_every=29, device="cpu")
    assert history[-1]["loss"] < history[0]["loss"]
    # deterministic: the same weights again
    again, _ = ttrain.train_recsys(cfg, steps=2, batch=16, log_every=10, device="cpu")
    twice, _ = ttrain.train_recsys(cfg, steps=2, batch=16, log_every=10, device="cpu")
    assert torch.equal(again.table, twice.table)
