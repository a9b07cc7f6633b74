"""Port parity for the dense LM (``repro_torch.models.transformer``, ``train``).

``repro``'s ``init_params`` is carried across by ``convert.lm_params_from_jax``
and ``repro``'s token batches are replayed as arrays.  Against ``repro`` on
the same arrays, for llama3.2-1b, gemma3-12b (pattern (2, 1), window 8),
yi-34b SMOKE and a SMOKE variant with ``pad_heads_to``: ``forward``'s logits,
``prefill``'s logits and cache and three ``decode_step``s within rtol = atol
= 1e-5; decode-by-steps equals ``forward`` within 2e-4
(``tests/test_smoke_archs.py``'s tolerance); ``layer_locality``.  Then the
LM loss (1e-6), five AdamW train steps within 2e-6 (the recsys gate's
tolerance; remat on and off), ``accum_steps = 2``, three Adafactor steps with
factored and unfactored leaves (also at non-default ``decay``, ``eps`` and
``clip_threshold``), ``train_lm(peak_lr=...)``'s losses (1e-5) and
parameters on ``repro``'s init and batches, and a bf16 variant at a looser tolerance:
the logits' relative (Frobenius) error and their largest error against the
largest logit both within 2e-2 (torch rounds every bf16 op's output, XLA may
keep excess precision inside a fusion; 0.7% measured).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.train import lm_batch_fn as jax_lm_batch_fn
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import lm_params_from_jax
from repro_torch.models import transformer as tt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import lm_loss, make_train_step

TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)
BLOCKS = dict(block_q=8, block_kv=8)
VARIANTS = {"llama3.2-1b": ("llama3.2-1b", {}), "gemma3-12b": ("gemma3-12b", {}),
            "yi-34b": ("yi-34b", {}), "yi-34b-padded": ("yi-34b", {"pad_heads_to": 6})}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(variant, **extra):
    arch, changes = VARIANTS[variant]
    changes = {**changes, **extra}
    return (dataclasses.replace(jax_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _model(jparams, cfg):
    return lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _tokens(seed, B, T, V):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jax_batch(cfg, step, batch=4, seq=16):
    return {k: np.asarray(v) for k, v in jax_lm_batch_fn(cfg, batch, seq)(step).items()}


def _assert_params(model, jparams, tol):
    flat = {"embed": jparams["embed"], "ln_f": jparams["ln_f"],
            **{f"layers.{k}": v for k, v in jparams["layers"].items()}}
    if "lm_head" in jparams:
        flat["lm_head"] = jparams["lm_head"]
    got = dict(model.named_parameters())
    assert set(got) == set(flat)
    for name, p in got.items():
        np.testing.assert_allclose(_np(p), np.asarray(flat[name], np.float32), **tol,
                                   err_msg=name)


def test_configs_mirror_repro():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config, get_family

    for arch in ("llama3.2-1b", "gemma3-12b", "yi-34b"):
        assert get_family(arch) == "lm"
        for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                             (get_smoke_config(arch), jax_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.n_params() == theirs.n_params()
            assert mine.n_heads_padded == theirs.n_heads_padded
    assert get_config("llama3.2-1b").n_params() == 1_235_814_400


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_prefill_decode_match_repro(variant):
    jcfg, cfg = _cfgs(variant)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = _model(jparams, cfg)
    toks = _tokens(1, 2, 13, cfg.vocab_size)
    np.testing.assert_array_equal(tt.layer_locality(cfg).numpy(),
                                  np.asarray(jt.layer_locality(jcfg)))

    want, _ = jt.forward(jparams, toks, jcfg, **BLOCKS)
    got, aux = tt.forward(model, _t(toks), cfg, **BLOCKS)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert float(aux) == 0.0

    jlog, jcache = jt.prefill(jparams, toks, jcfg, max_len=20, **BLOCKS)
    tlog, tcache = tt.prefill(model, _t(toks), cfg, max_len=20, **BLOCKS)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        assert tuple(tcache[key].shape) == jcache[key].shape
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), **TOL)
    np.testing.assert_array_equal(tcache["length"].numpy(), np.asarray(jcache["length"]))

    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    for _ in range(3):
        jlog, jcache = jt.decode_step(jparams, jcache, nxt, jcfg)
        tlog, tcache = tt.decode_step(model, tcache, _t(nxt), cfg)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        for key in ("k", "v", "length"):
            np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), **TOL)
        nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)


@pytest.mark.parametrize("variant", ["llama3.2-1b", "gemma3-12b", "yi-34b-padded"])
def test_decode_by_steps_equals_forward(variant):
    """Prefill-by-decode agrees with the training forward (gemma's window 8
    bites at T = 12)."""
    _, cfg = _cfgs(variant)
    model = tt.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(_tokens(4, 2, 12, cfg.vocab_size))
    full, _ = tt.forward(model, toks, cfg, **BLOCKS)
    cache = tt.init_kv_cache(cfg, 2, 16, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = tt.decode_step(model, cache, toks[:, t], cfg)
        np.testing.assert_allclose(_np(logits), _np(full[:, t]), rtol=2e-4, atol=2e-4)
    # and prefill's last position is forward's
    logits, _ = tt.prefill(model, toks, cfg, **BLOCKS)
    np.testing.assert_allclose(_np(logits), _np(full[:, -1]), **TOL)


def test_padded_heads_compute_the_unpadded_model():
    """yi's zero-masked pad heads: the padded model's logits are the unpadded one's."""
    _, cfg = _cfgs("yi-34b")
    _, padded = _cfgs("yi-34b-padded")
    model = tt.init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    big = tt.init_params(padded, torch.Generator().manual_seed(6), device="cpu")
    hq = cfg.n_heads * cfg.d_head
    with torch.no_grad():
        for name, p in big.named_parameters():
            src = dict(model.named_parameters())[name]
            if name == "layers.wq":
                p[..., :hq] = src
            elif name == "layers.wo":
                p[:, :hq] = src
            else:
                p.copy_(src)
    toks = torch.from_numpy(_tokens(7, 1, 9, cfg.vocab_size))
    np.testing.assert_allclose(_np(tt.forward(big, toks, padded, **BLOCKS)[0]),
                               _np(tt.forward(model, toks, cfg, **BLOCKS)[0]), **TOL)


def test_lm_loss_matches_repro():
    jcfg, cfg = _cfgs("gemma3-12b")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(2))
    model = _model(jparams, cfg)
    batch = _jax_batch(jcfg, 0)
    jl, jaux = jax_lm_loss(jparams, batch, jcfg, **BLOCKS)
    tl, taux = lm_loss(model, {k: _t(v) for k, v in batch.items()}, cfg, **BLOCKS)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]), rtol=1e-6, atol=1e-6)
    assert float(taux["aux"]) == float(jaux["aux"]) == 0.0


def _run_steps(jcfg, cfg, jopt_, topt_, n_steps, accum_steps=1, batch=4):
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(1))
    model = _model(jparams, cfg)
    jstep = jax.jit(jax_make_train_step(lambda p, b: jax_lm_loss(p, b, jcfg, **BLOCKS), jopt_,
                                        accum_steps=accum_steps))
    tstep = make_train_step(lambda m, b: lm_loss(m, b, cfg, **BLOCKS), topt_,
                            accum_steps=accum_steps)
    jstate = jopt_.init(jparams)
    tstate = topt_.init(dict(model.named_parameters()))
    losses = []
    for step in range(n_steps):
        b = _jax_batch(jcfg, step, batch=batch)
        jparams, jstate, jm = jstep(jparams, jstate, b)
        model, tstate, tm = tstep(model, tstate, {k: _t(v) for k, v in b.items()})
        losses.append((float(tm["loss"]), float(jm["loss"])))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    return model, jparams, losses


@pytest.mark.parametrize("remat", [False, True])
def test_five_adamw_steps_match_repro(remat):
    jcfg, cfg = _cfgs("llama3.2-1b", remat=remat)
    sched = dict(peak_lr=3e-4, warmup=5, total=5)
    model, jparams, losses = _run_steps(
        jcfg, cfg, jopt.adamw(jopt.warmup_cosine(*sched.values())),
        topt.adamw(topt.warmup_cosine(*sched.values())), 5)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(model, jparams, STEP_TOL)


def test_accum_steps_2_matches_repro():
    jcfg, cfg = _cfgs("gemma3-12b")
    model, jparams, losses = _run_steps(
        jcfg, cfg, jopt.adamw(jopt.warmup_cosine(3e-4, 2, 3)),
        topt.adamw(topt.warmup_cosine(3e-4, 2, 3)), 3, accum_steps=2)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(model, jparams, STEP_TOL)


def test_three_adafactor_steps_match_repro():
    """min_dim_factored 32: the (L, 64, *) and (256, 64) weights are factored,
    the norms ((L, 64): L = 2 < 32) and ``ln_f`` are not."""
    jcfg, cfg = _cfgs("yi-34b")
    kw = dict(min_dim_factored=32, weight_decay=0.01)
    jo = jopt.adafactor(jopt.warmup_cosine(1e-2, 1, 3), **kw)
    to = topt.adafactor(topt.warmup_cosine(1e-2, 1, 3), **kw)
    state = to.init(dict(tt.init_params(cfg, device="cpu").named_parameters()))
    assert set(state["v"]["layers.wq"]) == {"vr", "vc"}
    assert set(state["v"]["layers.ln_attn"]) == {"v"} and set(state["v"]["ln_f"]) == {"v"}
    model, jparams, losses = _run_steps(jcfg, cfg, jo, to, 3)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(model, jparams, STEP_TOL)


def test_three_adafactor_steps_with_its_options_match_repro():
    """``decay``, ``eps`` and ``clip_threshold`` away from their defaults (a
    clip at 0.5 RMS binds from the first step)."""
    jcfg, cfg = _cfgs("yi-34b")
    kw = dict(decay=0.6, eps=1e-20, clip_threshold=0.5, min_dim_factored=32,
              weight_decay=0.01)
    model, jparams, losses = _run_steps(jcfg, cfg,
                                        jopt.adafactor(jopt.warmup_cosine(1e-2, 1, 3), **kw),
                                        topt.adafactor(topt.warmup_cosine(1e-2, 1, 3), **kw), 3)
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params(model, jparams, STEP_TOL)


def test_train_lm_peak_lr_matches_repro(monkeypatch):
    """``train_lm(peak_lr=...)`` against ``repro``'s on its initial parameters
    and its token batches (both carried across): the logged losses and the
    final parameters."""
    from repro.launch.train import train_lm as jax_train_lm
    from repro_torch.launch import train as ttrain

    jcfg, cfg = _cfgs("llama3.2-1b")
    # a third of the default 3e-4 (whose run lands 5e-4 away from this one)
    kw = dict(steps=4, batch=4, seq=16, log_every=1, peak_lr=1e-4, block=8)
    jparams, jhist = jax_train_lm(jcfg, **kw)
    init = jt.init_params(jcfg, jax.random.PRNGKey(0))  # repro's train_lm init
    monkeypatch.setattr(ttrain.transformer, "init_params", lambda *a, **k: _model(init, cfg))
    monkeypatch.setattr(ttrain, "lm_batch_fn", lambda c, b, s: lambda step: {
        k: _t(v).long() for k, v in _jax_batch(jcfg, step, b, s).items()})
    model, hist = ttrain.train_lm(cfg, device="cpu", **kw)
    assert [h["step"] for h in hist] == [h["step"] for h in jhist] == [0, 1, 2, 3]
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=1e-5)
    _assert_params(model, jparams, STEP_TOL)


def test_adafactor_per_slice_branch_equals_slice_by_slice(monkeypatch):
    """A stacked tensor at or above the threshold is updated per leading slice
    (per-slice RMS clip): the result equals slice-by-slice updates."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32))
    g[1] *= 50.0  # one slice with a far larger RMS: a whole-tensor clip would differ
    opt = topt.adafactor(lambda step: torch.tensor(0.1), min_dim_factored=4)
    monkeypatch.setattr(topt, "PER_SLICE_MIN_SIZE", p.numel())
    upd, state = opt.update({"w": g}, opt.init({"w": p}), {"w": p})
    for i in range(3):
        ui, si = opt.update({"w": g[i]}, opt.init({"w": p[i]}), {"w": p[i]})
        torch.testing.assert_close(upd["w"][i], ui["w"], rtol=0, atol=0)
        for k in ("vr", "vc"):
            torch.testing.assert_close(state["v"]["w"][k][i], si["v"]["w"][k], rtol=0, atol=0)
    monkeypatch.setattr(topt, "PER_SLICE_MIN_SIZE", p.numel() + 1)
    whole, _ = opt.update({"w": g}, opt.init({"w": p}), {"w": p})
    assert not torch.allclose(whole["w"], upd["w"])
    assert topt.PER_SLICE_MIN_SIZE == p.numel() + 1
    assert 16 * 2048 * 8192 == 1 << 28  # llama3.2-1b FULL's w_gate/w_up/w_down take it


def _assert_bf16_close(got, want):
    got, want = _np(got), np.asarray(want, np.float32)
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_bf16_variant_matches_repro_loosely():
    jcfg, cfg = _cfgs("llama3.2-1b", dtype="bfloat16")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = _model(jparams, cfg)
    assert model.layers["wq"].dtype == torch.bfloat16
    toks = _tokens(9, 2, 12, cfg.vocab_size)
    want, _ = jt.forward(jparams, toks, jcfg, **BLOCKS)
    got, _ = tt.forward(model, _t(toks), cfg, **BLOCKS)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want)
    jlog, jcache = jt.prefill(jparams, toks, jcfg, max_len=16, **BLOCKS)
    tlog, tcache = tt.prefill(model, _t(toks), cfg, max_len=16, **BLOCKS)
    _assert_bf16_close(tlog, jlog)
    _assert_bf16_close(tcache["k"], jcache["k"])
    nxt = np.argmax(np.asarray(jlog, np.float32), axis=-1).astype(np.int32)
    jlog, _ = jt.decode_step(jparams, jcache, nxt, jcfg)
    tlog, _ = tt.decode_step(model, tcache, _t(nxt), cfg)
    _assert_bf16_close(tlog, jlog)
