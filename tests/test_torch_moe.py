"""Port parity for the MoE LMs (``repro_torch.models.moe``, the MoE branch of
``models.transformer``, ``convert.lm_params_from_jax``).

Against ``repro`` on the same arrays: ``_capacity`` over a grid and
``_routing_plan``'s six index arrays exactly (numpy assignments with many
equal experts, with and without drops); ``moe_ffn``'s output and aux at
``tests/test_moe.py``'s four (E, K, n_shared) cases and its tolerance (rtol
2e-4, atol 2e-5), a dropping case, a router with tied columns (top-k's ties
go to the lower expert id) and bf16 (2% Frobenius, as the dense bf16 test).

Gradients.  ``repro``'s dispatch VJP sums the buffer's cotangents in sorted
assignment order (token ``j // K`` for sorted position j), so its gradient
with respect to the MoE input is not the derivative of its forward; the
port's ``_DispatchGather`` takes each assignment's slot in the tokens' own
order.  So the gradients here are held to ``jax.grad`` of ``repro``'s forward
with its dispatch VJP replaced by autodiff's (``exact_dispatch``); every
weight's gradient also equals ``jax.grad`` of ``repro`` as it is, and a test
pins the input gradient's difference.  ``torch.autograd.gradcheck`` in f64
checks both Functions, and the autograd graph shows the forward runs them.

The SMOKE archs (phi3.5-moe, kimi-k2 with its shared expert) with
``repro``'s params converted: the parameter count; ``forward``'s logits and
aux, ``prefill`` and three ``decode_step``s within 1e-5; ``lm_loss`` (1e-6)
and its gradients; five AdamW steps (parameters within 2e-6); an MoE
checkpoint with its float32 router in a bf16 model saved and restored bit
for bit; ``launch.train.main`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import LMConfig as JLMConfig
from repro.configs.base import MoEConfig as JMoEConfig
from repro.launch.train import lm_batch_fn as jax_lm_batch_fn
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train.train_step import lm_loss as jax_lm_loss
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_family, get_smoke_config
from repro_torch.configs.base import LMConfig, MoEConfig
from repro_torch.convert import _from_np, lm_params_from_jax
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import lm_loss, make_train_step

MOE_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_moe.py's
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)
BLOCKS = dict(block_q=8, block_kv=8)
ARCHS = ["phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b"]
# tests/test_moe.py's four cases, a dropping one (cf 0.1) and a bigger group
FFN_CASES = {"E8-K2": dict(E=8, K=2), "E8-K2-shared": dict(E=8, K=2, n_shared=1),
             "E16-K4": dict(E=16, K=4), "E4-K1": dict(E=4, K=1),
             "E4-K2-drops": dict(E=4, K=2, cf=0.1, T=32)}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain_dispatch(tokens, src, buf_valid, dest):
    """``repro``'s dispatch forward without its custom VJP: autodiff's
    transpose (a scatter-add) is the forward's derivative."""
    buf = jnp.take_along_axis(tokens, src[..., None], axis=1)
    return buf * buf_valid[..., None].astype(tokens.dtype)


@pytest.fixture
def exact_dispatch(monkeypatch):
    monkeypatch.setattr(jmoe, "_dispatch_gather", _plain_dispatch)


def _cfgs(E=8, K=2, d=16, ff=24, cf=8.0, n_shared=0, dtype="float32"):
    fields = dict(name="moe-test", n_layers=1, d_model=d, n_heads=2, n_kv_heads=2, d_head=8,
                  d_ff=ff, vocab_size=64, dtype=dtype, remat=False)
    moe = dict(n_experts=E, top_k=K, d_ff_expert=ff, capacity_factor=cf, n_shared=n_shared)
    return (JLMConfig(moe=JMoEConfig(**moe), **fields), LMConfig(moe=MoEConfig(**moe), **fields))


def _layer(case, seed=0, dtype="float32"):
    """(jax cfg, torch cfg, repro's layer-0 weights, the port's, h (B, T, d) numpy)."""
    kw = dict(FFN_CASES[case])
    T = kw.pop("T", 12)
    jcfg, cfg = _cfgs(dtype=dtype, **kw)
    jlp = jax.tree.map(lambda a: a[0], jmoe.init_moe_layer(jcfg, jax.random.PRNGKey(seed)))
    tlp = {k: _from_np(v) for k, v in jlp.items()}
    h = np.random.default_rng(seed + 1).standard_normal((2, T, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jlp, tlp, h


# the references compiled whole (op-by-op dispatch compiles every primitive)
_jax_ffn = jax.jit(jmoe.moe_ffn, static_argnums=2)


def _jax_grads(jcfg, lp, h):
    """jax.grad of sum(sin(out)) + 0.01 aux w.r.t. (weights, h), traced
    anew so that a patched dispatch is the one traced."""
    def f(lp, h):
        out, aux = jmoe.moe_ffn(h, lp, jcfg)
        return jnp.sum(jnp.sin(out)) + 0.01 * aux
    return jax.jit(jax.grad(f, argnums=(0, 1)))(lp, h)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_capacity_matches_repro():
    for N in (1, 7, 26, 128, 1000, 4096):
        for E, K in ((4, 1), (4, 2), (16, 2), (384, 8)):
            for cf in (0.1, 1.0, 1.25, 2.0, E / K):
                jcfg, cfg = _cfgs(E=E, K=K, cf=cf)
                assert tmoe._capacity(N, cfg) == jmoe._capacity(N, jcfg), (N, E, K, cf)
                assert tmoe._capacity(N, cfg) % 8 == 0
    jcfg, cfg = _cfgs(E=16, K=2, cf=16 / 2)
    assert tmoe._capacity(96, cfg) == 104  # cf = E / K: C = N + 1, rounded up to 8
    assert tmoe._group_count(8) == 1


@pytest.mark.parametrize("case", ["drops", "no-drops", "skewed-drops", "groups"])
def test_routing_plan_matches_repro_exactly(case):
    rng = np.random.default_rng({"drops": 0, "no-drops": 1, "skewed-drops": 2, "groups": 3}[case])
    G, Ng, K, E = (3, 20, 2, 8) if case == "groups" else (1, 50, 3, 6)
    if case == "skewed-drops":  # half the assignments on expert 0
        idx = np.where(rng.random((G, Ng, K)) < 0.5, 0, rng.integers(0, E, (G, Ng, K)))
    else:
        idx = rng.integers(0, E, (G, Ng, K))
    idx = idx.astype(np.int32)
    C = {"drops": 8, "no-drops": Ng * K, "skewed-drops": 16, "groups": 4}[case]
    want = jmoe._routing_plan(jnp.asarray(idx), E, C)
    got = tmoe._routing_plan(torch.from_numpy(idx), E, C)
    assert set(got) == set(want) == {"src", "buf_valid", "dest", "order", "inv_order",
                                     "s_safe"}
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]), err_msg=name)
    dropped = int((got["dest"] == E * C).sum())
    assert (dropped > 0) == (case != "no-drops")


def test_top_k_breaks_ties_to_the_lower_index():
    probs = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = tmoe._top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_moe_ffn_with_a_tied_router_matches_repro():
    """Experts 1 and 2 (and 4 and 5) share a router column: every token's
    probabilities tie, and both packages route to the lower id."""
    jcfg, cfg, jlp, tlp, h = _layer("E8-K2")
    router = np.array(jlp["router"])
    router[:, 2], router[:, 5] = router[:, 1], router[:, 4]
    jlp = {**jlp, "router": jnp.asarray(router)}
    tlp = {**tlp, "router": torch.from_numpy(router)}
    want, jaux = _jax_ffn(jnp.asarray(h), jlp, jcfg)
    got, aux = tmoe.moe_ffn(torch.from_numpy(h), tlp, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


# ---------------------------------------------------------------------------
# the FFN and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_repro(case):
    jcfg, cfg, jlp, tlp, h = _layer(case)
    want, jaux = _jax_ffn(jnp.asarray(h), jlp, jcfg)
    got, aux = tmoe.moe_ffn(torch.from_numpy(h), tlp, cfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert aux.dtype == torch.float32 and float(aux) > 0.0


def test_moe_ffn_bf16_matches_repro_loosely():
    jcfg, cfg, jlp, tlp, h = _layer("E8-K2-shared", dtype="bfloat16")
    assert tlp["router"].dtype == torch.float32 and tlp["e_gate"].dtype == torch.bfloat16
    want, jaux = _jax_ffn(jnp.asarray(h, jnp.bfloat16), jlp, jcfg)
    got, aux = tmoe.moe_ffn(torch.from_numpy(h).bfloat16(), tlp, cfg)
    assert got.dtype == torch.bfloat16
    got, want = _np(got), np.asarray(want, np.float32)
    assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-3)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_gradients_match_jax(case, monkeypatch):
    jcfg, cfg, jlp, tlp, h = _layer(case)
    as_is = _jax_grads(jcfg, jlp, jnp.asarray(h))
    monkeypatch.setattr(jmoe, "_dispatch_gather", _plain_dispatch)
    want_w, want_h = _jax_grads(jcfg, jlp, jnp.asarray(h))
    th = torch.from_numpy(h).requires_grad_()
    tw = {k: v.clone().requires_grad_() for k, v in tlp.items()}
    out, aux = tmoe.moe_ffn(th, tw, cfg)
    grads = torch.autograd.grad(torch.sum(torch.sin(out)) + 0.01 * aux, [th, *tw.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_h), **GRAD_TOL)
    for (name, _), g in zip(tw.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_w[name]), **GRAD_TOL,
                                   err_msg=name)
        # repro's own VJP gives every weight's gradient; only the input's differs
        np.testing.assert_allclose(g.numpy(), np.asarray(as_is[0][name]), **GRAD_TOL,
                                   err_msg=name)


def test_repro_dispatch_vjp_misroutes_the_input_gradient():
    """The reference caveat the port does not copy (ROADMAP §3): ``repro``'s
    input gradient differs from its forward's derivative once the sort moves
    assignments, and equals it where the assignments are already sorted."""
    jcfg, _, jlp, _, h = _layer("E8-K2")
    h = jnp.asarray(h)
    _, repro_h = _jax_grads(jcfg, jlp, h)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmoe, "_dispatch_gather", _plain_dispatch)
        _, exact_h = _jax_grads(jcfg, jlp, h)
    assert np.abs(np.asarray(repro_h) - np.asarray(exact_h)).max() > 1e-2

    # sorted assignments (each token's experts in id order, tokens grouped by
    # expert): the VJP's sorted order is the tokens' order, and the two agree
    tokens = jnp.asarray(np.random.default_rng(5).standard_normal((1, 6, 4)), jnp.float32)
    idx = jnp.asarray([[[0, 0], [0, 1], [1, 1], [1, 2], [2, 3], [3, 3]]], jnp.int32)
    plan = jmoe._routing_plan(idx, 4, 8)
    np.testing.assert_array_equal(np.asarray(plan["order"]), np.arange(12)[None])
    args = (plan["src"], plan["buf_valid"], plan["dest"])
    w = jnp.asarray(np.random.default_rng(6).standard_normal((1, 32, 4)), jnp.float32)
    g_vjp = jax.grad(lambda t: jnp.sum(jmoe._dispatch_gather(t, *args) * w))(tokens)
    g_exact = jax.grad(lambda t: jnp.sum(_plain_dispatch(t, *args) * w))(tokens)
    np.testing.assert_allclose(np.asarray(g_vjp), np.asarray(g_exact), rtol=1e-6, atol=1e-6)


def _f64_plan(seed=0, G=2, Ng=7, K=2, E=4, C=8, d=3):
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, E, (G, Ng, K)))
    idx[0, :, 0] = 0  # expert 0 overflows its 8 slots in group 0: drops
    idx[0, :4, 1] = 0
    plan = tmoe._routing_plan(idx, E, C)
    tokens = torch.from_numpy(rng.standard_normal((G, Ng, d))).requires_grad_()
    out_buf = torch.from_numpy(rng.standard_normal((G, E * C, d))).requires_grad_()
    return plan, tokens, out_buf


def test_gradcheck_the_two_functions():
    plan, tokens, out_buf = _f64_plan()
    assert bool((plan["dest"] == 4 * 8).any()), "the case must drop assignments"
    assert torch.autograd.gradcheck(
        lambda t: tmoe._DispatchGather.apply(t, plan["src"], plan["buf_valid"], plan["dest"],
                                             plan["inv_order"]), (tokens,))
    assert torch.autograd.gradcheck(
        lambda b: tmoe._CombineGather.apply(b, plan["dest"], plan["order"], plan["inv_order"],
                                            plan["s_safe"], plan["buf_valid"]), (out_buf,))


def test_the_forward_runs_the_two_functions():
    """``moe_ffn``'s gradients flow through the two Functions' backwards (their
    nodes are on the graph), and equal autograd's through plain indexing."""
    _, cfg, _, tlp, h = _layer("E8-K2-shared")
    th = torch.from_numpy(h).requires_grad_()
    out, _ = tmoe.moe_ffn(th, tlp, cfg)
    names, stack, seen = set(), [out.grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(nxt for nxt, _ in node.next_functions)
    assert {"_DispatchGatherBackward", "_CombineGatherBackward"} <= names
    assert not any("IndexPut" in n or "Scatter" in n for n in names), names
    plan, tokens, out_buf = _f64_plan(seed=1)
    g = torch.arange(2)[:, None]
    for fn, plain, x in (
            (lambda t: tmoe._DispatchGather.apply(t, plan["src"], plan["buf_valid"],
                                                  plan["dest"], plan["inv_order"]),
             lambda t: t[g, plan["src"]] * plan["buf_valid"][..., None], tokens),
            (lambda b: tmoe._CombineGather.apply(b, plan["dest"], plan["order"],
                                                 plan["inv_order"], plan["s_safe"],
                                                 plan["buf_valid"]),
             lambda b: (b[g, torch.gather(plan["dest"], 1, plan["inv_order"]).clamp(max=31)]
                        * (torch.gather(plan["dest"], 1, plan["inv_order"]) < 32)[..., None]),
             out_buf)):
        w = torch.randn(fn(x).shape, dtype=torch.float64)
        got, = torch.autograd.grad((fn(x) * w).sum(), x)
        want, = torch.autograd.grad((plain(x) * w).sum(), x)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_mesh_paths_raise():
    """The mesh paths are ported (tests/test_torch_mesh.py holds them on 8
    ranks): off a mesh ``moe_ffn`` is the one-group gather path, and the
    layer's specs are ``repro``'s."""
    jcfg, cfg, _, tlp, h = _layer("E4-K1")
    assert tmoe._group_count(h.shape[0]) == 1
    for a, b in zip(tmoe.moe_ffn(torch.from_numpy(h), tlp, cfg),
                    tmoe._moe_ffn_gather(torch.from_numpy(h), tlp, cfg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    specs = {k: tuple(v) for k, v in tmoe.moe_layer_specs(cfg).items()}
    assert specs == {k: tuple(v) for k, v in jmoe.moe_layer_specs(jcfg).items()}


# ---------------------------------------------------------------------------
# the SMOKE archs
# ---------------------------------------------------------------------------


def _arch(arch, **changes):
    return (dataclasses.replace(jax_smoke_config(arch), **changes),
            dataclasses.replace(get_smoke_config(arch), **changes))


def _model(jparams, cfg):
    return lm_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _flat(jtree):
    flat = {"embed": jtree["embed"], "ln_f": jtree["ln_f"],
            **{f"layers.{k}": v for k, v in jtree["layers"].items()}}
    if "lm_head" in jtree:
        flat["lm_head"] = jtree["lm_head"]
    return flat


def test_configs_mirror_repro():
    from repro.configs import get_config as jax_get_config
    from repro_torch.configs import get_config

    for arch in ARCHS:
        assert get_family(arch) == "lm"
        for mine, theirs in ((get_config(arch), jax_get_config(arch)),
                             (get_smoke_config(arch), jax_smoke_config(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.n_params() == theirs.n_params()
            assert mine.n_active_params() == theirs.n_active_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_param_count_and_names(arch):
    jcfg, cfg = _arch(arch)
    model = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == cfg.n_params()
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    assert set(dict(model.named_parameters())) == set(_flat(jparams))
    for name, p in model.named_parameters():
        assert tuple(p.shape) == _flat(jparams)[name].shape, name


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_prefill_decode_match_repro(arch):
    jcfg, cfg = _arch(arch)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(0))
    model = _model(jparams, cfg)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)

    want, jaux = jax.jit(lambda p, t: jt.forward(p, t, jcfg, **BLOCKS))(jparams, toks)
    got, aux = tt.forward(model, _t(toks), cfg, **BLOCKS)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=1e-6)
    assert float(aux.detach()) > 0.0

    jlog, jcache = jax.jit(lambda p, t: jt.prefill(p, t, jcfg, max_len=20, **BLOCKS))(
        jparams, toks)
    tlog, tcache = tt.prefill(model, _t(toks), cfg, max_len=20, **BLOCKS)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), **TOL)
    nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)
    jdecode = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, jcfg))
    for _ in range(3):
        jlog, jcache = jdecode(jparams, jcache, nxt)
        tlog, tcache = tt.decode_step(model, tcache, _t(nxt), cfg)
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **TOL)
        for key in ("k", "v", "length"):
            np.testing.assert_allclose(_np(tcache[key]), np.asarray(jcache[key]), **TOL)
        nxt = np.argmax(np.asarray(jlog), axis=-1).astype(np.int32)


def _jax_batch(cfg, step, batch=4, seq=16):
    return {k: np.asarray(v) for k, v in jax_lm_batch_fn(cfg, batch, seq)(step).items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_lm_loss_and_gradients_match_repro(arch, exact_dispatch):
    jcfg, cfg = _arch(arch)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(2))
    model = _model(jparams, cfg)
    batch = _jax_batch(jcfg, 0)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch, jcfg, **BLOCKS), has_aux=True))(jparams)
    params = dict(model.named_parameters())
    tl, taux = lm_loss(model, {k: _t(v) for k, v in batch.items()}, cfg, **BLOCKS)
    grads = torch.autograd.grad(tl, list(params.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(taux["aux"]), float(jaux["aux"]), rtol=1e-6)
    want = _flat(jgrads)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **GRAD_TOL, err_msg=name)


def test_smoke_lm_loss_aux_weight_matches_repro(exact_dispatch):
    """phi3.5-moe SMOKE with ``aux_weight=0.1`` (the default 0.01): the loss,
    its parts and the gradients against ``repro``'s."""
    jcfg, cfg = _arch("phi3.5-moe-42b-a6.6b")
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(2))
    model = _model(jparams, cfg)
    batch = _jax_batch(jcfg, 0)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch, jcfg, aux_weight=0.1, **BLOCKS), has_aux=True))(jparams)
    params = dict(model.named_parameters())
    tl, taux = lm_loss(model, {k: _t(v) for k, v in batch.items()}, cfg, aux_weight=0.1,
                       **BLOCKS)
    grads = torch.autograd.grad(tl, list(params.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tl.detach()),
                               float(taux["nll"]) + 0.1 * float(taux["aux"]), rtol=1e-6)
    default, _ = lm_loss(model, {k: _t(v) for k, v in batch.items()}, cfg, **BLOCKS)
    assert float(tl.detach()) > float(default.detach())  # aux > 0 weighs 10x more
    want = _flat(jgrads)
    for name, g in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_five_adamw_steps_match_repro(arch, exact_dispatch):
    jcfg, cfg = _arch(arch)
    jparams = jt.init_params(jcfg, jax.random.PRNGKey(1))
    model = _model(jparams, cfg)
    sched = (3e-4, 5, 5)
    jo, to = jopt.adamw(jopt.warmup_cosine(*sched)), topt.adamw(topt.warmup_cosine(*sched))
    jstep = jax.jit(jax_make_train_step(lambda p, b: jax_lm_loss(p, b, jcfg, **BLOCKS), jo))
    tstep = make_train_step(lambda m, b: lm_loss(m, b, cfg, **BLOCKS), to)
    jstate, tstate = jo.init(jparams), to.init(dict(model.named_parameters()))
    for step in range(5):
        b = _jax_batch(jcfg, step)
        jparams, jstate, jm = jstep(jparams, jstate, b)
        model, tstate, tm = tstep(model, tstate, {k: _t(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5)
    want = _flat(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(_np(p), np.asarray(want[name], np.float32), **STEP_TOL,
                                   err_msg=name)


def test_moe_checkpoint_round_trip_bf16_with_an_f32_router(tmp_path):
    _, cfg = _arch("kimi-k2-1t-a32b", dtype="bfloat16")
    params = dict(tt.init_params(cfg, torch.Generator().manual_seed(4),
                                 device="cpu").named_parameters())
    assert params["layers.router"].dtype == torch.float32
    assert params["layers.e_gate"].dtype == params["layers.sh_up"].dtype == torch.bfloat16
    tree = {"params": params, "opt": topt.adamw(topt.warmup_cosine(1e-3, 1, 2)).init(params)}
    ckpt.save(str(tmp_path), 3, tree)
    zeros = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
             "opt": topt.adamw(topt.warmup_cosine(1e-3, 1, 2)).init(params)}
    restored, step = ckpt.restore(str(tmp_path), zeros)
    assert step == 3
    for name, p in params.items():
        got = restored["params"][name]
        assert got.dtype == p.dtype and torch.equal(got, p.detach()), name


def test_train_main_runs_both_moe_smoke_archs():
    from repro_torch.launch.train import main

    for arch in ARCHS:
        history = main(["--device", "cpu", "--arch", arch, "--smoke", "--steps", "3",
                        "--batch", "2", "--seq", "16"])
        assert [h["step"] for h in history] == [0, 2]
        assert all(np.isfinite(h["loss"]) and h["aux"] > 0.0 for h in history)
