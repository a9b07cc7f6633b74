"""Port parity: FSDP x TP of the dense LM layers (``models/transformer.py``
with parameters laid out by ``param_specs``' specs) on 8 gloo ranks, against
``repro``'s off-mesh results on the same arrays.

Two meshes over the same 8 ranks: (4, 2) and (2, 4) ("data", "model").  The
(2, 4) mesh's "model" axis of 4 is more than the SMOKE configs' 2 kv heads,
the full models' case (16 TP ranks against 8 kv heads): a rank's column
block of ``wk``/``wv`` is then half a kv head.  Four SMOKE configs:
llama3.2-1b (tied), yi-34b with ``pad_heads_to`` (6 heads padded to 8, so the
last TP rank of (2, 4) holds only pad heads), gemma3-12b (window 8, pattern
(2, 1)) and kimi-k2 (MoE, expert-parallel, one shared expert).  Per config
and mesh: ``forward``'s logits, ``lm_loss``, one train step with
``accum_steps=2`` (AdamW; kimi-k2 Adafactor, factored at
``min_dim_factored=16``), ``prefill`` (the cache sequence-sharded over
"model") and 4 ``decode_step(mesh=)`` steps.

The oracle is one JAX subprocess running ``repro`` off the mesh.  The dense
models take ``repro``'s ``make_train_step`` on the whole batch; the MoE
model's capacity and aux depend on its dispatch groups, which on the mesh
are the ranks' batch blocks, so its oracles run per data block (the step's
loss is the mean over blocks and microbatches of ``repro``'s ``lm_loss``,
then ``repro``'s clip and Adafactor), with ``repro``'s dispatch VJP replaced
by autodiff's (it misroutes the input gradient, ROADMAP §3).

Also ``make_train_step(accum_dtype=torch.bfloat16)`` against ``repro``'s
``accum_dtype=jnp.bfloat16`` step (llama3.2-1b on (4, 2); each microbatch's
bf16 sum rounds, so ``repro`` is given the batch's rows in the order of the
mesh's microbatches: each data block's first half, then its second), and
the sharded ``clip_by_global_norm`` against the unsharded norm.

Tolerances: logits, losses, the cache and the clipped gradients rtol =
atol = 2.3e-5 (ROADMAP §3's f32 SMOKE logits); the AdamW and Adafactor
steps' parameters 2e-6 (its five AdamW steps), the gradient norm 1e-5
relative.  AdamW's first update of a weight is g / (|g| + 1e-8): where the
oracle's gradient is below 1e-6 in magnitude the update amplifies the
gradient's rounding (a sum over other ranks' partials in another order), so
there the parameter is held only to the step's size, the lr.  The
bf16-accumulated step's gradient norm 1e-2 relative and its parameters
atol lr 2^-7 (7.8e-6): the f32 partial sums arrive in another order, so a
bf16 gradient may round one ulp (2^-7 relative) the other way, which moves
the first update g / (|g| + 1e-8) by at most 2^-7 / 4 of the lr; the
sharded norm 1e-6 relative.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import run_ranks
from repro_torch.models import transformer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS = 8
MESHES = {"4x2": (4, 2), "2x4": (2, 4)}
ARCHS = {"llama3.2-1b": ("llama3.2-1b", {}), "yi-34b-padded": ("yi-34b", {"n_heads": 6,
                                                                          "pad_heads_to": 8}),
         "gemma3-12b": ("gemma3-12b", {}), "kimi-k2": ("kimi-k2-1t-a32b", {})}
B, T = 8, 16  # train and forward
PT, S, DEC_STEPS = 8, 16, 4  # prefill prompt, cache length, decode steps
ACCUM, LR = 2, 1e-3
MIN_FACTORED = 16  # kimi-k2 SMOKE's trailing dims are 64: factored Adafactor leaves
BLOCKS = dict(block_q=8, block_kv=8)
TOL = dict(rtol=2.3e-5, atol=2.3e-5)
STEP_TOL = dict(rtol=2e-6, atol=2e-6)

JAX_ORACLES = f"""
import dataclasses, functools, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.models import moe as M
from repro.models import transformer as jt
from repro.train import optimizer as jopt
from repro.train.train_step import lm_loss, make_train_step

inp = dict(np.load(sys.argv[1]))
out = {{}}
B, ACCUM, LR = {B}, {ACCUM}, {LR}
blocks = dict(block_q=8, block_kv=8)

def params_of(tag):
    pre = tag + "/"
    layers = {{k[len(pre) + 7:]: jnp.asarray(v) for k, v in inp.items()
              if k.startswith(pre + "layers.")}}
    p = {{"embed": jnp.asarray(inp[pre + "embed"]), "ln_f": jnp.asarray(inp[pre + "ln_f"]),
         "layers": layers}}
    if pre + "lm_head" in inp:
        p["lm_head"] = jnp.asarray(inp[pre + "lm_head"])
    return p

def serve(params, cfg, ptoks, dtoks):
    prefill = jax.jit(lambda p, t: jt.prefill(p, t, cfg, max_len={S}, **blocks))
    decode = jax.jit(lambda p, c, t: jt.decode_step(p, c, t, cfg))
    logits, cache = prefill(params, ptoks)
    res = {{"prefill": logits, "k": cache["k"], "v": cache["v"]}}
    for i in range({DEC_STEPS}):
        res[f"dec{{i}}"], cache = decode(params, cache, dtoks[i])
    return res

plain = lambda tokens, src, valid, dest: (jnp.take_along_axis(tokens, src[..., None], axis=1)
                                          * valid[..., None].astype(tokens.dtype))
for tag, (arch, changes) in {ARCHS!r}.items():
    cfg = dataclasses.replace(get_smoke_config(arch), **changes)
    params = params_of(tag)
    toks = jnp.asarray(inp["tokens"])
    batch = {{"tokens": toks[:, :-1], "labels": toks[:, 1:]}}
    ptoks, dtoks = jnp.asarray(inp["ptoks"]), jnp.asarray(inp["dtoks"])
    loss_fn = functools.partial(lm_loss, cfg=cfg, **blocks)
    forward = jax.jit(lambda p, t: jt.forward(p, t, cfg, **blocks)[0])
    loss = jax.jit(lambda p, b: loss_fn(p, b)[0])
    if not cfg.is_moe:
        out[f"{{tag}}/logits"] = forward(params, batch["tokens"])
        out[f"{{tag}}/loss"] = loss(params, batch)
        opt = jopt.adamw(jopt.warmup_cosine(LR, 1, 100))
        for acc_tag, acc_dt in (("", jnp.float32), ("bf16/", jnp.bfloat16)):
            if acc_tag and tag != "llama3.2-1b":
                continue
            step = make_train_step(lambda p, b: loss_fn(p, b), opt, accum_steps=ACCUM,
                                   accum_dtype=acc_dt)
            # bf16 sums round per microbatch: the rows in the (4, 2) mesh's microbatches
            dp4, mb = {MESHES["4x2"][0]}, B // {MESHES["4x2"][0]} // ACCUM
            perm = np.asarray([b * mb * ACCUM + m * mb + j for m in range(ACCUM)
                               for b in range(dp4) for j in range(mb)])
            new, _, m = jax.jit(step)(params, opt.init(params),
                                      {{k: v[perm] for k, v in batch.items()}} if acc_tag else batch)
            out[f"{{tag}}/{{acc_tag}}grad_norm"] = m["grad_norm"]
            if not acc_tag:
                grads = jax.jit(lambda p: jopt.clip_by_global_norm(
                    jax.grad(lambda q: loss_fn(q, batch)[0])(p), 1.0)[0])(params)
                for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
                    name = ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in k)
                    out[f"{{tag}}/grad/{{name}}"] = v
            for k, v in jax.tree_util.tree_flatten_with_path(new)[0]:
                name = ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in k)
                out[f"{{tag}}/{{acc_tag}}step/{{name}}"] = v
        for k, v in serve(params, cfg, ptoks, dtoks).items():
            out[f"{{tag}}/{{k}}"] = v
        continue
    # the MoE model: per data block of each mesh, the dispatch VJP as autodiff's
    M._dispatch_gather = plain
    for mesh_tag, (dp, _) in {MESHES!r}.items():
        bl = B // dp
        rows = lambda b: slice(b * bl, (b + 1) * bl)
        pre = f"{{tag}}/{{mesh_tag}}/"
        out[pre + "logits"] = jnp.concatenate(
            [forward(params, batch["tokens"][rows(b)]) for b in range(dp)])
        out[pre + "loss"] = jnp.mean(jnp.stack(
            [loss(params, {{k: v[rows(b)] for k, v in batch.items()}}) for b in range(dp)]))
        mb = bl // ACCUM
        def total(p):
            per = [loss_fn(p, {{k: v[b * bl + m * mb:b * bl + (m + 1) * mb]
                               for k, v in batch.items()}})[0]
                   for m in range(ACCUM) for b in range(dp)]
            return jnp.sum(jnp.stack(per)) / (dp * ACCUM)
        grads, gnorm = jax.jit(lambda p: jopt.clip_by_global_norm(jax.grad(total)(p), 1.0))(
            params)
        opt = jopt.adafactor(jopt.warmup_cosine(LR, 1, 100), min_dim_factored={MIN_FACTORED})
        upd, _ = jax.jit(opt.update)(grads, opt.init(params), params)
        new = jax.tree.map(lambda p, u: p + u.astype(p.dtype), params, upd)
        out[pre + "grad_norm"] = gnorm
        for k, v in jax.tree_util.tree_flatten_with_path(grads)[0]:
            name = ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in k)
            out[pre + "grad/" + name] = v
        for k, v in jax.tree_util.tree_flatten_with_path(new)[0]:
            name = ".".join(str(getattr(e, "key", getattr(e, "idx", e))) for e in k)
            out[pre + "step/" + name] = v
        parts = [serve(params, cfg, ptoks[rows(b)], dtoks[:, rows(b)]) for b in range(dp)]
        for k in parts[0]:
            out[pre + k] = jnp.concatenate([p_[k] for p_ in parts], axis=1 if k in "kv" else 0)
np.savez(sys.argv[2], **{{k: np.asarray(v, np.float32) for k, v in out.items()}})
"""


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread per worker (the port's ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tag):
    arch, changes = ARCHS[tag]
    return dataclasses.replace(get_smoke_config(arch), **changes)


def _inputs() -> dict:
    """The parameters (the port's seeded init) and token arrays, from numpy."""
    rng = np.random.default_rng(0)
    inp = {"tokens": rng.integers(0, 256, (B, T + 1)).astype(np.int32),
           "ptoks": rng.integers(0, 256, (B, PT)).astype(np.int32),
           "dtoks": rng.integers(0, 256, (DEC_STEPS, B)).astype(np.int32)}
    for tag in ARCHS:
        params = ttr.init_params(_cfg(tag), torch.Generator().manual_seed(3), device="cpu")
        inp.update({f"{tag}/{k}": p.detach().numpy() for k, p in params.named_parameters()})
    return inp


def _rank(dev, inputs_path: str, out_dir: str) -> dict:
    """The port's side on one rank: every config on both meshes."""
    from repro_torch.sharding import api
    from repro_torch.sharding.api import P, shard, unshard, use_mesh
    from repro_torch.train import optimizer as topt
    from repro_torch.train.train_step import lm_loss, make_train_step

    t = {k: torch.from_numpy(v).to(dev) for k, v in np.load(inputs_path).items()}
    meshes = {k: api.Mesh(shape, ("data", "model")) for k, shape in MESHES.items()}
    out = {}
    rows = P(("data",), None)
    kv = ttr.kv_cache_specs(("model",), ("data",))
    for tag in ARCHS:
        cfg = _cfg(tag)
        full = ttr.init_params(cfg, torch.Generator().manual_seed(3), device="cpu").to(dev)
        for mesh_tag, mesh in meshes.items():
            pre = f"{tag}/{mesh_tag}/"
            specs = ttr.param_specs(cfg, fsdp_axis=("data",))
            flat = api.flatten(specs)
            with use_mesh(mesh):
                def local():
                    return ttr.shard_params(full, specs, mesh)

                model = local()
                out[pre + "block_share"] = np.asarray(
                    sum(p.numel() for p in model.parameters())
                    / sum(p.numel() for p in full.parameters()))
                toks = shard(t["tokens"], rows, mesh)
                batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
                with torch.no_grad():
                    logits, _ = ttr.forward(model, batch["tokens"], cfg, **BLOCKS)
                    out[pre + "logits"] = unshard(logits, P(("data",), None, None))
                    out[pre + "loss"] = lm_loss(model, batch, cfg, **BLOCKS)[0]
                lr = topt.warmup_cosine(LR, 1, 100)
                accs = [("", torch.float32)] + ([("bf16/", torch.bfloat16)]
                                                if tag == "llama3.2-1b" and mesh_tag == "4x2"
                                                else [])
                for acc_tag, acc_dt in accs:
                    model = local()
                    params = dict(model.named_parameters())
                    inner = (topt.adafactor(lr, min_dim_factored=MIN_FACTORED, specs=flat)
                             if cfg.is_moe else topt.adamw(lr))
                    seen = {}

                    def update(grads, state, params, inner=inner, seen=seen):
                        seen.update(grads)  # the clipped gradient the optimizer is given
                        return inner.update(grads, state, params)

                    opt = topt.Optimizer(inner.init, update, inner.state_specs)
                    step = make_train_step(lambda m, b: lm_loss(m, b, cfg, **BLOCKS), opt,
                                           accum_steps=ACCUM, accum_dtype=acc_dt)
                    model, _, metrics = step(model, opt.init(params), batch)
                    out[f"{pre}{acc_tag}grad_norm"] = metrics["grad_norm"]
                    for k, p in model.named_parameters():
                        out[f"{pre}{acc_tag}step/{k}"] = unshard(p.detach(), flat[k])
                        if not acc_tag:
                            out[f"{pre}grad/{k}"] = unshard(seen[k].float(), flat[k])
                model = local()
                cache_logits, cache = ttr.prefill(model, shard(t["ptoks"], rows, mesh), cfg,
                                                  max_len=S, **BLOCKS)
                out[pre + "prefill"] = unshard(cache_logits, rows)
                out[pre + "k"], out[pre + "v"] = unshard(cache["k"], kv["k"]), unshard(
                    cache["v"], kv["v"])
                for i in range(DEC_STEPS):
                    dl, cache = ttr.decode_step(model, cache, shard(t["dtoks"][i], P(("data",)),
                                                                    mesh),
                                                cfg, mesh=mesh, seq_axes=("model",), dp=("data",))
                    out[pre + f"dec{i}"] = unshard(dl, rows)
                if tag == "llama3.2-1b":  # the sharded global norm of random "gradients"
                    g = torch.Generator().manual_seed(11)
                    grads = {k: torch.randn(p.shape, generator=g).to(dev)
                             for k, p in full.named_parameters()}
                    blocks = {k: shard(v, flat[k], mesh) for k, v in grads.items()}
                    out[pre + "norm_sharded"] = topt.clip_by_global_norm(blocks, 1.0, flat)[1]
                    out[pre + "norm_whole"] = topt.global_norm(grads)
    np.savez(f"{out_dir}/rank{meshes['4x2'].rank}.npz",
             **{k: v.detach().float().cpu().numpy() if torch.is_tensor(v) else v
                for k, v in out.items()})
    return {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's oracles, [each rank's port results])."""
    tmp = tmp_path_factory.mktemp("fsdp")
    inputs, oracles = tmp / "inputs.npz", tmp / "jax.npz"
    np.savez(inputs, **_inputs())
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    with open(tmp / "jax.log", "w") as log:
        proc = subprocess.Popen([sys.executable, "-c", JAX_ORACLES, str(inputs), str(oracles)],
                                env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            run_ranks(_rank, RANKS, "cpu", str(inputs), str(tmp))
            rc = proc.wait(timeout=600)
        finally:
            proc.kill()
    assert rc == 0, (tmp / "jax.log").read_text()
    return dict(np.load(oracles)), [dict(np.load(tmp / f"rank{r}.npz")) for r in range(RANKS)]


def _want(want, tag, mesh_tag, key):
    """The oracle: per mesh for the MoE model, else one for both meshes."""
    return want[f"{tag}/{mesh_tag}/{key}"] if _cfg(tag).is_moe else want[f"{tag}/{key}"]


CASES = [(tag, m) for tag in ARCHS for m in MESHES]


@pytest.mark.parametrize("tag,mesh_tag", CASES)
def test_blocks_are_fsdp_by_tp(runs, tag, mesh_tag):
    """Each rank holds about 1/8 of the parameters (norms and the router whole)."""
    _, ranks = runs
    for r in ranks:
        assert float(r[f"{tag}/{mesh_tag}/block_share"]) < 0.2


@pytest.mark.parametrize("tag,mesh_tag", CASES)
def test_forward_and_loss_equal_repro(runs, tag, mesh_tag):
    want, ranks = runs
    for r in ranks:
        for key in ("logits", "loss"):
            np.testing.assert_allclose(r[f"{tag}/{mesh_tag}/{key}"],
                                       _want(want, tag, mesh_tag, key), **TOL, err_msg=key)


@pytest.mark.parametrize("tag,mesh_tag", CASES)
def test_accumulated_train_step_equals_repro(runs, tag, mesh_tag):
    """One step, ``accum_steps=2``: AdamW (kimi-k2: Adafactor, its shared
    expert and experts included), the global-norm clip of the sharded
    gradient; every parameter after the step."""
    want, ranks = runs
    pre = f"{tag}/{mesh_tag}/"
    for r in ranks:
        np.testing.assert_allclose(r[pre + "grad_norm"], _want(want, tag, mesh_tag, "grad_norm"),
                                   rtol=1e-5)
        names = [k[len(pre) + 5:] for k in r if k.startswith(pre + "step/")]
        assert names and any(n.startswith("layers.sh_") for n in names) == _cfg(tag).is_moe
        for name in names:
            g = _want(want, tag, mesh_tag, "grad/" + name)
            np.testing.assert_allclose(r[pre + "grad/" + name], g, **TOL, err_msg=name)
            got, ref = r[pre + "step/" + name], _want(want, tag, mesh_tag, "step/" + name)
            amplified = np.abs(g) < 1e-6 if not _cfg(tag).is_moe else np.zeros(g.shape, bool)
            np.testing.assert_allclose(got[~amplified], ref[~amplified], **STEP_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(got[amplified], ref[amplified], rtol=0, atol=LR,
                                       err_msg=name)


@pytest.mark.parametrize("tag,mesh_tag", CASES)
def test_prefill_and_decode_equal_repro(runs, tag, mesh_tag):
    """``prefill``'s logits and cache (gathered from the sequence blocks), then
    ``decode_step(mesh=)`` 4 times on that cache."""
    want, ranks = runs
    for r in ranks:
        for key in ["prefill", "k", "v"] + [f"dec{i}" for i in range(DEC_STEPS)]:
            np.testing.assert_allclose(r[f"{tag}/{mesh_tag}/{key}"],
                                       _want(want, tag, mesh_tag, key), **TOL, err_msg=key)


def test_bf16_accumulation_equals_repro(runs):
    """``accum_dtype=torch.bfloat16`` against ``repro``'s ``jnp.bfloat16``."""
    want, ranks = runs
    pre = "llama3.2-1b/4x2/bf16/"
    for r in ranks:
        np.testing.assert_allclose(r[pre + "grad_norm"], want["llama3.2-1b/bf16/grad_norm"],
                                   rtol=1e-2)
        names = [k[len(pre) + 5:] for k in r if k.startswith(pre + "step/")]
        assert names
        for name in names:
            np.testing.assert_allclose(r[pre + "step/" + name],
                                       want["llama3.2-1b/bf16/step/" + name], rtol=0,
                                       atol=LR * 2 ** -7, err_msg=name)


@pytest.mark.parametrize("mesh_tag", sorted(MESHES))
def test_sharded_global_norm_equals_the_whole_norm(runs, mesh_tag):
    _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"llama3.2-1b/{mesh_tag}/norm_sharded"],
                                   r[f"llama3.2-1b/{mesh_tag}/norm_whole"], rtol=1e-6)
