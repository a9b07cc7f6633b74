"""Port parity: every on-mesh path (``repro_torch.sharding.api`` and the
regions of ``models/`` and ``train/``) on 8 gloo ranks against ``repro``'s
(4, 2) ("data", "model") mesh of 8 forced host devices.

The input arrays come from numpy with a seed and go to both sides.  One
JAX subprocess writes the oracles (the count of host devices must be set
before JAX starts, as in ``tests/test_multidevice.py``): ``embedding_lookup``
on the mesh at B 16 (the reduce-scatter path) and B 5 (the psum path) with
its table gradient; ``sharded_xent``'s loss and gradients (t_chunk 8);
``moe_ffn`` on the mesh (expert-parallel) at capacity factor 32 and 1.0 (h
(8, 64, 16): something drops), with shared experts, beside the same
function off the mesh (one ``_moe_ffn_gather`` per data block, the dispatch
as its plain forward); the off-mesh ``decode_step`` of gemma3 SMOKE, 5 steps
(``repro``'s on-mesh decode raises: ROADMAP §3); the off-mesh GCN forward,
loss and gradients under each aggregation.  One spawn of 8 gloo ranks, one
intra-op thread each, runs the port's side in the local view while the
subprocess compiles: each rank cuts its blocks with ``shard`` and gathers
the results back with ``unshard``.

Tolerances are ``tests/test_multidevice.py``'s: the embedding rtol 1e-6,
the cross-entropy's loss rtol 1e-5 and gradients rtol 1e-4, atol 1e-6, the
MoE rtol 2e-4, atol 2e-5, the decode's logits 2e-4 and cache 1e-5; the GCN
and ``lm_loss``, which it does not hold, at ``tests/test_torch_gnn.py``'s
rtol = atol = 1e-5.
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
from repro_torch.models import gnn as tgnn
from repro_torch.models import transformer as ttr

ROOT = pathlib.Path(__file__).resolve().parents[1]
RANKS, MESH = 8, ((4, 2), ("data", "model"))
DP = 4  # the data blocks of MESH
VOCAB, TABLE_ROWS, EMB_DIM = (64, 96, 32), 2048, 8
MOE_CASES = {"cf32": (32.0, (8, 4, 16)), "cf1": (1.0, (8, 64, 16))}
MOE = dict(d_model=16, n_experts=8, top_k=2, d_ff_expert=24, n_shared=1)
DEC_B, DEC_S, DEC_STEPS = 4, 32, 5
# gemma3 SMOKE's window is 8 and the seq shards hold 16 positions each: rows
# 0 and 1 cross the shard boundary during the 5 steps, every row is past the window
DEC_LENGTHS = (13, 15, 9, 20)
GCN_N, GCN_E = 64, 192  # with the self loops 256 edges, 64 per data rank
GCN_VARIANTS = {"sym": ("sym", "mean"), "mean": ("none", "mean"), "max": ("none", "max"),
                "sum": ("none", "sum")}
# "arch[ variant]" -> on the (4, 2) mesh (else on an (8,) "data"-only one).  The
# MoE data-only and at 3 experts (which do not split over "model") takes the
# gather path on each rank's block, the others the expert-parallel region
LM_CASES = {"llama3.2-1b": True, "phi3.5-moe-42b-a6.6b": True, "llama3.2-1b data-only": False,
            "phi3.5-moe-42b-a6.6b data-only": False, "phi3.5-moe-42b-a6.6b 3 experts": True}
LM_B, LM_T = 8, 16
SPEC_SHAPES = {"replicated": (), "data": ("data",), "model_rows": ("model", None),
               "data_model": (("data", "model"),), "model_data": (("model", "data"),),
               "cols": (None, ("model",)), "two_dims": ("data", None, "model"),
               "kv_cache": (None, ("data",), ("model",), None)}
TOL = dict(rtol=1e-5, atol=1e-5)

JAX_ORACLES = f"""
import dataclasses, os, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.configs.base import LMConfig, MoEConfig
from repro.models import gnn, transformer
from repro.models import moe as M
from repro.models.embedding import embedding_lookup
from repro.sharding.api import use_mesh
from repro.train.train_step import sharded_xent

inp = {{k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}}
mesh = jax.make_mesh({MESH[0]}, {MESH[1]})
out = {{}}

table, ids, offsets = inp["emb_table"], inp["emb_ids"], inp["emb_offsets"]
for B in (16, 5):
    with use_mesh(mesh):
        o, vjp = jax.vjp(jax.jit(lambda t: embedding_lookup(t, ids[:B], offsets)), table)
        out[f"emb_out{{B}}"], out[f"emb_grad{{B}}"] = o, vjp(inp["emb_cot"][:B])[0]

h, w, lab = inp["xent_h"], inp["xent_w"], inp["xent_labels"]
def xent_ref(h, w):
    lg = h @ w
    return jnp.mean(jax.nn.logsumexp(lg, -1) - jnp.take_along_axis(lg, lab[..., None], -1)[..., 0])
out["xent_ref"], (out["xent_ref_gh"], out["xent_ref_gw"]) = jax.value_and_grad(
    xent_ref, (0, 1))(h, w)
with use_mesh(mesh):
    out["xent"], (out["xent_gh"], out["xent_gw"]) = jax.jit(jax.value_and_grad(
        lambda h, w: sharded_xent(h, w, lab, mesh, t_chunk=8), (0, 1)))(h, w)

lp = {{k[4:]: v for k, v in inp.items() if k.startswith("moe_") and not k.startswith("moe_h")
      and not k.startswith("moe_cot")}}
plain = lambda tokens, src, valid, dest: (jnp.take_along_axis(tokens, src[..., None], axis=1)
                                          * valid[..., None].astype(tokens.dtype))
for tag, (cf, shape) in {MOE_CASES!r}.items():
    cfg = LMConfig(name="t", n_layers=1, d_model={MOE['d_model']}, n_heads=2, n_kv_heads=2,
                   d_head=8, d_ff=24, vocab_size=64, dtype="float32", remat=False,
                   moe=MoEConfig(n_experts={MOE['n_experts']}, top_k={MOE['top_k']},
                                 d_ff_expert={MOE['d_ff_expert']}, capacity_factor=cf,
                                 n_shared={MOE['n_shared']}))
    h, cot = inp[f"moe_h_{{tag}}"], inp[f"moe_cot_{{tag}}"]
    def on_mesh(h, lp):
        o, aux = M.moe_ffn(h, lp, cfg)
        return jnp.sum(o * cot) + 0.5 * aux, (o, aux)
    def off_mesh(h, lp):
        parts = [M._moe_ffn_gather(b, lp, cfg) for b in jnp.split(h, {DP})]
        o = jnp.concatenate([p[0] for p in parts])
        aux = jnp.mean(jnp.stack([p[1] for p in parts]))
        return jnp.sum(o * cot) + 0.5 * aux, (o, aux)
    with use_mesh(mesh):
        (_, (o, aux)), g = jax.jit(jax.value_and_grad(on_mesh, (0, 1), has_aux=True))(h, lp)
    dispatch, M._dispatch_gather = M._dispatch_gather, plain
    (_, (o_ref, aux_ref)), g_ref = jax.value_and_grad(off_mesh, (0, 1), has_aux=True)(h, lp)
    M._dispatch_gather = dispatch
    out.update({{f"moe_{{tag}}_out": o, f"moe_{{tag}}_aux": aux, f"moe_{{tag}}_gh": g[0],
                f"moe_{{tag}}_ref_out": o_ref, f"moe_{{tag}}_ref_aux": aux_ref,
                f"moe_{{tag}}_ref_gh": g_ref[0]}})
    for k in lp:
        out[f"moe_{{tag}}_g_{{k}}"], out[f"moe_{{tag}}_ref_g_{{k}}"] = g[1][k], g_ref[1][k]

cfg = get_smoke_config("gemma3-12b")
params = {{"embed": inp["dec_embed"], "ln_f": inp["dec_ln_f"],
          "layers": {{k[11:]: v for k, v in inp.items() if k.startswith("dec_layers.")}},
          **({{"lm_head": inp["dec_lm_head"]}} if "dec_lm_head" in inp else {{}})}}
cache = {{"k": inp["dec_k"], "v": inp["dec_v"], "length": inp["dec_length"]}}
for i in range({DEC_STEPS}):
    out[f"dec_logits{{i}}"], cache = transformer.decode_step(params, cache, inp["dec_tokens"][i],
                                                             cfg)
out["dec_k"], out["dec_v"] = cache["k"], cache["v"]

graph = {{k[6:]: v for k, v in inp.items() if k.startswith("graph_")}}
gparams = {{"w": [inp[f"gcn_w{{i}}"] for i in range(2)], "b": [inp[f"gcn_b{{i}}"] for i in range(2)]}}
for tag, (norm, agg) in {GCN_VARIANTS!r}.items():
    cfg = dataclasses.replace(get_smoke_config("gcn-cora"), norm=norm, aggregator=agg)
    out[f"gcn_{{tag}}_logits"] = gnn.forward(gparams, graph, cfg)
    loss, g = jax.value_and_grad(gnn.loss_fn)(gparams, graph, cfg)
    out[f"gcn_{{tag}}_loss"] = loss
    for i in range(2):
        out[f"gcn_{{tag}}_gw{{i}}"], out[f"gcn_{{tag}}_gb{{i}}"] = g["w"][i], g["b"][i]
np.savez(sys.argv[2], **{{k: np.asarray(v) for k, v in out.items()}})
"""


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread per worker (the port's ranks set their own)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe_cfg(cf: float):
    from repro_torch.configs.base import LMConfig, MoEConfig

    return LMConfig(name="t", n_layers=1, d_model=MOE["d_model"], n_heads=2, n_kv_heads=2,
                    d_head=8, d_ff=24, vocab_size=64, dtype="float32", remat=False,
                    moe=MoEConfig(n_experts=MOE["n_experts"], top_k=MOE["top_k"],
                                  d_ff_expert=MOE["d_ff_expert"], capacity_factor=cf,
                                  n_shared=MOE["n_shared"]))


def _inputs() -> dict:
    """Every input array, from numpy with a seed (the port's seeded inits
    for the models' weights, which each rank redraws alike)."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.embedding import field_offsets

    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    inp = {"emb_table": f32(TABLE_ROWS, EMB_DIM) * EMB_DIM ** -0.5,
           "emb_ids": np.stack([rng.integers(0, v, 16) for v in VOCAB], 1).astype(np.int32),
           "emb_offsets": field_offsets(VOCAB).numpy().astype(np.int32),
           "emb_cot": f32(16, len(VOCAB), EMB_DIM),
           "xent_h": f32(8, 16, 32), "xent_w": f32(32, 64) * 0.1,
           "xent_labels": rng.integers(0, 64, (8, 16)).astype(np.int32)}
    cfg = _moe_cfg(1.0)
    layer = tmoe.init_moe_layer(cfg, torch.Generator().manual_seed(1), "cpu")
    inp.update({f"moe_{k}": w[0].numpy() for k, w in layer.items()})
    for tag, (_, shape) in MOE_CASES.items():
        inp[f"moe_h_{tag}"], inp[f"moe_cot_{tag}"] = f32(*shape), f32(*shape)
    dcfg = get_smoke_config("gemma3-12b")
    params = ttr.init_params(dcfg, device="cpu")
    inp.update({f"dec_{k}": p.detach().numpy() for k, p in params.named_parameters()})
    shape = (dcfg.n_layers, DEC_B, DEC_S, dcfg.n_kv_heads, dcfg.d_head)
    inp.update(dec_k=f32(*shape), dec_v=f32(*shape),
               dec_length=np.asarray(DEC_LENGTHS, np.int32),
               dec_tokens=rng.integers(0, dcfg.vocab_size, (DEC_STEPS, DEC_B)).astype(np.int32))
    gcfg = get_smoke_config("gcn-cora")
    inp.update(graph_features=f32(GCN_N, gcfg.d_feat),
               graph_senders=rng.integers(0, GCN_N, GCN_E).astype(np.int32),
               graph_receivers=rng.integers(0, GCN_N, GCN_E).astype(np.int32),
               graph_labels=rng.integers(0, gcfg.n_classes, GCN_N).astype(np.int32))
    gparams = tgnn.init_params(gcfg, device="cpu")
    for i in range(gcfg.n_layers):
        inp[f"gcn_w{i}"] = gparams.w[i].detach().numpy()
        inp[f"gcn_b{i}"] = gparams.b[i].detach().numpy()
    inp["lm_tokens"] = rng.integers(0, 256, (LM_B, LM_T + 1)).astype(np.int64)
    return inp


def _local_decode_mask(fn):
    """A planted fault: the sequence-parallel decode masks by the block's own
    positions (``pos_offset`` 0), not the absolute ones."""
    def planted(*args, **kw):
        kw["pos_offset"] = 0
        return fn(*args, **kw)

    return planted


def _rank(dev, inputs_path: str, out_dir: str) -> dict:
    """The port's side on one rank, its tensors on ``dev``: every path,
    results to ``out_dir/rank<r>.npz``."""
    from repro_torch.convert import shard_tree
    from repro_torch.core import distributed as cd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models.embedding import embedding_lookup, table_spec
    from repro_torch.sharding import api
    from repro_torch.sharding.api import P, psum, shard, unshard, use_mesh
    from repro_torch.train.train_step import lm_loss, sharded_xent

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = api.Mesh(*MESH)
    t = {k: torch.from_numpy(v).to(dev) for k, v in np.load(inputs_path).items()}
    out = {"coords": np.asarray(mesh.coords), "backend": np.asarray(mesh.backend),
           "composed": np.asarray(sorted(mesh.composed))}
    try:
        make_production_mesh()
    except ValueError as e:
        out["production_error"] = np.asarray(str(e))

    g = torch.Generator().manual_seed(7)
    x = torch.randn(8, 8, 4, 2, generator=g).to(dev)
    for name, spec in SPEC_SHAPES.items():
        out[f"spec_{name}"] = np.asarray(torch.equal(unshard(shard(x, P(*spec), mesh),
                                                             P(*spec), mesh), x))

    def leaf(a, spec):
        return shard(a, spec, mesh).detach().requires_grad_(True)

    with use_mesh(mesh):
        # embedding_lookup: the table's row blocks over ("model", "data")
        spec = table_spec("model", "data")
        for B in (16, 5):
            cd.reset_collective_stats()
            tl = leaf(t["emb_table"], spec)
            emb = embedding_lookup(tl, t["emb_ids"][:B], t["emb_offsets"])
            out_spec = P(("data",), None, None) if B % RANKS == 0 else P(None, None, None)
            cot = shard(t["emb_cot"][:B], out_spec, mesh)
            loss = torch.sum(emb * cot)
            (psum(loss, "data") if B % RANKS == 0 else loss).backward()
            stats = cd.collective_stats()["kinds"]
            out[f"emb_out{B}"] = unshard(emb.detach(), out_spec)
            out[f"emb_grad{B}"] = unshard(tl.grad, spec)
            out[f"emb_block_bytes{B}"] = np.asarray(tl.numel() * 4)
            out[f"emb_max_bytes{B}"] = np.asarray(max(s["max_bytes"] for s in stats.values()))

        # sharded_xent: hidden over the data axes, the head's vocab over "model"
        hl, wl = leaf(t["xent_h"], P(("data",), None, None)), leaf(t["xent_w"], P(None, "model"))
        labels = shard(t["xent_labels"], P(("data",), None), mesh)
        loss = sharded_xent(hl, wl, labels, mesh, t_chunk=8)
        loss.backward()
        out["xent"] = loss.detach()
        out["xent_gh"] = unshard(hl.grad, P(("data",), None, None))
        out["xent_gw"] = unshard(wl.grad, P(None, "model"))

        # moe_ffn -> _moe_ffn_ep: the experts over ("model", "data")
        specs = {k: P(*s[1:]) for k, s in tmoe.moe_layer_specs(_moe_cfg(1.0)).items()}
        for tag, (cf, shape) in MOE_CASES.items():
            cfg = _moe_cfg(cf)
            lp = {k: leaf(t[f"moe_{k}"], specs[k]) for k in specs}
            h = leaf(t[f"moe_h_{tag}"], P(("data",), None, None))
            o, aux = tmoe.moe_ffn(h, lp, cfg)
            cot = shard(t[f"moe_cot_{tag}"], P(("data",), None, None), mesh)
            (psum(torch.sum(o * cot), "data") + 0.5 * aux).backward()
            out[f"moe_{tag}_out"] = unshard(o.detach(), P(("data",), None, None))
            out[f"moe_{tag}_aux"] = aux.detach()
            out[f"moe_{tag}_gh"] = unshard(h.grad, P(("data",), None, None))
            for k in lp:
                out[f"moe_{tag}_g_{k}"] = unshard(lp[k].grad, specs[k])
            N_loc = h.shape[0] * h.shape[1]
            _, _, idx = tmoe._route(h.detach().reshape(N_loc, -1), lp["router"].detach(),
                                    cfg.moe.top_k)
            C = tmoe._capacity(N_loc, cfg)
            plan = tmoe._routing_plan(idx[None], cfg.moe.n_experts, C)
            dropped = (plan["dest"] >= cfg.moe.n_experts * C).sum().float()
            out[f"moe_{tag}_dropped"] = psum(dropped, "data")

        # decode_step(mesh=): the cache over ("data", "model"), 5 steps
        dcfg = get_smoke_config("gemma3-12b")
        params = ttr.init_params(dcfg, device="cpu").to(dev)
        kv = P(None, ("data",), ("model",), None, None)
        for tag, planted in (("dec", False), ("dec_planted", True)):
            cache = {"k": shard(t["dec_k"], kv, mesh), "v": shard(t["dec_v"], kv, mesh),
                     "length": shard(t["dec_length"], P(("data",)), mesh)}
            attend = ttr.decode_attention_local
            if planted:
                ttr.decode_attention_local = _local_decode_mask(attend)
            try:
                for i in range(DEC_STEPS):
                    toks = shard(t["dec_tokens"][i], P(("data",)), mesh)
                    logits, cache = ttr.decode_step(params, cache, toks, dcfg, mesh=mesh,
                                                    seq_axes=("model",), dp=("data",))
                    out[f"{tag}_logits{i}"] = unshard(logits, P(("data",), None))
            finally:
                ttr.decode_attention_local = attend
            out[f"{tag}_k"] = unshard(cache["k"], kv)
            out[f"{tag}_v"] = unshard(cache["v"], kv)

        # gnn.forward(edge_sharded=True): the self-looped edge list over "data"
        gcfg0 = get_smoke_config("gcn-cora")
        loops = torch.arange(GCN_N, dtype=torch.int32, device=dev)
        edges = {k: shard(torch.cat([t[f"graph_{k}"], loops]), P(("data",)), mesh)
                 for k in ("senders", "receivers")}
        graph = {"features": t["graph_features"], "labels": t["graph_labels"], **edges}
        for tag, (norm, agg) in GCN_VARIANTS.items():
            gcfg = dataclasses.replace(gcfg0, norm=norm, aggregator=agg)
            gparams = tgnn.init_params(gcfg, device=dev)
            out[f"gcn_{tag}_logits"] = tgnn.forward(gparams, graph, gcfg,
                                                     edge_sharded=True).detach()
            loss = tgnn.loss_fn(gparams, graph, gcfg, edge_sharded=True)
            loss.backward()
            out[f"gcn_{tag}_loss"] = loss.detach()
            for i in range(gcfg.n_layers):
                out[f"gcn_{tag}_gw{i}"] = gparams.w[i].grad
                out[f"gcn_{tag}_gb{i}"] = gparams.b[i].grad

    # lm_loss on the mesh against the mean over the data blocks off it; on the
    # (4, 2) mesh through sharded_xent, on an (8,) ("data",) one without
    toks = t["lm_tokens"]
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    data_only = api.Mesh((RANKS,), ("data",))
    for arch, lm_mesh in LM_CASES.items():
        lm_mesh = mesh if lm_mesh else data_only
        cfg = get_smoke_config(arch.split(" ")[0])
        if arch.endswith(" 3 experts"):
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=3))
        n_dp = lm_mesh.shape["data"]
        full = ttr.init_params(cfg, device="cpu").to(dev)
        ref_loss = sum(lm_loss(full, {k: v.chunk(n_dp)[b] for k, v in batch.items()}, cfg)[0]
                       for b in range(n_dp)) / n_dp
        ref_loss.backward()
        ep = cfg.is_moe and "model" in lm_mesh.axis_names \
            and cfg.moe.n_experts % lm_mesh.shape["model"] == 0
        moe_specs = tmoe.moe_layer_specs(cfg) if ep else {}
        layers = {k: p.detach() for k, p in full.layers.items()}
        local = shard_tree(layers, {k: moe_specs.get(k, P()) for k in layers}, lm_mesh)
        model = ttr.LMParams(full.embed.detach().clone(), full.ln_f.detach().clone(), local,
                             None if full.lm_head is None else full.lm_head.detach().clone())
        with use_mesh(lm_mesh):
            block = {k: shard(v, P(("data",), None), lm_mesh) for k, v in batch.items()}
            loss, _ = lm_loss(model, block, cfg)
            loss.backward()
            grads = {k: unshard(p.grad, moe_specs.get(k.removeprefix("layers."), P()))
                     for k, p in model.named_parameters()}
        out[f"lm_{arch}_loss"] = loss.detach()
        out[f"lm_{arch}_ref_loss"] = ref_loss.detach()
        for k, p in full.named_parameters():
            out[f"lm_{arch}_g_{k}"] = grads[k]
            out[f"lm_{arch}_ref_g_{k}"] = p.grad

    out["stats_kinds"] = np.asarray(sorted(cd.collective_stats()["kinds"]))
    np.savez(f"{out_dir}/rank{mesh.rank}.npz",
             **{k: v.detach().cpu().numpy() if torch.is_tensor(v) else v for k, v in out.items()})
    return {}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(repro's oracles, [each rank's port results])."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs, oracles = tmp / "inputs.npz", tmp / "jax.npz"
    np.savez(inputs, **_inputs())
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={RANKS}",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
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


def test_mesh_layout_and_backend(runs):
    """Row-major coordinates over the ranks, as ``jax.make_mesh``; gloo
    composes ``psum_scatter``; a production mesh needs 256 ranks."""
    _, ranks = runs
    coords = [tuple(r["coords"]) for r in ranks]
    assert coords == [tuple(int(c) for c in np.unravel_index(i, MESH[0])) for i in range(RANKS)]
    for r in ranks:
        assert str(r["backend"]) == "gloo"
        assert list(r["composed"]) == ["psum_scatter"]
        assert "needs 256 ranks" in str(r["production_error"])
        assert {"psum", "pmax", "all_gather", "psum_scatter"} <= set(r["stats_kinds"])


@pytest.mark.parametrize("name", sorted(SPEC_SHAPES))
def test_shard_then_unshard_is_identity(runs, name):
    _, ranks = runs
    assert all(bool(r[f"spec_{name}"]) for r in ranks)


@pytest.mark.parametrize("B", [16, 5])
def test_embedding_lookup_equals_repro(runs, B):
    """B 16 splits over the 8 row shards (reduce-scatter, then the re-gather
    over "model"); B 5 takes the psum path."""
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"emb_out{B}"], want[f"emb_out{B}"], rtol=1e-6)
        np.testing.assert_allclose(r[f"emb_grad{B}"], want[f"emb_grad{B}"], rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("B", [16, 5])
def test_embedding_moves_no_table_sized_collective(runs, B):
    """The lookup and its backward move at most a (B, F, dim) tensor, never
    the table (each rank's gradient is its own rows')."""
    _, ranks = runs
    for r in ranks:
        assert r[f"emb_max_bytes{B}"] <= B * len(VOCAB) * EMB_DIM * 4
        assert r[f"emb_max_bytes{B}"] < r[f"emb_block_bytes{B}"]


def test_sharded_xent_equals_repro(runs):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r["xent"], want["xent"], rtol=1e-5)
        np.testing.assert_allclose(r["xent"], want["xent_ref"], rtol=1e-5)
        for g in ("gh", "gw"):
            np.testing.assert_allclose(r[f"xent_{g}"], want[f"xent_{g}"], rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(r[f"xent_{g}"], want[f"xent_ref_{g}"], rtol=1e-4,
                                       atol=1e-6)


MOE_GRADS = ["gh"] + [f"g_{k}" for k in ("router", "e_gate", "e_up", "e_down", "sh_gate",
                                         "sh_up", "sh_down")]


@pytest.mark.parametrize("tag", sorted(MOE_CASES))
def test_moe_expert_parallel_equals_repro(runs, tag):
    """Output and aux against ``repro``'s expert-parallel region, and against
    its off-mesh gather path over the mesh's 4 groups."""
    want, ranks = runs
    for r in ranks:
        for ref in ("", "ref_"):
            np.testing.assert_allclose(r[f"moe_{tag}_out"], want[f"moe_{tag}_{ref}out"],
                                       rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(r[f"moe_{tag}_aux"], want[f"moe_{tag}_{ref}aux"],
                                       rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("tag", sorted(MOE_CASES))
def test_moe_expert_parallel_gradients_equal_off_mesh(runs, tag):
    """The input's, the router's and every expert's gradient against
    autograd of the off-mesh function (the dispatch as its plain forward)."""
    want, ranks = runs
    for r in ranks:
        for g in MOE_GRADS:
            np.testing.assert_allclose(r[f"moe_{tag}_{g}"], want[f"moe_{tag}_ref_{g}"],
                                       rtol=2e-4, atol=2e-5, err_msg=g)


@pytest.mark.parametrize("tag", sorted(MOE_CASES))
def test_repro_on_mesh_moe_gradients_equal_its_off_mesh_autograd(runs, tag):
    """Pinned: ``repro``'s expert-parallel gradients agree with the off-mesh
    autograd the port is held to (its ``shard_map`` regions transpose
    exactly; only its off-mesh dispatch VJP differs, ROADMAP §3)."""
    want, _ = runs
    for g in MOE_GRADS:
        np.testing.assert_allclose(want[f"moe_{tag}_{g}"], want[f"moe_{tag}_ref_{g}"],
                                   rtol=2e-4, atol=2e-5, err_msg=g)


def test_moe_capacity_one_drops_assignments(runs):
    """At capacity factor 1.0 and 128 tokens per group some assignment drops
    (C = 40 of 256 assignments over 8 experts); at 32 none does."""
    _, ranks = runs
    assert float(ranks[0]["moe_cf1_dropped"]) > 0
    assert float(ranks[0]["moe_cf32_dropped"]) == 0


def test_sequence_parallel_decode_equals_repro_off_mesh(runs):
    """gemma3 SMOKE (local and global layers), 5 steps, rows crossing the
    seq-shard boundary and past the window: logits and the whole cache."""
    want, ranks = runs
    for r in ranks:
        for i in range(DEC_STEPS):
            np.testing.assert_allclose(r[f"dec_logits{i}"], want[f"dec_logits{i}"], rtol=2e-4,
                                       atol=2e-4)
        for kv in ("k", "v"):
            np.testing.assert_allclose(r[f"dec_{kv}"], want[f"dec_{kv}"], rtol=1e-5, atol=1e-5)


def test_decode_check_fails_on_a_block_local_mask(runs):
    """A window masked by the block's own positions (offset 0) must fail the
    check above: the check has teeth."""
    want, ranks = runs
    err = max(np.abs(ranks[0][f"dec_planted_logits{i}"] - want[f"dec_logits{i}"]).max()
              for i in range(DEC_STEPS))
    assert err > 1e-2, err


@pytest.mark.parametrize("tag", sorted(GCN_VARIANTS))
def test_gcn_edge_sharded_equals_repro(runs, tag):
    want, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"gcn_{tag}_logits"], want[f"gcn_{tag}_logits"], **TOL)
        np.testing.assert_allclose(r[f"gcn_{tag}_loss"], want[f"gcn_{tag}_loss"], **TOL)
        for i in range(2):
            for g in ("gw", "gb"):
                np.testing.assert_allclose(r[f"gcn_{tag}_{g}{i}"], want[f"gcn_{tag}_{g}{i}"],
                                           **TOL, err_msg=f"{g}{i}")


@pytest.mark.parametrize("arch", sorted(LM_CASES))
def test_lm_loss_on_mesh_equals_off_mesh(runs, arch):
    """``lm_loss`` through ``sharded_xent`` (and, for the MoE, the
    expert-parallel FFN, or the gather path on each rank's block when the
    experts do not split over "model"), or on a mesh without "model" the
    ``pmean`` of the blocks' losses, equals the mean of the off-mesh loss
    over the data blocks, with every parameter's gradient."""
    _, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[f"lm_{arch}_loss"], r[f"lm_{arch}_ref_loss"], **TOL)
        names = [k[len(f"lm_{arch}_ref_g_"):] for k in r if k.startswith(f"lm_{arch}_ref_g_")]
        assert names
        for k in names:
            np.testing.assert_allclose(r[f"lm_{arch}_g_{k}"], r[f"lm_{arch}_ref_g_{k}"], **TOL,
                                       err_msg=k)
