"""The 40 assigned (architecture x input-shape) dry-run cells (PyTorch port
of ``repro.launch.cells``).

Each cell builds, for ONE rank of a mesh (the local view of
``sharding/api.py``):
  * the step callable (train step / prefill / decode / serve / retrieval),
  * this rank's local inputs on the device asked for (``meta`` for counting,
    ``cuda`` to execute): parameters as their blocks under ``repro``'s
    specs, optimizer state, the batch block and the cache block,
  * ``repro``'s analytic fields: MODEL_FLOPS (6 N D / 6 N_active D for LMs,
    op counts elsewhere), the analytic FLOPs and HBM bytes, tokens, the
    optimizer, the accumulation steps, the global parameter (+ state)
    bytes, ``repro``'s loop hints, and the KV, serving-mode and embedding
    gather fields where ``repro`` has them.

``repro`` builds abstract global arrays and lets GSPMD partition them; here
the rank runs its part in the local view:
  * the LMs hold FSDP x TP blocks (``transformer.param_specs``; serving:
    ``_serving_param_specs``), run their batch block, and decode over their
    block of a sequence-sharded cache;
  * the GCN's full-batch and sampled cells split the edge list over the data
    axes (``edge_sharded``); the molecule cell's batch block holds whole
    graphs (their node ids local to it), the weights used data-parallel;
  * the recsys models' lookup takes replicated ids as ``repro``'s region
    does, so the batch is all-gathered over the data axes and the lookup
    returns its rows (blocked over "data" when the batch splits over the
    table's 256 row shards, all of them otherwise); the dense layers run
    data-parallel over those rows.  The two-tower ``retrieval_cand`` cell
    scores one query against this rank's block of 1,000,448 candidate rows
    through ``sharded_knn_scan`` (``distance_matrix`` on the card).

Skips (mandated): ``long_500k`` needs sub-quadratic attention => skipped for
pure full-attention archs (yi-34b, llama3.2-1b, phi3.5-moe, kimi-k2) and run
for gemma3-12b (5:1 sliding-window pattern).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config, get_family, get_module
from repro_torch.configs.base import GNNConfig, LMConfig, RecsysConfig
from repro_torch.sharding.api import (P, all_gather, flatten, local_shape, pmean, pvary,
                                      use_mesh)


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str  # train | prefill | decode | serve | retrieval
    skip_reason: Optional[str] = None
    note: str = ""

    @property
    def cell_id(self) -> str:
        return f"{self.arch}::{self.shape}"


LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
GNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
RECSYS_SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]

_LM_KIND = {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode"}


def list_cells() -> List[Cell]:
    cells = []
    for arch in ARCH_IDS:
        fam = get_family(arch)
        if fam == "lm":
            cfg = get_config(arch)
            for s in LM_SHAPES:
                skip = None
                if s == "long_500k" and cfg.full_attention:
                    skip = ("pure full-attention arch: long_500k requires "
                            "sub-quadratic attention (DESIGN.md SS5)")
                cells.append(Cell(arch, s, _LM_KIND[s], skip_reason=skip))
        elif fam == "gnn":
            for s in GNN_SHAPES:
                cells.append(Cell(arch, s, "train"))
        elif fam == "recsys":
            for s in RECSYS_SHAPES:
                kind = ("train" if s == "train_batch"
                        else "retrieval" if s == "retrieval_cand" else "serve")
                cells.append(Cell(arch, s, kind))
    return cells


# ---------------------------------------------------------------------------
# local inputs
# ---------------------------------------------------------------------------


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _fill(shape, dtype, device, *, high: Optional[int] = None, value=None):
    """A local input: empty on the meta device; else N(0, 0.02) floats,
    integers uniform in [0, ``high``), or the constant ``value``."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if value is not None:
        return torch.full(shape, value, dtype=dtype, device=device)
    if high is not None:
        return torch.randint(0, high, shape, dtype=dtype, device=device)
    return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02)


def _block_rows(n: int, axes, mesh) -> int:
    return n // mesh.size_of(axes)


def _bytes(shapes) -> int:
    """Global bytes of {name: (shape, dtype)}."""
    return sum(math.prod(s) * torch.empty((), dtype=dt).element_size() for s, dt in shapes)


def _adamw_state_bytes(n_elements: int) -> int:
    return 4 + 2 * 4 * n_elements  # the int32 step, mu and nu in float32


def _adafactor_state_bytes(shapes, min_dim_factored: int = 128) -> int:
    total = 4
    for s, _ in shapes:
        if len(s) >= 2 and min(s[-1], s[-2]) >= min_dim_factored:
            total += 4 * (math.prod(s[:-1]) + math.prod(s[:-2]) * s[-1])
        else:
            total += 4 * math.prod(s)
    return total


class _Bound(nn.Module):
    """``fn(model, *args)`` as a module call, so ``torch.func.functional_call``
    can hand ``fn`` the model with some parameters replaced."""

    def __init__(self, fn, model):
        super().__init__()
        self.fn, self.model = fn, model

    def forward(self, *args):
        return self.fn(self.model, *args)


def _data_parallel(fn, model, axes, mesh, keep=(), *args):
    """``fn(model, *args)`` with every parameter not in ``keep`` ``pvary``ed
    over ``axes``: whole weights used on this rank's rows, so their
    gradients sum over the data blocks."""
    if not axes:
        return fn(model, *args)
    params = {f"model.{k}": pvary(p, axes, mesh) for k, p in model.named_parameters()
              if k not in keep}
    return torch.func.functional_call(_Bound(fn, model), params, args)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_params(cfg: LMConfig, specs, mesh, device):
    """This rank's FSDP x TP blocks of ``cfg``'s parameters (norms 1)."""
    from repro_torch.models import transformer

    flat = flatten(specs)
    blocks = {}
    for name, (shape, dt) in transformer.param_shapes(cfg).items():
        norm = name in ("ln_f", "layers.ln_attn", "layers.ln_mlp")
        blocks[name] = _fill(local_shape(shape, flat[name], mesh), dt, device,
                             value=1.0 if norm else None)
    layers = {k[7:]: v for k, v in blocks.items() if k.startswith("layers.")}
    return transformer.LMParams(blocks["embed"], blocks["ln_f"], layers, blocks.get("lm_head"),
                                specs=specs)


def _lm_param_bytes(cfg: LMConfig) -> int:
    from repro_torch.models import transformer

    return _bytes(transformer.param_shapes(cfg).values())


def _lm_train_cell(arch: str, mesh, seq: int, global_batch: int, device):
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import adafactor, adamw, warmup_cosine
    from repro_torch.train.train_step import lm_loss, make_train_step

    cfg: LMConfig = get_config(arch)
    dp = dp_axes(mesh)
    # FSDP over ALL data-parallel axes (incl. "pod"): 1T-param states must
    # shard across the full 512 cards on the multi-pod mesh
    pspecs = transformer.param_specs(cfg, fsdp_axis=dp)
    model = _lm_params(cfg, pspecs, mesh, device)
    shapes = list(transformer.param_shapes(cfg).values())

    lr = warmup_cosine(3e-4, 2000, 100_000)
    if cfg.is_moe and cfg.n_params() > 2e11:
        opt = adafactor(lr, specs=pspecs)
        o_bytes = _adafactor_state_bytes(shapes)
        opt_name = "adafactor"
    else:
        opt = adamw(lr)
        o_bytes = _adamw_state_bytes(sum(math.prod(s) for s, _ in shapes))
        opt_name = "adamw"
    with use_mesh(mesh):
        opt_state = opt.init(dict(model.named_parameters()))

    rows = _block_rows(global_batch, dp, mesh)
    batch = {"tokens": _fill((rows, seq), torch.int32, device, high=cfg.vocab_size),
             "labels": _fill((rows, seq), torch.int32, device, high=cfg.vocab_size)}
    # gradient accumulation bounds live activations: microbatch so that
    # tokens/device/microbatch ~ 4k
    dp_size = mesh.size_of(dp)
    tok_per_dev = global_batch * seq // dp_size
    target = 4096 if cfg.d_model >= 3000 else 16384
    accum = 1
    while (tok_per_dev // accum > target and accum < 64
           and global_batch % (accum * 2) == 0
           and (global_batch // (accum * 2)) % dp_size == 0):
        accum *= 2

    loss = functools.partial(lm_loss, cfg=cfg, block_q=512, block_kv=512)
    # bf16 grad accumulation for >=100B-param models, as repro
    accum_dtype = torch.bfloat16 if cfg.n_params() > 1e11 else torch.float32
    step = make_train_step(lambda m, b: loss(m, b), opt, accum_steps=accum,
                           accum_dtype=accum_dtype)

    N = global_batch * seq
    model_flops = 6.0 * N * cfg.n_active_params()
    attn_flops = 12.0 * N * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * 0.5
    p_bytes = _lm_param_bytes(cfg)
    # HBM traffic model (repro's): params read fwd + read bwd + grads
    # write/read + update write (4x), opt states read+write (2x), remat-saved
    # carries + recompute streams (~8 tensor passes of (B,T,d) per layer),
    # logits fwd+bwd (~6 passes)
    act = 8.0 * cfg.n_layers * N * cfg.d_model * 2
    logits_traffic = 6.0 * N * cfg.vocab_size * 2
    analytic_bytes = 4.0 * p_bytes + 2.0 * o_bytes + act + logits_traffic
    if cfg.is_moe:
        m = cfg.moe
        analytic_bytes += 4.0 * cfg.n_layers * N * m.top_k * cfg.d_model * 2
    return {
        "fn": step,
        "args": (model, opt_state, batch),
        "carry": lambda out, args: (out[0], out[1], args[2]),
        "loop_hints": ([accum] if accum > 1 else []) + [cfg.n_layers],
        "model_flops": model_flops,
        "analytic_flops": model_flops + attn_flops,
        "analytic_bytes": analytic_bytes,
        "tokens": N,
        "opt": opt_name,
        "accum_steps": accum,
        "param_bytes": p_bytes + o_bytes,
    }


def _serving_param_specs(cfg: LMConfig, mesh):
    """Serving mode: FSDP+TP by default; REPRO_SERVE_MODE=tp gives TP-only
    sharding when the bf16 params fit per device (repro's threshold, 6 GiB)
    - repro's ablation B1, which refuted the tp-only default."""
    from repro_torch.models import transformer

    override = os.environ.get("REPRO_SERVE_MODE")
    tp = mesh.shape["model"]
    per_dev = cfg.n_params() * 2 / tp
    if override == "tp" and per_dev <= 6 * 2**30:
        return transformer.param_specs(cfg, fsdp_axis=None), "tp-only"
    dp = dp_axes(mesh)
    return transformer.param_specs(cfg, fsdp_axis=dp), "fsdp+tp"


def _lm_prefill_cell(arch: str, mesh, seq: int, batch: int, device):
    from repro_torch.models import transformer

    cfg: LMConfig = get_config(arch)
    dp = dp_axes(mesh)
    pspecs, serve_mode = _serving_param_specs(cfg, mesh)
    params = _lm_params(cfg, pspecs, mesh, device)
    tokens = _fill((_block_rows(batch, dp, mesh), seq), torch.int32, device,
                   high=cfg.vocab_size)

    def fn(params, tokens):
        return transformer.prefill(params, tokens, cfg, block_q=512, block_kv=512)

    N = batch * seq
    model_flops = 2.0 * N * cfg.n_active_params()
    attn = 4.0 * N * cfg.n_layers * cfg.n_heads * cfg.d_head * seq * 0.5
    p_bytes = _lm_param_bytes(cfg)
    kv_bytes = 2.0 * cfg.n_layers * N * cfg.n_kv_heads * cfg.d_head * 2
    act = 4.0 * cfg.n_layers * N * cfg.d_model * 2
    return {
        "fn": fn,
        "args": (params, tokens),
        "loop_hints": [cfg.n_layers],
        "model_flops": model_flops,
        "analytic_flops": model_flops + attn,
        "analytic_bytes": p_bytes + kv_bytes + act,
        "tokens": N,
        "serve_params": serve_mode,
        "param_bytes": p_bytes,
    }


def _lm_decode_cell(arch: str, mesh, cache_len: int, batch: int, device):
    from repro_torch.models import transformer

    cfg: LMConfig = get_config(arch)
    dp = dp_axes(mesh)
    # batch=1 (long_500k): batch unshardable -> widen seq sharding to
    # ("data", "model") and replicate the batch dim
    if batch % mesh.size_of(dp) != 0 or batch == 1:
        dp = ()
        seq_axes = ("data", "model")
    else:
        seq_axes = ("model",)
    pspecs, serve_mode = _serving_param_specs(cfg, mesh)
    params = _lm_params(cfg, pspecs, mesh, device)
    rows = _block_rows(batch, dp, mesh)
    kv = (cfg.n_layers, rows, cache_len // mesh.size_of(seq_axes), cfg.n_kv_heads,
          cfg.d_head)
    dt = getattr(torch, cfg.dtype)
    # a full cache: the step's token goes to the last position
    cache = {"k": _fill(kv, dt, device), "v": _fill(kv, dt, device),
             "length": _fill((rows,), torch.int32, device, value=cache_len - 1)}
    tokens = _fill((rows,), torch.int32, device, high=cfg.vocab_size)

    def fn(params, cache, tokens):
        return transformer.decode_step(params, cache, tokens, cfg, mesh=mesh,
                                       seq_axes=seq_axes, dp=dp)

    N = batch  # one token per sequence
    model_flops = 2.0 * N * cfg.n_active_params()
    attn = 4.0 * N * cfg.n_layers * cfg.n_heads * cfg.d_head * cache_len
    kv_bytes = (2 * cfg.n_layers * batch * cache_len * cfg.n_kv_heads
                * cfg.d_head * 2)
    p_read = _active_param_bytes(cfg, batch)
    return {
        "fn": fn,
        "args": (params, cache, tokens),
        "carry": lambda out, args: (args[0], out[1], args[2]),
        "loop_hints": [cfg.n_layers],
        "model_flops": model_flops,
        "analytic_flops": model_flops + attn,
        # decode HBM traffic: read active params once + read the whole KV
        # cache once (+ small writes) - the classic decode memory wall
        "analytic_bytes": p_read + kv_bytes,
        "tokens": N,
        "serve_params": serve_mode,
        "param_bytes": _lm_param_bytes(cfg),
        "kv_bytes": kv_bytes,
    }


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_SHAPE_DEFS = {
    # n_nodes, n_edges, d_feat, n_classes
    "full_graph_sm": dict(n_nodes=2_708, n_edges=10_556, d_feat=1_433, n_classes=7),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892, d_feat=602,
                         n_classes=41, batch_nodes=1_024, fanouts=(15, 10)),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         n_classes=47),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2),
}


def _gnn_cell(arch: str, mesh, shape: str, device):
    from repro_torch.models import gnn
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import gnn_loss, make_train_step

    mod = get_module(arch)
    sdef = GNN_SHAPE_DEFS[shape]
    cfg: GNNConfig = mod.with_shape(sdef["d_feat"], sdef["n_classes"])
    dp = dp_axes(mesh)
    params = gnn.init_params(cfg, device="cpu").to(device)
    opt = adamw(warmup_cosine(1e-2, 100, 10_000))
    opt_state = opt.init(dict(params.named_parameters()))
    n_w = sum(p.numel() for p in params.parameters())
    i32, f32 = torch.int32, torch.float32

    if shape == "molecule":
        # this rank's block of whole graphs, node ids local to the block
        n_total = sdef["n_nodes"] * sdef["batch"]
        e_total = sdef["n_edges"] * sdef["batch"]
        n_loc = _block_rows(n_total, dp, mesh)
        batch = {
            "features": _fill((n_loc, cfg.d_feat), f32, device),
            "senders": _fill((_block_rows(e_total, dp, mesh),), i32, device, high=n_loc),
            "receivers": _fill((_block_rows(e_total, dp, mesh),), i32, device, high=n_loc),
            "graph_ids": (torch.arange(n_loc, device=device) // sdef["n_nodes"]).to(i32),
            "graph_labels": _fill((_block_rows(sdef["batch"], dp, mesh),), i32, device,
                                  high=cfg.n_classes),
        }

        def loss(p, b):
            l, _ = _data_parallel(functools.partial(gnn.graph_classify_loss, cfg=cfg), p, dp,
                                  mesh, (), b)
            l = pmean(l, dp, mesh)
            return l, {"nll": l.detach()}

        flops_fwd = _gcn_flops(cfg, n_total, e_total)
    elif shape == "minibatch_lg":
        b, fan = sdef["batch_nodes"], sdef["fanouts"]
        e1 = b * fan[0]
        e2 = e1 * fan[1]
        n_sub = b + e1 + e2
        n = sdef["n_nodes"]
        batch = {
            # full feature/label tables stay resident (they are the "graph")
            "features": _fill((n, cfg.d_feat), f32, device),
            "labels": _fill((n,), i32, device, high=cfg.n_classes),
            "nodes": _fill((n_sub,), i32, device, high=n),
            "senders": _fill((_block_rows(e1 + e2, dp, mesh),), i32, device, high=n),
            "receivers": _fill((_block_rows(e1 + e2, dp, mesh),), i32, device, high=n),
        }

        def loss(p, b_):
            l, _ = gnn.sampled_forward(
                p, b_["features"], b_["labels"],
                {"nodes": b_["nodes"], "senders": b_["senders"],
                 "receivers": b_["receivers"]},
                cfg, n_seed=sdef["batch_nodes"], edge_sharded=True)
            return l, {"nll": l.detach()}

        flops_fwd = _gcn_flops(cfg, sdef["n_nodes"], e1 + e2)
    else:  # full-batch node classification
        # the edge list padded to the DP-shard multiple (as repro's cell),
        # then the self loops appended; this rank's slice of it
        n = sdef["n_nodes"]
        dp_size = mesh.size_of(dp)
        e_pad = -(-sdef["n_edges"] // dp_size) * dp_size
        e_loc = -(-(e_pad + n) // dp_size)
        batch = {
            "features": _fill((n, cfg.d_feat), f32, device),
            "senders": _fill((e_loc,), i32, device, high=n),
            "receivers": _fill((e_loc,), i32, device, high=n),
            "labels": _fill((n,), i32, device, high=cfg.n_classes),
        }

        def loss(p, b):
            return gnn_loss(p, b, cfg, edge_sharded=True)

        flops_fwd = _gcn_flops(cfg, sdef["n_nodes"], sdef["n_edges"])

    step = make_train_step(loss, opt)
    # GCN HBM traffic: message gather + scatter per layer per pass (x3 for
    # fwd+bwd), plus node features; params are negligible (kB-scale)
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    n_eff = sdef["n_nodes"] * sdef.get("batch", 1)
    e_eff = sdef["n_edges"] * sdef.get("batch", 1)
    if shape == "minibatch_lg":
        e_eff = sdef["batch_nodes"] * sdef["fanouts"][0] * (1 + sdef["fanouts"][1])
    abytes = sum(3.0 * (2 * e_eff * dims[i] + 2 * n_eff * dims[i]) * 4
                 for i in range(cfg.n_layers))
    return {
        "fn": step,
        "args": (params, opt_state, batch),
        "carry": lambda out, args: (out[0], out[1], args[2]),
        "loop_hints": [],
        "model_flops": 3.0 * flops_fwd,  # fwd + ~2x bwd
        "analytic_flops": 3.0 * flops_fwd,
        "analytic_bytes": abytes,
        "tokens": sdef.get("batch_nodes", sdef["n_nodes"]),
        "param_bytes": 4 * n_w + _adamw_state_bytes(n_w),
    }


def _gcn_flops(cfg: GNNConfig, n_nodes: int, n_edges: int) -> float:
    dims = [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    f = 0.0
    for i in range(cfg.n_layers):
        f += 2.0 * n_edges * dims[i]  # SpMM (gather+scatter-add)
        f += 2.0 * n_nodes * dims[i] * dims[i + 1]  # dense
    return f


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

RECSYS_SHAPE_DEFS = {
    "train_batch": dict(batch=65_536),
    "serve_p99": dict(batch=512),
    "serve_bulk": dict(batch=262_144),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000),
}


def _recsys_model(cfg: RecsysConfig, mesh, device):
    """The model with this rank's row block of the padded table and the whole
    dense layers (drawn at a one-row-per-field stand-in of the table, whose
    dense shapes are the same), carrying its flat ``specs``."""
    from repro_torch.models import recsys
    from repro_torch.models.embedding import field_offsets

    stand_in = dataclasses.replace(cfg, vocab_sizes=(1,) * cfg.n_sparse)
    model = recsys.init_params(stand_in, device="cpu").to(device)
    specs = flatten(recsys.param_specs(cfg))
    rows = recsys._pad_vocab(cfg)
    model.table = nn.Parameter(_fill(local_shape((rows, cfg.embed_dim), specs["table"], mesh),
                                     torch.float32, device))
    model.offsets = field_offsets(cfg.vocab_sizes, device)
    model.specs = specs
    return model


def _recsys_batch(cfg: RecsysConfig, mesh, batch: int, with_label: bool, device):
    """This rank's block of the batch over the data axes (the whole batch
    when it does not split: the retrieval query row)."""
    dp = dp_axes(mesh)
    if batch % mesh.size_of(dp) != 0:
        dp = ()
    rows = _block_rows(batch, dp, mesh)
    i32, f32 = torch.int32, torch.float32
    ids = torch.stack([_fill((rows,), i32, device, high=v) for v in cfg.vocab_sizes], 1) \
        if device.type != "meta" else _fill((rows, cfg.n_sparse), i32, device)
    out = {"sparse_ids": ids}
    if cfg.n_dense:
        out["dense"] = _fill((rows, cfg.n_dense), f32, device)
    if cfg.seq_len:
        out["history"] = _fill((rows, cfg.seq_len), i32, device, high=cfg.vocab_sizes[0])
        out["hist_len"] = _fill((rows,), i32, device, high=cfg.seq_len)
    if with_label:
        out["label"] = _fill((rows,), f32, device, high=2)
    return out, dp


def _lookup_rows(batch: dict, mesh, dp):
    """``repro``'s lookup region takes replicated ids: the batch all-gathered
    over ``dp``, the ids whole and the other fields cut to the rows the
    lookup returns (blocked over "data" when the batch splits over the
    table's row shards, else all), and the axes those rows vary over."""
    from repro_torch.sharding.api import _block

    full = {k: all_gather(v, dp, 0, tiled=True, mesh=mesh) for k, v in batch.items()} \
        if dp else dict(batch)
    B = full["sparse_ids"].shape[0]
    n_row_shards = mesh.size_of(("model", "data"))
    if not (B % n_row_shards == 0 and B >= n_row_shards):
        return full, ()
    rows = {k: v if k in ("sparse_ids", "history") else _block(v, ("data",), 0, mesh)
            for k, v in full.items()}
    return rows, ("data",)


def _recsys_forward(model, batch, cfg: RecsysConfig, mesh, dp):
    """(the lookup's rows' logits, or the two towers' embeddings; their axes)."""
    from repro_torch.models import recsys

    rows, axes = _lookup_rows(batch, mesh, dp)
    fn = recsys.tower_embeddings if cfg.interaction == "dot" else recsys.forward
    return _data_parallel(functools.partial(fn, cfg=cfg), model, axes, mesh, ("table",),
                          rows), rows, axes


def _recsys_loss(model, batch, cfg: RecsysConfig, mesh, dp):
    """``recsys_loss`` over the lookup's rows, the mean over the global batch:
    the two-tower in-batch softmax against every item of the batch (its
    items all-gathered), the binary cross-entropy otherwise."""
    out, rows, axes = _recsys_forward(model, batch, cfg, mesh, dp)
    if cfg.interaction == "dot":
        u, it = out
        it_all = all_gather(it, axes, 0, tiled=True, varying=True, mesh=mesh) if axes else it
        logp = torch.log_softmax((u @ it_all.T) / 0.05, dim=-1)
        n = u.shape[0]
        pos = (mesh.index(axes) if axes else 0) * n + torch.arange(n, device=u.device)
        loss = -torch.mean(logp[torch.arange(n, device=u.device), pos])
    else:
        y = rows["label"]
        loss = torch.mean(torch.maximum(out, torch.zeros_like(out)) - out * y
                          + torch.log1p(torch.exp(-torch.abs(out))))
    loss = pmean(loss, axes, mesh) if axes else loss
    return loss, {"nll": loss.detach()}


def _recsys_flops(cfg: RecsysConfig, batch: int) -> float:
    d = cfg.embed_dim
    f = 0.0
    if cfg.interaction == "self-attn":
        F = cfg.n_sparse
        da = cfg.d_attn
        for i in range(cfg.n_attn_layers):
            d_in = d if i == 0 else da
            f += 2.0 * batch * F * d_in * da * 4  # q,k,v,res projections
            f += 2.0 * batch * F * F * da * 2  # scores + weighted sum
        f += 2.0 * batch * (F * da)
    elif cfg.interaction == "target-attn":
        T = cfg.seq_len
        dims = (4 * d,) + tuple(cfg.attn_mlp_dims) + (1,)
        per_tok = sum(2.0 * dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        f += batch * T * per_tok
        mdims = (2 * d + (cfg.n_sparse - 1) * d + cfg.n_dense,) + tuple(cfg.mlp_dims) + (1,)
        f += batch * sum(2.0 * mdims[i] * mdims[i + 1] for i in range(len(mdims) - 1))
    elif cfg.interaction == "cross":
        x0 = cfg.n_dense + cfg.n_sparse * d
        f += 2.0 * batch * x0 * x0 * cfg.n_cross_layers
        mdims = (x0,) + tuple(cfg.mlp_dims) + (1,)
        f += batch * sum(2.0 * mdims[i] * mdims[i + 1] for i in range(len(mdims) - 1))
    elif cfg.interaction == "dot":
        fu = cfg.n_sparse // 2
        for dims, nf in ((cfg.tower_mlp_dims, fu), (cfg.tower_mlp_dims, cfg.n_sparse - fu)):
            full = (nf * d,) + tuple(dims)
            f += batch * sum(2.0 * full[i] * full[i + 1] for i in range(len(full) - 1))
    # embedding gather bytes dominate; flops negligible but count the reduce
    f += 2.0 * batch * cfg.n_sparse * d
    return f


def _recsys_cell(arch: str, mesh, shape: str, device):
    from repro_torch.core.distances import neg_inner_product
    from repro_torch.core.distributed import sharded_knn_scan
    from repro_torch.models import recsys
    from repro_torch.train.optimizer import adamw, warmup_cosine
    from repro_torch.train.train_step import make_train_step

    cfg: RecsysConfig = get_config(arch)
    sdef = RECSYS_SHAPE_DEFS[shape]
    model = _recsys_model(cfg, mesh, device)
    dense_n = sum(p.numel() for k, p in model.named_parameters() if k != "table")
    table_bytes = recsys._pad_vocab(cfg) * cfg.embed_dim * 4
    dense_p_bytes = 4 * dense_n
    p_bytes = table_bytes + dense_p_bytes
    n_params = recsys._pad_vocab(cfg) * cfg.embed_dim + dense_n
    gather_b = lambda b: 3.0 * b * (cfg.n_sparse + cfg.seq_len) * cfg.embed_dim * 4  # noqa: E731

    if shape == "train_batch":
        batch_n = sdef["batch"]
        opt = adamw(warmup_cosine(1e-3, 1000, 300_000))
        with use_mesh(mesh):
            opt_state = opt.init(dict(model.named_parameters()))
        batch, dp = _recsys_batch(cfg, mesh, batch_n, True, device)
        step = make_train_step(lambda m, b: _recsys_loss(m, b, cfg, mesh, dp), opt)
        # NOTE (repro's): AdamW applies DENSE updates to the embedding table
        o_bytes = _adamw_state_bytes(n_params)
        abytes = (8.0 * p_bytes + 2.0 * o_bytes
                  + gather_b(batch_n) + 6.0 * batch_n * cfg.embed_dim * cfg.n_sparse * 4)
        return {
            "fn": step,
            "args": (model, opt_state, batch),
            "carry": lambda out, args: (out[0], out[1], args[2]),
            "loop_hints": [],
            "model_flops": 3.0 * _recsys_flops(cfg, batch_n),
            "analytic_flops": 3.0 * _recsys_flops(cfg, batch_n),
            "analytic_bytes": abytes,
            "tokens": batch_n,
            "param_bytes": p_bytes + o_bytes,
            "embed_gather_bytes": gather_b(batch_n),
        }

    if shape in ("serve_p99", "serve_bulk"):
        batch_n = sdef["batch"]
        batch, dp = _recsys_batch(cfg, mesh, batch_n, False, device)

        @torch.no_grad()
        def fn(model, batch_):
            out, _, _ = _recsys_forward(model, batch_, cfg, mesh, dp)
            if cfg.interaction == "dot":
                return torch.sum(out[0] * out[1], dim=-1)
            return out

        return {
            "fn": fn,
            "args": (model, batch),
            "loop_hints": [],
            "model_flops": _recsys_flops(cfg, batch_n),
            "analytic_flops": _recsys_flops(cfg, batch_n),
            "analytic_bytes": (dense_p_bytes + gather_b(batch_n) / 3.0
                               + 2.0 * batch_n * cfg.embed_dim * cfg.n_sparse * 4),
            "tokens": batch_n,
            "param_bytes": p_bytes,
            "embed_gather_bytes": batch_n * cfg.n_sparse * cfg.embed_dim * 4,
        }

    # retrieval_cand
    nc = sdef["n_candidates"]
    if cfg.interaction == "dot":
        # the paper-integrated path: 1 user-tower query vs 10^6 candidate
        # embeddings, per-shard local top-k + one all-gather merge
        # (sharded_knn_scan) instead of gathering full score rows
        d_emb = cfg.tower_mlp_dims[-1]
        batch, dp = _recsys_batch(cfg, mesh, 1, False, device)
        # a shard-divisible corpus (pad rows carry +inf sentinel scores in
        # the real serving path, as repro's)
        nc_pad = -(-nc // 512) * 512
        cands = _fill((nc_pad // mesh.size, d_emb), torch.float32, device)

        @torch.no_grad()
        def fn(model, batch_, candidates):
            (u, _), _, _ = _recsys_forward(model, batch_, cfg, mesh, dp)
            return sharded_knn_scan(neg_inner_product(), u, candidates, 100, nc_pad,
                                    group=mesh.group)

        flops = 2.0 * nc * d_emb
        args = (model, batch, cands)
    else:
        # ranking models bulk-score 10^6 candidate rows (user fields tiled)
        batch, dp = _recsys_batch(cfg, mesh, nc, False, device)

        @torch.no_grad()
        def fn(model, batch_):
            scores, _, _ = _recsys_forward(model, batch_, cfg, mesh, dp)
            top, ids = torch.topk(scores, 100)
            return top, ids

        flops = _recsys_flops(cfg, nc)
        args = (model, batch)

    cand_bytes = (nc * cfg.tower_mlp_dims[-1] * 4 if cfg.interaction == "dot"
                  else gather_b(nc) / 3.0 + dense_p_bytes)
    return {
        "fn": fn,
        "args": args,
        "loop_hints": [],
        "model_flops": flops,
        "analytic_flops": flops,
        "analytic_bytes": cand_bytes,
        "tokens": nc,
        "param_bytes": p_bytes,
    }


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

LM_SHAPE_DEFS = {
    "train_4k": dict(seq=4_096, global_batch=256),
    "prefill_32k": dict(seq=32_768, batch=32),
    "decode_32k": dict(cache=32_768, batch=128),
    "long_500k": dict(cache=524_288, batch=1),
}


def build_cell(cell: Cell, mesh, device="cuda") -> Dict[str, Any]:
    """The cell for this rank of ``mesh``: ``fn``, its local ``args`` on
    ``device`` (``meta`` builds shapes only), ``carry`` (the next call's args
    from a call's output, for a step that consumes its state) and
    ``repro``'s analytic fields (module docstring)."""
    if cell.skip_reason:
        raise ValueError(f"cell {cell.cell_id} is skipped: {cell.skip_reason}")
    dev = resolve_device(device)
    fam = get_family(cell.arch)
    if fam == "lm":
        d = LM_SHAPE_DEFS[cell.shape]
        if cell.kind == "train":
            return _lm_train_cell(cell.arch, mesh, d["seq"], d["global_batch"], dev)
        if cell.kind == "prefill":
            return _lm_prefill_cell(cell.arch, mesh, d["seq"], d["batch"], dev)
        return _lm_decode_cell(cell.arch, mesh, d["cache"], d["batch"], dev)
    if fam == "gnn":
        return _gnn_cell(cell.arch, mesh, cell.shape, dev)
    return _recsys_cell(cell.arch, mesh, cell.shape, dev)


def _active_param_bytes(cfg: LMConfig, batch: int) -> float:
    """Per-decode-step parameter bytes read: dense params fully, MoE expert
    weights scaled by the expected per-step expert coverage."""
    total = cfg.n_params() * 2.0  # bf16
    if not cfg.is_moe:
        return total
    m = cfg.moe
    expert_part = 3.0 * cfg.d_model * m.d_ff_expert * m.n_experts * cfg.n_layers * 2.0
    frac = min(1.0, batch * m.top_k / m.n_experts)
    return total - expert_part + expert_part * frac
