"""Training launcher (PyTorch port of ``repro.launch.train``): config -> data
pipeline -> train step -> checkpoints.

    python -m repro_torch.launch.train [--arch llama3.2-1b] [--smoke] [--steps 100] \
        [--batch 8] [--seq 128] [--ckpt-dir DIR] [--device cpu]
    python -m repro_torch.launch.train --arch two-tower-retrieval --smoke --steps 60 \
        --batch 256
    python -m repro_torch.launch.train --arch dcn-v2 [--smoke] [--device cpu]

``train_lm`` trains an LM (dense or MoE) with AdamW under a warmup-cosine schedule on
synthetic token batches (``lm_batch_fn``: batch ``step`` drawn from
``numpy.random.default_rng((seed, step))``, since ``jax.random`` cannot be
replayed).  With a checkpoint directory it resumes (params, optimizer state)
and the data cursor from the latest checkpoint, so a killed run continues
where it stopped.  ``train_recsys`` trains a recsys model (two-tower, AutoInt,
DIN, DCN-v2).  The GNN and retrieval families have no launcher here, as in
``repro`` (``main`` exits naming ``examples/``).  Like ``repro``'s launcher it
takes no mesh: the on-mesh paths are library calls under
``sharding.api.use_mesh``.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_family, get_smoke_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import recsys_batch, tokens_from_uniforms
from repro_torch.models import recsys, transformer
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import lm_loss, make_train_step, recsys_loss

# repro's train_recsys: its default peak learning rate, warmup steps and batch key
PEAK_LR, WARMUP, BATCH_SEED = 1e-3, 10, 1
# repro's train_lm: its default peak learning rate and batch key
LM_PEAK_LR, LM_BATCH_SEED = 3e-4, 0


def lm_batch_fn(cfg, batch: int, seq: int, seed: int = LM_BATCH_SEED):
    """``make(step)`` -> {"tokens", "labels"} (batch, seq) int64 CPU tensors
    from the uniforms of ``default_rng((seed, step))`` (``tokens_from_uniforms``)."""
    def make(step: int):
        u = np.random.default_rng((seed, step)).random((batch, seq + 1), dtype=np.float32)
        return tokens_from_uniforms(u, cfg.vocab_size)

    return make


def lm_trainer(cfg, steps: int, block: int, device, peak_lr: float = LM_PEAK_LR):
    """``train_lm``'s model (seed 0), AdamW state and train step for a run of
    ``steps`` steps with attention blocks of ``block``."""
    model = transformer.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = adamw(warmup_cosine(peak_lr, max(steps // 20, 5), steps))
    step_fn = make_train_step(lambda m, b: lm_loss(m, b, cfg, block_q=block, block_kv=block),
                              opt)
    return model, opt.init(dict(model.named_parameters())), step_fn


def train_lm(cfg, *, steps: int = 200, batch: int = 8, seq: int = 128,
             ckpt_dir: Optional[str] = None, ckpt_every: int = 50, log_every: int = 10,
             peak_lr: float = LM_PEAK_LR, block: int = 64, device="cuda"):
    """Train an LM config for ``steps`` steps; returns (model, history).

    History: per logged step its ``loss``, ``grad_norm``, the MoE ``aux``
    (0 for a dense model), ``tok_s`` and ``s`` (seconds since the loop began, read after the loss's host copy, which
    waits for the step).  An exception from the batch source ends the run
    at that step, as a crash would; a rerun with the same ``ckpt_dir``
    resumes from the latest checkpoint.
    """
    dev = resolve_device(device)
    model, opt_state, step_fn = lm_trainer(cfg, steps, block, dev, peak_lr)

    start, mgr = 0, None
    if ckpt_dir:
        mgr = ckpt_lib.CheckpointManager(ckpt_dir, keep=2, every=ckpt_every)
        state, last = mgr.resume({"params": dict(model.named_parameters()), "opt": opt_state})
        if last >= 0:
            with torch.no_grad():
                for name, p in model.named_parameters():
                    p.copy_(state["params"][name])
            opt_state, start = state["opt"], last + 1
            print(f"resumed from step {last}")

    pipe = iter(DataPipeline(lm_batch_fn(cfg, batch, seq), start_step=start))
    history = []
    t0 = time.perf_counter()
    try:
        for _ in range(start, steps):
            step, b = next(pipe)
            b = {k: v.to(dev) for k, v in b.items()}
            model, opt_state, metrics = step_fn(model, opt_state, b)
            if step % log_every == 0 or step == steps - 1:
                loss = float(metrics["loss"])  # jaxlint: disable=JL003 (logged steps only)
                gnorm = float(metrics["grad_norm"])  # jaxlint: disable=JL003 (logged steps only)
                aux = float(metrics["aux"])  # jaxlint: disable=JL003 (logged steps only)
                s = time.perf_counter() - t0
                tok_s = batch * seq * (step - start + 1) / max(s, 1e-9)
                print(f"step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} tok/s {tok_s:,.0f}")
                history.append({"step": step, "loss": loss, "grad_norm": gnorm, "aux": aux,
                                "tok_s": tok_s, "s": s})
            if mgr:
                mgr.maybe_save(step, {"params": dict(model.named_parameters()),
                                      "opt": opt_state})
    finally:
        pipe.close()
    return model, history


def train_recsys(cfg, *, steps: int = 100, batch: int = 256, log_every: int = 10,
                 peak_lr: float = PEAK_LR, device="cuda"):
    """Train ``cfg``'s model; returns (model, history of {"step", "loss",
    "s"}), ``s`` the seconds since the loop began, read after the loss's host
    copy (which waits for the step).  AdamW updates the whole table densely
    every step, as ``repro``'s does."""
    dev = resolve_device(device)
    model = recsys.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = adamw(warmup_cosine(peak_lr, WARMUP, steps))
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(lambda m, b: recsys_loss(m, b, cfg), opt)

    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        b = recsys_batch(np.random.default_rng((BATCH_SEED, step)), batch, cfg.vocab_sizes, dev,
                         n_dense=cfg.n_dense, seq_len=cfg.seq_len)
        model, opt_state, metrics = step_fn(model, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])  # jaxlint: disable=JL003 (logged steps only)
            history.append({"step": step, "loss": loss, "s": time.perf_counter() - t0})
            print(f"step {step:4d} loss {loss:.4f} ({history[-1]['s']:.2f} s)")
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    family = get_family(args.arch)
    if family == "lm":
        _, history = train_lm(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                              ckpt_dir=args.ckpt_dir, device=args.device)
    elif family == "recsys":
        _, history = train_recsys(cfg, steps=args.steps, batch=args.batch, device=args.device)
    else:
        raise SystemExit(f"use examples/ for family {family}")
    return history


if __name__ == "__main__":
    main()
