"""Training launcher (PyTorch port of ``repro.launch.train``, recsys).

    python -m repro_torch.launch.train --arch two-tower-retrieval --smoke --steps 60 \
        --batch 256 [--device cpu]

``train_recsys`` trains the two-tower model with AdamW under a warmup-cosine
schedule on synthetic batches (``data.synthetic.recsys_batch``, batch
``step`` drawn from ``numpy.random.default_rng((BATCH_SEED, step))``).  The LM
and GNN families, checkpointing and the mesh wait for ROADMAP M17.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.synthetic import recsys_batch
from repro_torch.models import recsys
from repro_torch.train.optimizer import adamw, warmup_cosine
from repro_torch.train.train_step import make_train_step, recsys_loss

# repro's train_recsys: its peak learning rate, warmup steps and batch key
PEAK_LR, WARMUP, BATCH_SEED = 1e-3, 10, 1


def train_recsys(cfg, *, steps: int = 100, batch: int = 256, log_every: int = 10,
                 device="cuda"):
    """Train ``cfg``'s model; returns (model, history of {"step", "loss"})."""
    dev = resolve_device(device)
    model = recsys.init_params(cfg, torch.Generator().manual_seed(0), dev)
    opt = adamw(warmup_cosine(PEAK_LR, WARMUP, steps))
    opt_state = opt.init(dict(model.named_parameters()))
    step_fn = make_train_step(lambda m, b: recsys_loss(m, b, cfg), opt)

    history = []
    t0 = time.perf_counter()
    for step in range(steps):
        b = recsys_batch(np.random.default_rng((BATCH_SEED, step)), batch, cfg.vocab_sizes, dev)
        model, opt_state, metrics = step_fn(model, opt_state, b)
        if step % log_every == 0 or step == steps - 1:
            loss = float(metrics["loss"])  # jaxlint: disable=JL003 (logged steps only)
            history.append({"step": step, "loss": loss})
            print(f"step {step:4d} loss {history[-1]['loss']:.4f} "
                  f"({time.perf_counter() - t0:.2f} s)")
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="two-tower-retrieval")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    _, history = train_recsys(cfg, steps=args.steps, batch=args.batch, device=args.device)
    return history


if __name__ == "__main__":
    main()
