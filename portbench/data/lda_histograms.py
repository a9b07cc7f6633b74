"""LDA-like topic histograms: a frozen copy of the semantics of
``lda_like_histograms`` and ``split_queries`` (``repro_torch.data.synthetic``),
kept here so that the yardstick does not move with the program:

* each row is a draw of Dirichlet(alpha, ..., alpha) over d topics, in
  float32, floored at ``EPS`` and renormalised;
* a random split of n + queries i.i.d. rows into the held-out query pool and
  the indexable rows.

The program draws with numpy on the host and copies the rows to the card.
Here the draw is made on the device with a ``torch.Generator``, in a few
large calls: a Dirichlet row is a row of independent Gamma(alpha, 1) draws
divided by its sum, so the distribution is the same.  Only rounding differs:
float32 Gamma draws below about 1e-38 underflow to 0 where numpy's float64
ones do not, and every such entry lies far below the 1e-6 floor that both
apply, so the floored histograms follow the same law.

Reads ``n``, ``queries``, ``d`` and ``alpha`` of the configuration.
"""

from __future__ import annotations

import torch

EPS = 1e-6  # the histogram floor of the paper's setup and of the program


def lda_like_histograms(gen: torch.Generator, n: int, d: int, alpha: float,
                        device) -> torch.Tensor:
    """(n, d) float32 Dirichlet(alpha) rows, floored at EPS and renormalised."""
    g = torch._standard_gamma(torch.full((n, d), float(alpha), dtype=torch.float32,
                                         device=device), generator=gen)
    g /= g.sum(dim=1, keepdim=True).clamp_min(torch.finfo(torch.float32).tiny)
    g.clamp_(min=EPS)
    g /= g.sum(dim=1, keepdim=True)
    return g


def make(cfg: dict, gen: torch.Generator, device) -> tuple[torch.Tensor, torch.Tensor]:
    n, q = int(cfg["n"]), int(cfg["queries"])
    rows = lda_like_histograms(gen, n + q, int(cfg["d"]), float(cfg["alpha"]), device)
    perm = torch.randperm(n + q, generator=gen, device=device)
    pool = rows[perm[:q]].contiguous()
    X = rows[perm[q:]].contiguous()
    return X, pool
