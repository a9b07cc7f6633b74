"""Open-loop arrivals at ``rate_qps`` with fixed exponential gaps.

The gaps are the same for every seed, the quantiles of the exponential law
at ``(i + 0.5) / N``, scaled so that the ``N = floor(rate_qps * seconds)``
requests take exactly ``seconds``; the seed only shuffles their order, so
that seeds differ in which request meets which queue, not in how much is
offered.  Not a Poisson process: the gaps are its quantiles, not its draws.
"""

from __future__ import annotations

import math

import numpy as np


def times(mix: dict, seconds: float, rng: np.random.Generator) -> np.ndarray:
    n = max(int(math.floor(float(mix["rate_qps"]) * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= seconds / gaps.sum()
    gaps = rng.permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
