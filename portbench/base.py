"""What every entry shares: the run's record, set-up's clock, the window's
opening, the program's spec and index, and the judge of a search's answers.

An entry (``entries/<name>.py``, named by a traffic mix's ``"entry"``)
defines ``run(cfg, mix, seed, seconds, trace, device, limits) -> Run`` and
``control(cfg, limits, seed, device) -> checks``, the reference put in the
program's place one precision lower (``control.py``).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Optional

import torch

from portbench import judge as J
from portbench import reference
from portbench.data import make_data
from portbench.trace import Trace


@dataclasses.dataclass
class Run:
    setup: dict  # seconds of each part of set-up
    metrics: dict  # end-to-end name -> value
    attempted: int
    counters: dict  # what the per-layer readers take
    notes: dict  # printed on an earlier line
    judge: Callable[[], dict]
    t_window: float  # ``time.perf_counter()`` when the window opened
    trace: Optional[Trace] = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Clock:
    """Seconds of each part of set-up, each ended by a device sync."""

    def __init__(self, device):
        self.device, self.parts, self._t = device, {}, time.perf_counter()

    def lap(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self._t
        self._t = now


def open_window() -> float:
    """Collect, then freeze what set-up made (``gc.freeze``), as a long-running
    Python server does after start-up: a collection inside the window then
    scans only what the window makes (the program's stream driver keeps
    every result until the stream ends; unfrozen, a collection over them and
    the set-up's objects stalled the host up to 0.24 s, a tail of its own).
    Returns the window's start, ``time.perf_counter()``."""
    gc.collect()
    gc.freeze()
    return time.perf_counter()


def spec_of(cfg: dict):
    """The program's ``RetrievalSpec`` of the configuration's ``spec``."""
    from repro_torch.core.spec import RetrievalSpec

    return RetrievalSpec(**cfg["spec"])


def reference_of(cfg: dict):
    """The plain reference of the configuration's base distance."""
    return reference.load(cfg["spec"]["distance"])


def load_program(device) -> None:
    """Import the program and build its CUDA kernels (a no-op once built)."""
    import repro_torch.core.index  # noqa: F401

    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build

        build.build_all()


def build_index(cfg: dict, X, device):
    """``ANNIndex.build`` with the configuration's fixed ``build_seed``: the
    corpus comes from the run's seed, the build's draws do not."""
    from repro_torch.core.index import ANNIndex

    gen = torch.Generator(device=device).manual_seed(int(cfg["build_seed"]))
    return ANNIndex.build(X, spec=spec_of(cfg), generator=gen)


def prepare(cfg, seed, device, clock, with_index=True):
    """Set-up's first parts: the data, the program's library, the index."""
    reference_of(cfg)  # an unknown distance fails before any work
    X, pool = make_data(cfg, seed, device)
    clock.lap("data")
    load_program(device)
    clock.lap("library")
    idx = None
    if with_index:
        idx = build_index(cfg, X, device)
        clock.lap("build")
    return X, pool, idx


def answers_judge(cfg, X, pool, qidx, ids, dists, due, limits):
    """``judge`` of a search's answers: ``qidx`` (N,) pool rows, ``ids`` and
    ``dists`` (N, k), ``due`` answers due in the window."""
    def judge():
        dist = reference_of(cfg)
        used = torch.zeros(pool.shape[0], dtype=torch.bool, device=pool.device)
        used[qidx.long()] = True
        _, truth = J.pool_truth(dist, X, pool, used, int(cfg["spec"]["k"]))
        return J.judge_answers(dist, X, pool, qidx, ids, dists, truth, due=due,
                               floor=float(limits["recall_at_10_floor"]),
                               limit_gap=float(limits["dist_gap"]))
    return judge
