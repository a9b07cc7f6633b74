"""A short profiled segment of a run, reduced to what the readers need.

``profiled(fn)`` runs ``fn`` once under ``torch.profiler`` with CPU and
CUDA activities, synchronises, and returns a ``Trace``: the wall seconds of
the segment, the union of the device's busy intervals, every device kernel
and copy by name, and the longest idle gaps of the device labelled by the
innermost host operation that was running at the middle of each gap.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from typing import Callable

import torch


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: int  # device kernels launched in the segment
    device_ops: list  # [[name, seconds], ...] by total device time, longest first
    idle_gaps: list  # [[host op, seconds], ...] idle device time by host op
    result: object = None  # what ``fn`` returned

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def _union(intervals: list) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _device_events(prof):
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def _gap_labels(prof, gaps: list, top: int) -> list:
    """Sum each idle gap under the innermost host op that spans its middle."""
    cpu = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CPU]
    cpu.sort()
    by_name: dict[str, float] = {}
    starts = [c[0] for c in cpu]
    for a, b in gaps:
        mid = 0.5 * (a + b)
        j = bisect.bisect_right(starts, mid)
        name, width = "python", float("inf")
        # the innermost op containing mid: the shortest of those that started before it
        for s, e, nm in cpu[max(0, j - 400):j]:
            if e >= mid and e - s < width:
                name, width = nm, e - s
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]


def profiled(fn: Callable, top: int = 10) -> Trace:
    """Run ``fn`` once under the profiler (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    dev = _device_events(prof)
    busy = _union([(a, b) for a, b, _ in dev]) * 1e-6
    by_op: dict[str, float] = {}
    kernels = 0
    for a, b, name in dev:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
        if not name.startswith("Memcpy") and not name.startswith("Memset"):
            kernels += 1
    ops = sorted(([k[:100], v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top]
    gaps = []
    end = None
    for a, b, _ in sorted(dev):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    return Trace(window_s=window, busy_s=busy, kernels=kernels, device_ops=ops,
                 idle_gaps=_gap_labels(prof, gaps[:2000], top), result=out)
