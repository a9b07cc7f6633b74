"""Named spans and counters of the port, on the profiler's clock.

``span(name, device=False)`` marks one stage of the work (a search's
lock-step, a scheduler tick's admission, an NN-descent round's join).  It
records only while recording is on, which is

* while ``torch.profiler`` records (its start and stop set the flag), or
* inside ``capture()``, the one entry point for an operator or a test.

Off, a span costs one read of a module-level flag and returns a shared
no-op object: no ``record_function``, no clock.  On, it enters a
``record_function`` range of its name when the profiler records, so the
span lies on the trace's timeline beside the kernels.  It is the fast form,
an operator's range: the profiler copies a user annotation onto the
device's timeline too, where a reader of the trace counts it as a kernel
and its whole range as busy.  A span takes the host's start and end with
``time.perf_counter_ns()`` and its parent from a stack of open spans; with
``device=True`` it also times the work queued inside it on the card, by
two CUDA events on the current stream read once they have passed (no
sync), or on the host clock where CUDA is not in use.  The record holds the
latest recorded stretch only: it is cleared when recording starts again
after a stretch of being off.

``count(name, n)``, ``high(name, n)`` and ``timed(name, stream)`` are the
port's always-on counters (a kernel's launches, a collective's calls, bytes
and seconds): a dict update each, read by ``counters(prefix)``.

``snapshot()`` waits for the CUDA events in flight and returns ``{"spans":
{name: {"count", "host_s", "self_s", "device_s", "parent"}}, "counters":
{...}}``; ``self_s`` is the span's host time less the part its child spans
cover.  Spans are host-side and single-threaded, as the port's loops are.
"""

from __future__ import annotations

import collections
import time

import torch
from torch._C import _profiler as _ranges
from torch.autograd import profiler as _profiler

_COUNTERS: dict = {}  # name -> int (counts, bytes) or float (seconds)
_SPANS: dict = {}  # name -> {"count", "host_ns", "self_ns", "device_s", "parent"}
_STACK: list = []  # the open spans, innermost last
_PENDING: collections.deque = collections.deque()  # (table, key, start, end) CUDA events in flight
_on = False  # recording: the profiler records, or capture() is open
_capturing = 0  # depth of open capture() blocks


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def high(name: str, n: int) -> None:
    """Raise counter ``name`` to ``n`` if it is lower (a high-water mark)."""
    if n > _COUNTERS.get(name, 0):
        _COUNTERS[name] = n


def _drain(wait: bool) -> None:
    """Add the times of the event pairs that have passed on the card (all of
    them with ``wait``, waiting for those in flight)."""
    while _PENDING and (wait or _PENDING[0][3].query()):
        table, key, start, end = _PENDING.popleft()
        if wait:
            end.synchronize()
        table[key] = table.get(key, 0.0) + start.elapsed_time(end) / 1e3


class _Timer:
    """Seconds of the work inside it into ``table[key]``: on ``stream`` by two
    CUDA events (the span from the end of the work queued before it to the
    end of its own), resolved later by ``_drain``; on the host clock when
    ``stream`` is None.  The pairs that have passed are drained on leaving,
    while the card still runs the work just queued: on entering, the card
    may be idle (a lock-step begins right after the host read the last one's
    result), and each call there would hold it so."""

    __slots__ = ("table", "key", "stream", "start", "t0")

    def __init__(self, table: dict, key: str, stream):
        self.table, self.key, self.stream = table, key, stream

    def __enter__(self):
        if self.stream is None:
            self.t0 = time.perf_counter()
        else:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.stream is None:
            self.table[self.key] = self.table.get(self.key, 0.0) + time.perf_counter() - self.t0
        else:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            _PENDING.append((self.table, self.key, self.start, end))
            _drain(wait=False)
        return False


def timed(name: str, stream=None) -> _Timer:
    """Always on: add the seconds of the work inside the block to counter
    ``name``, timed on the CUDA ``stream`` (None: the host clock)."""
    return _Timer(_COUNTERS, name, stream)


def counters(prefix: str = "") -> dict:
    """The counters whose names start with ``prefix``, the prefix cut off;
    waits for the CUDA events in flight."""
    _drain(wait=True)
    return {k[len(prefix):]: v for k, v in _COUNTERS.items() if k.startswith(prefix)}


def reset(prefix: str) -> None:
    """Drop the counters whose names start with ``prefix``."""
    _drain(wait=True)
    for k in [k for k in _COUNTERS if k.startswith(prefix)]:
        del _COUNTERS[k]


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


class _Off:
    """The shared span of a site while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "rf", "timer", "t0", "child")

    def __init__(self, name: str, device: bool):
        self.name, self.device, self.rf, self.timer, self.child = name, device, None, None, 0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = _ranges._RecordFunctionFast(self.name)
            self.rf.__enter__()
        if self.device:
            cuda = torch.cuda.is_initialized()
            self.timer = _Timer(None, "device_s", torch.cuda.current_stream() if cuda else None)
            self.timer.__enter__()
        _STACK.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        _STACK.pop()
        rec = _record(self.name)
        rec["count"] += 1
        rec["host_ns"] += dt
        rec["self_ns"] += dt - self.child
        if _STACK:
            _STACK[-1].child += dt
            rec["parent"] = _STACK[-1].name
        if self.timer is not None:
            self.timer.table = rec
            self.timer.__exit__()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def _record(name: str) -> dict:
    rec = _SPANS.get(name)
    if rec is None:
        rec = _SPANS[name] = {"count": 0, "host_ns": 0, "self_ns": 0, "device_s": 0.0,
                              "parent": None}
    return rec


def span(name: str, device: bool = False):
    """A context manager that records the stage ``name`` while recording is
    on (see the module docstring); ``device=True`` also times its work on
    the card."""
    if not _on:
        return _OFF
    return _Span(name, device)


def _clear() -> None:
    _drain(wait=True)
    _SPANS.clear()


def _set(on: bool) -> None:
    """Recording turns ``on`` or off; a stretch that starts clears the record."""
    global _on
    if on and not _on:
        _clear()
    _on = on


class capture:
    """``with capture() as record:`` records every span inside the block;
    on leaving it, ``record`` holds ``snapshot()``."""

    def __enter__(self) -> dict:
        global _capturing
        _set(True)
        _capturing += 1
        self.record = {}
        return self.record

    def __exit__(self, *exc):
        global _capturing
        _capturing -= 1
        self.record.update(snapshot())
        _set(bool(_capturing) or _profiler._is_profiler_enabled)
        return False


def snapshot() -> dict:
    """The latest recorded stretch's spans and every counter (see the module
    docstring); waits for the CUDA events in flight."""
    _drain(wait=True)
    spans = {name: {"count": r["count"], "host_s": r["host_ns"] / 1e9,
                    "self_s": r["self_ns"] / 1e9, "device_s": r["device_s"],
                    "parent": r["parent"]} for name, r in _SPANS.items()}
    return {"spans": spans, "counters": dict(_COUNTERS)}


def _hook_profiler() -> None:
    """Follow ``torch.profiler``'s start and stop: both call these two
    functions of ``torch.autograd.profiler`` by their module-level names."""
    start, stop = _profiler._run_on_profiler_start, _profiler._run_on_profiler_stop

    def on_start():
        start()
        _set(True)

    def on_stop():
        stop()
        _set(bool(_capturing))

    _profiler._run_on_profiler_start, _profiler._run_on_profiler_stop = on_start, on_stop


_hook_profiler()
