"""Port parity: the runtime checks (``repro_torch.core.runtime_checks``)
against ``repro.core.runtime_checks``.

The recompile guard runs the shape sequences of ``tests/test_runtime_checks.py``
through ``jax.jit(f)`` and through ``torch.compile(f, backend="eager",
dynamic=False)``: the cache sizes at every point, whether the block passes
or raises, and the message's parts must be equal.  Dynamo caches per code
object, so each fresh torch function gets a code object of its own (every
``jax.jit`` has its own cache).  Strict mode changes process-wide settings,
so it runs in a subprocess, as ``repro``'s test does; on a torch built
without CUDA its sync-debug level is recorded as None.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import runtime_checks as jrc
from repro_torch.core import (RecompileError, dispatch_cache_size, enable_strict_mode,
                              recompile_guard, strict_mode_requested)
from repro_torch.core import runtime_checks as trc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool per test worker oversubscribes the
    cores under parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _double(x):
    return x * 2


def _fresh_jax(name="f"):
    def f(x):
        return x * 2

    f.__name__ = name  # before jit, which copies it
    return jax.jit(f)


def _fresh_torch(name="f"):
    def f(x):
        return x * 2

    f.__code__ = f.__code__.replace()  # a dynamo cache of its own
    f.__name__ = name
    return torch.compile(f, backend="eager", dynamic=False)


PACKAGES = {
    "jax": (_fresh_jax, lambda shape: jnp.ones(shape), jrc),
    "torch": (_fresh_torch, lambda shape: torch.ones(shape), trc),
}


def _scenario(name, package):
    """Run one of ``tests/test_runtime_checks.py``'s sequences; returns the
    cache sizes read along the way and the outcome ("pass" or the message
    of the error raised)."""
    fresh, ones, rc = PACKAGES[package]
    sizes = []

    def guarded(fns, body, **kw):
        try:
            with rc.recompile_guard(*fns, **kw):
                body()
        except rc.RecompileError as e:
            return str(e)
        return "pass"

    if name == "stable":
        f = fresh()
        x = ones((4,))
        f(x)
        out = guarded([f], lambda: (f(x), f(x + 1)))
        sizes.append(rc.dispatch_cache_size(f))
    elif name == "first_compile":
        f = fresh()
        sizes.append(rc.dispatch_cache_size(f))
        out = guarded([f], lambda: f(ones((4,))))
        sizes.append(rc.dispatch_cache_size(f))
    elif name == "growth":
        f = fresh("step")
        f(ones((4,)))
        sizes.append(rc.dispatch_cache_size(f))
        out = guarded([f], lambda: f(ones((4, 2))))
        sizes.append(rc.dispatch_cache_size(f))
    elif name == "cap2":
        f = fresh()
        out = guarded([f], lambda: (f(ones((4,))), f(ones((4, 2)))), max_executables=2)
        sizes.append(rc.dispatch_cache_size(f))
        out = [out, guarded([f], lambda: f(ones((4, 2, 2))), max_executables=2)]
        sizes.append(rc.dispatch_cache_size(f))
    elif name == "every_fn":
        f, g = fresh(), fresh("g")
        f(ones((4,)))
        out = guarded([f, g], lambda: (g(ones((3,))), g(ones((5,)))))
        sizes += [rc.dispatch_cache_size(f), rc.dispatch_cache_size(g)]
    return sizes, out


def _parts(out):
    """The outcome reduced to what both packages must say alike."""
    if out == "pass":
        return "pass"
    return {"grew": "dispatch cache grew" in out,
            "offenders": sorted(p.split(":")[0] for p in out.split(": ", 1)[1].split("; ")),
            "counts": sorted(p.split(": ", 1)[1] for p in out.split(": ", 1)[1].split("; "))}


@pytest.mark.parametrize("name", ["stable", "first_compile", "growth", "cap2", "every_fn"])
def test_guard_equals_repro(name):
    want_sizes, want = _scenario(name, "jax")
    got_sizes, got = _scenario(name, "torch")
    assert got_sizes == want_sizes
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert [_parts(o) for o in got] == [_parts(o) for o in want]


def test_guard_contracts():
    """``repro``'s own assertions, on the port alone."""
    f = _fresh_torch()
    x = torch.ones((4,))
    f(x)
    with recompile_guard(f):
        f(x)
        f(x + 1)
    assert dispatch_cache_size(f) == 1
    g = _fresh_torch("step")
    g(torch.ones((4,)))
    with pytest.raises(RecompileError) as ei:
        with recompile_guard(g):
            g(torch.ones((4, 2)))
    msg = str(ei.value)
    assert "dispatch cache grew" in msg and "step: 2 executables" in msg
    assert "2 executables" in msg and "1 at entry" in msg
    assert isinstance(ei.value, AssertionError)


def test_guard_rejects_plain_functions_and_no_arguments():
    with pytest.raises(TypeError) as ei:
        dispatch_cache_size(_double)
    assert "torch.compile" in str(ei.value) and "_cache_size()" in str(ei.value)
    with pytest.raises(TypeError):
        with recompile_guard():
            pass


def test_guard_reads_the_cache_size_protocol():
    """Any object with ``_cache_size()`` is guarded through it (a CUDA-graph
    wrapper's protocol: one captured graph per shape)."""

    class Captured:
        def __init__(self):
            self.shapes = set()
            self.__name__ = "captured_step"

        def __call__(self, x):
            self.shapes.add(tuple(x.shape))
            return x

        def _cache_size(self):
            return len(self.shapes)

    c = Captured()
    c(torch.ones(4))
    with recompile_guard(c):
        c(torch.ones(4))
    assert dispatch_cache_size(c) == 1
    with pytest.raises(RecompileError, match="captured_step: 2 executables"):
        with recompile_guard(c):
            c(torch.ones(5))


def test_strict_mode_requested_equals_repro():
    for env in ({}, {"REPRO_STRICT": ""}, {"REPRO_STRICT": "0"}, {"REPRO_STRICT": "1"},
                {"REPRO_STRICT": "yes"}):
        assert strict_mode_requested(env) == jrc.strict_mode_requested(env)
    assert not strict_mode_requested({"REPRO_STRICT": "0"})
    assert strict_mode_requested({"REPRO_STRICT": "1"})
    assert (trc.STRICT_ENV, trc.STRICT_NANS_ENV, trc.STRICT_TRANSFER_ENV) == (
        jrc.STRICT_ENV, jrc.STRICT_NANS_ENV, jrc.STRICT_TRANSFER_ENV)


def test_transfer_levels_map_to_sync_debug_modes():
    assert trc.SYNC_DEBUG_MODES == {"allow": "default", "log": "warn", "disallow": "error",
                                    "log_explicit": "warn", "disallow_explicit": "error"}
    with pytest.raises(ValueError, match="REPRO_STRICT_TRANSFER"):
        enable_strict_mode({"REPRO_STRICT_TRANSFER": "sometimes"})


def test_enable_strict_mode_applies_torch_config():
    """Subprocess (process-wide settings must not leak into this process):
    the returned map, NaN-checking anomaly mode under REPRO_STRICT_NANS=1,
    the refusal of a bad level before anything is set, and the undo."""
    body = """
import torch
from repro_torch.core.runtime_checks import disable_strict_mode, enable_strict_mode

cuda = torch.cuda.is_available()

def nan_backward():
    x = torch.zeros(1, requires_grad=True)
    (0.0 * torch.log(x)).sum().backward()  # d log(x) = 0 / 0 at x = 0

applied = enable_strict_mode({"REPRO_STRICT_TRANSFER": "log"})
assert applied["jax_transfer_guard"] == "log", applied
assert applied["sync_debug_mode"] == ("warn" if cuda else None), applied
assert applied["jax_debug_nans"] is False and applied["detect_anomaly"] is False, applied
assert applied["unapplied"] == ("jax_numpy_rank_promotion", "jax_check_tracer_leaks"), applied
nan_backward()  # no NaN check without REPRO_STRICT_NANS
try:
    enable_strict_mode({"REPRO_STRICT_TRANSFER": "never", "REPRO_STRICT_NANS": "1"})
except ValueError:
    pass
else:
    raise SystemExit("a bad transfer level did not raise")
assert not torch.is_anomaly_enabled(), "a refused call applied the NaN check"
applied = enable_strict_mode({"REPRO_STRICT": "1", "REPRO_STRICT_NANS": "1"})
assert applied["jax_debug_nans"] is True and applied["detect_anomaly"] is True, applied
assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
try:
    nan_backward()
except RuntimeError as e:
    assert "nan" in str(e).lower(), e
else:
    raise SystemExit("a NaN backward did not raise under REPRO_STRICT_NANS=1")
off = disable_strict_mode()
assert off == {"sync_debug_mode": "default" if cuda else None, "detect_anomaly": False}, off
assert not torch.is_anomaly_enabled()
if cuda:
    assert torch.cuda.get_sync_debug_mode() == 0
nan_backward()
print("strict mode OK")
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", body], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    assert "strict mode OK" in proc.stdout


def test_core_exports_repro_names():
    import repro.core as jcore
    import repro_torch.core as tcore

    for name in ("RecompileError", "dispatch_cache_size", "enable_strict_mode",
                 "recompile_guard", "strict_mode_requested"):
        assert hasattr(jcore, name) and name in tcore.__all__
    assert issubclass(RecompileError, AssertionError)
    assert np.isclose(tcore.order_aware_recall([[1, 2]], [[1, 2]]), 1.0)
