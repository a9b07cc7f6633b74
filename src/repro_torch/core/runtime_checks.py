"""Runtime sanitizers (PyTorch port of ``repro.core.runtime_checks``): the
recompile guard and strict mode.

* :func:`recompile_guard` asserts that a set of compiled callables ends a
  block with no more than ``max_executables`` compiled graphs each.  For a
  ``torch.compile``d function that is the number of dynamo cache entries of
  its code object; any other object counts through its own ``_cache_size()``
  (the protocol a CUDA-graph wrapper implements, one captured graph per
  shape).  The port's serving steps are eager, so nothing in it is guarded
  yet: ``ShardedSlotScheduler`` reports no ``step_executables`` /
  ``admit_executables`` until its steps have a cache.

* :func:`enable_strict_mode` is ``repro``'s opt-in debug config mapped onto
  what torch has.  ``REPRO_STRICT_TRANSFER`` (``jax_transfer_guard``, default
  ``log``) becomes ``torch.cuda.set_sync_debug_mode``: ``allow`` ->
  ``default``, ``log`` -> ``warn``, ``disallow`` -> ``error`` (the
  ``_explicit`` variants alike), so every synchronizing CUDA call (a
  device-to-host read, a blocking host-to-device copy, ``nonzero``) warns or
  raises.  ``REPRO_STRICT_NANS=1`` (``jax_debug_nans``) becomes
  ``torch.autograd.set_detect_anomaly(True, check_nan=True)``: a backward
  that returns NaN raises.  ``jax_numpy_rank_promotion`` and
  ``jax_check_tracer_leaks`` have no torch counterpart and are recorded as
  unapplied.  :func:`disable_strict_mode` restores torch's defaults.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Mapping, Optional

import torch

STRICT_ENV = "REPRO_STRICT"
STRICT_NANS_ENV = "REPRO_STRICT_NANS"
STRICT_TRANSFER_ENV = "REPRO_STRICT_TRANSFER"

# jax_transfer_guard level -> torch.cuda.set_sync_debug_mode level
SYNC_DEBUG_MODES = {
    "allow": "default",
    "log": "warn",
    "disallow": "error",
    "log_explicit": "warn",
    "disallow_explicit": "error",
}
# repro's strict switches that torch has no counterpart for
UNAPPLIED = ("jax_numpy_rank_promotion", "jax_check_tracer_leaks")


class RecompileError(AssertionError):
    """A compiled path holds more executables than its contract allows."""


def dispatch_cache_size(fn) -> int:
    """Number of compiled executables behind ``fn``: the dynamo cache
    entries of a ``torch.compile``d function's code object (shared by every
    function made from that code), else ``fn._cache_size()``."""
    orig = getattr(fn, "_torchdynamo_orig_callable", None)
    if orig is not None and hasattr(orig, "__code__"):
        from torch._dynamo.eval_frame import _debug_get_cache_entry_list

        return len(_debug_get_cache_entry_list(orig.__code__))
    try:
        return int(fn._cache_size())
    except AttributeError:
        raise TypeError(
            f"{fn!r} is neither a torch.compile'd function nor an object with "
            f"_cache_size(); pass one of those"
        ) from None


def _fn_name(fn) -> str:
    orig = getattr(fn, "_torchdynamo_orig_callable", fn)
    return getattr(orig, "__name__", None) or repr(fn)


@contextlib.contextmanager
def recompile_guard(*compiled_fns, max_executables: int = 1) -> Iterator[None]:
    """Assert each compiled fn ends the block with <= ``max_executables``.

    Raises :class:`RecompileError` naming every offending callable with its
    entry and exit cache sizes.  ``max_executables`` raises the cap for
    paths that compile one executable per shape bucket.
    """
    if not compiled_fns:
        raise TypeError("recompile_guard needs at least one compiled callable")
    entry = [dispatch_cache_size(f) for f in compiled_fns]
    yield
    offenders = []
    for fn, before in zip(compiled_fns, entry):
        after = dispatch_cache_size(fn)
        if after > max_executables:
            offenders.append(f"{_fn_name(fn)}: {after} executables "
                             f"(cap {max_executables}, {before} at entry)")
    if offenders:
        raise RecompileError(
            "dispatch cache grew past the zero-recompile contract — a new "
            "shape, dtype or guarded Python value reached a compiled "
            "signature: " + "; ".join(offenders))


def strict_mode_requested(env: Optional[Mapping[str, str]] = None) -> bool:
    """True when the ``REPRO_STRICT`` switch is set (and not "0")."""
    env = os.environ if env is None else env
    return env.get(STRICT_ENV, "") not in ("", "0")


def _set_sync_debug_mode(mode: str) -> Optional[str]:
    """Apply ``mode``; None where torch was built without CUDA (its setter
    raises ``AssertionError`` there)."""
    try:
        torch.cuda.set_sync_debug_mode(mode)
    except AssertionError:
        return None
    return mode


def enable_strict_mode(env: Optional[Mapping[str, str]] = None) -> dict:
    """Apply the strict debug config; returns what was applied.

    ``sync_debug_mode`` is the level set (None without CUDA),
    ``detect_anomaly`` whether NaN-checking anomaly mode is on, and
    ``unapplied`` the switches of ``repro`` that torch cannot apply.  A bad
    ``REPRO_STRICT_TRANSFER`` raises ``ValueError`` before anything is set.
    Safe to call more than once.
    """
    env = os.environ if env is None else env
    transfer = env.get(STRICT_TRANSFER_ENV, "log")
    if transfer not in SYNC_DEBUG_MODES:
        raise ValueError(f"{STRICT_TRANSFER_ENV}={transfer!r}; known: "
                         f"{', '.join(SYNC_DEBUG_MODES)}")
    debug_nans = env.get(STRICT_NANS_ENV, "") not in ("", "0")
    mode = _set_sync_debug_mode(SYNC_DEBUG_MODES[transfer])
    if debug_nans:
        torch.autograd.set_detect_anomaly(True, check_nan=True)
    return {
        "jax_transfer_guard": transfer,
        "sync_debug_mode": mode,
        "jax_debug_nans": debug_nans,
        "detect_anomaly": torch.is_anomaly_enabled(),
        "unapplied": UNAPPLIED,
    }


def disable_strict_mode() -> dict:
    """Undo :func:`enable_strict_mode`: sync debug back to ``default`` and
    anomaly mode off; returns the settings now in force."""
    mode = _set_sync_debug_mode("default")
    torch.autograd.set_detect_anomaly(False)
    return {"sync_debug_mode": mode, "detect_anomaly": torch.is_anomaly_enabled()}
