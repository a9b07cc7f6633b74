"""The host work the card waits behind, per scheduler tick, in ms: the host
seconds of the program's ``sched.admit``, ``sched.retire``, ``sched.submit``
and ``sched.collect`` spans in the profiled segment over its ``sched.tick``
spans (``core/scheduler.py``, ``core/trace.py``)."""

PARTS = ("sched.admit", "sched.retire", "sched.submit", "sched.collect")


def _spans() -> dict:
    try:
        from repro_torch.core import trace
    except ImportError:  # a program without spans
        return {}
    return trace.snapshot()["spans"]


def read(run):
    sp = _spans()
    tick = sp.get("sched.tick")
    if not tick:
        return None
    return 1e3 * sum(sp[p]["host_s"] for p in PARTS if p in sp) / tick["count"]
