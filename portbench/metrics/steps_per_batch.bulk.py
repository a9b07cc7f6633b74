"""Lock-steps per searched batch in the profiled segment: the program's
``search.step`` spans over its ``search.batch`` spans (``core/batched_beam.py``,
recorded by ``core/trace.py`` while the profiler runs)."""


def _spans() -> dict:
    try:
        from repro_torch.core import trace
    except ImportError:  # a program without spans
        return {}
    return trace.snapshot()["spans"]


def read(run):
    sp = _spans()
    step, batch = sp.get("search.step"), sp.get("search.batch")
    if not step or not batch:
        return None
    return step["count"] / batch["count"]
