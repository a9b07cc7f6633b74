"""The host's time to dispatch one lock-step, in ms: the mean host self time
of the program's ``search.step`` spans in the profiled segment
(``core/batched_beam.py``, ``core/trace.py``)."""


def _spans() -> dict:
    try:
        from repro_torch.core import trace
    except ImportError:  # a program without spans
        return {}
    return trace.snapshot()["spans"]


def read(run):
    step = _spans().get("search.step")
    if not step:
        return None
    return 1e3 * step["self_s"] / step["count"]
