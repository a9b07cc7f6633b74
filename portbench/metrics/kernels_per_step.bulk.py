"""Device kernels of the profiled segment per lock-step: the kernels the
profiler saw (copies and memsets not counted) over the program's
``search.step`` spans (``core/batched_beam.py``, ``core/trace.py``)."""


def _spans() -> dict:
    try:
        from repro_torch.core import trace
    except ImportError:  # a program without spans
        return {}
    return trace.snapshot()["spans"]


def read(run):
    tr = run.trace
    step = _spans().get("search.step")
    if tr is None or not tr.kernels or not step:
        return None
    return tr.kernels / step["count"]
