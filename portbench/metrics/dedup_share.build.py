"""``_dedup_topk``'s share of one profiled NN-descent build on the card: the
device seconds of the program's ``build.dedup`` spans over those of its
``build.nndescent`` span, each timed by a pair of CUDA events
(``core/nndescent.py``, ``core/trace.py``)."""


def _spans() -> dict:
    try:
        from repro_torch.core import trace
    except ImportError:  # a program without spans
        return {}
    return trace.snapshot()["spans"]


def read(run):
    sp = _spans()
    dedup, build = sp.get("build.dedup"), sp.get("build.nndescent")
    if not dedup or not build or build["device_s"] <= 0:
        return None
    return 100.0 * dedup["device_s"] / build["device_s"]
