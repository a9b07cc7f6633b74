"""Device kernels launched by one profiled ``ANNIndex.build`` of the whole
corpus (``core/nndescent.py``, ``core/symmetrize.py``): the build entry's
traced segment is one build; copies and memsets are not counted."""


def read(run):
    tr = run.trace
    if tr is None or not tr.kernels:
        return None
    return float(tr.kernels)
