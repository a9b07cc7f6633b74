"""The device's idle share of the profiled segment: the share of its wall
seconds in which no kernel or copy ran (``torch.profiler``)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
