"""The search's share of the bandwidth roofline in the profiled segment.

The least time the card could take is the bytes the algorithm needs, one
float32 row of the corpus (d x 4 bytes) per distance evaluation, over the
HBM peak; it is divided by the seconds in which the device was busy.  The
bound is by bytes: an evaluation is d multiply-adds against the d x 4
bytes of a gathered row.  Counts the work whatever kernels do it.
"""


def read(run):
    tr = run.trace
    ev = run.counters.get("trace_evals")
    peak = run.counters.get("peaks", {}).get("hbm_bytes_per_s")
    d = run.counters.get("row_floats")
    if tr is None or not ev or not peak or not d or tr.busy_s <= 0:
        return None
    return 100.0 * (ev * d * 4) / (peak * tr.busy_s)
