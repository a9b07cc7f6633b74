"""The time a lock-step takes as a request sees it: the mean over every
request of the window of its service time, ``t_done - t_admit``, over the
beam steps it took (``hops``), in ms (``core/scheduler.py``'s
``SlotResult``).  With every slot busy the scheduler's tick sets it, host
and device together."""


def read(run):
    req = run.counters.get("requests")
    if not req or not len(req["hops"]):
        return None
    hops = req["hops"].clip(min=1)
    return 1e3 * float(((req["t_done"] - req["t_admit"]) / hops).mean())
