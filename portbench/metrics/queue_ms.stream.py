"""The mean wait of a request for a slot, ``t_admit - t_arrival`` of every
request of the window, in ms (``core/scheduler.py``'s ``SlotResult``)."""


def read(run):
    req = run.counters.get("requests")
    if not req or not len(req["t_admit"]):
        return None
    return 1e3 * float((req["t_admit"] - req["t_arrival"]).mean())
