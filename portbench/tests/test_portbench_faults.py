"""A run whose timed path is broken underneath comes out as not correct.

Each cell is driven through the whole harness on the CPU at a tiny size,
with one of the faults a one-card cell can have planted in the program:

* ``unchanged``: every step returns its state as it came in (a search step
  that only marks its beams converged, an NN-descent round that scores no
  candidate, so the graph stays the random start);
* ``half``: half of the work left out (half of a batch's answers, half of
  a stream's requests, half of the graph's rows);
* ``altered``: one answer changed where it is produced (an id of every
  answer, or a forward neighbour of every node, moved to the next row).
"""

import pytest
import torch

from repro_torch.core import batched_beam, index, nndescent, scheduler
from tiny import cells_by_entry, run_tiny

CELLS = cells_by_entry()


def _step_unchanged(st, *args, **kwargs):
    return st._replace(done=torch.ones_like(st.done))


def _plant(monkeypatch, entry: str, fault: str):
    if fault == "unchanged":
        if entry == "build":
            monkeypatch.setattr(nndescent, "round_scores",
                                lambda dist, safe, rest, qc, consts, out: out.fill_(float("inf")))
        else:
            monkeypatch.setattr(batched_beam, "beam_step", _step_unchanged)
            monkeypatch.setattr(scheduler, "beam_step", _step_unchanged)
        return
    if entry == "build":
        build = index.build_nndescent

        def broken(*args, **kwargs):
            nb, deg = build(*args, **kwargs)
            nb = nb.clone()
            n = nb.shape[0]
            if fault == "half":
                nb[n // 2:] = -1
            else:
                nb[:, 0] = (nb[:, 0] + 1) % n
            return nb, deg

        monkeypatch.setattr(index, "build_nndescent", broken)
    elif entry == "searcher":
        searcher = index.ANNIndex.searcher

        def broken(self, *args, **kwargs):
            search = searcher(self, *args, **kwargs)
            n = self.X.shape[0]

            def run(Q):
                d, ids, ev, hops = search(Q)
                if fault == "half":
                    h = Q.shape[0] // 2
                    return d[:h], ids[:h], ev[:h], hops[:h]
                ids = ids.clone()
                ids[:, 0] = (ids[:, 0] + 1) % n
                return d, ids, ev, hops
            return run

        monkeypatch.setattr(index.ANNIndex, "searcher", broken)
    else:
        run_stream = scheduler.SlotScheduler.run_stream

        def broken(self, Q, *args, **kwargs):
            res = run_stream(self, Q, *args, **kwargs)
            if fault == "half":
                return res[::2]
            for r in res:
                r.ids = r.ids.copy()
                r.ids[0] = (r.ids[0] + 1) % int(self._n)
            return res

        monkeypatch.setattr(scheduler.SlotScheduler, "run_stream", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("entry", sorted(CELLS))
def test_fault_is_not_correct(entry, fault, monkeypatch):
    _plant(monkeypatch, entry, fault)
    line = run_tiny(CELLS[entry])
    assert line["correct"] is False, line["checks"]
