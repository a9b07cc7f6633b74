"""The per-layer metrics that read the program's spans (``core/trace.py``):
a tiny traced CPU run of each entry gives a float for each of its cell's
span metrics, and the searcher's lock-steps per batch equal the
``beam_step`` calls a wrapper counts while the profiler runs.  A metric
read from the device trace has nothing to read on the CPU."""

import pytest
import torch

from portbench import harness
from repro_torch.core import batched_beam
from tiny import cells_by_entry, run_tiny

BENCH = harness.load_bench()
CELLS = cells_by_entry()
SPAN_METRICS = ("steps_per_batch.bulk", "kernels_per_step.bulk", "step_host_ms.bulk",
                "host_ms_per_tick.stream", "dedup_share.build")


def _profiled_calls(monkeypatch, name: str) -> list:
    """Count the calls of ``batched_beam.<name>`` made while the profiler runs."""
    fn = getattr(batched_beam, name)
    calls = []

    def counted(*args, **kwargs):
        if torch.autograd.profiler._is_profiler_enabled:
            calls.append(1)
        return fn(*args, **kwargs)

    monkeypatch.setattr(batched_beam, name, counted)
    return calls


@pytest.mark.parametrize("entry", sorted(CELLS))
def test_span_metrics_read_a_float(entry, monkeypatch):
    cell = CELLS[entry]
    steps = _profiled_calls(monkeypatch, "beam_step")
    batches = _profiled_calls(monkeypatch, "batched_beam_search")
    line = run_tiny(cell, trace=True)
    assert line["correct"] is True
    mine = [m for m in harness.cell_metrics(BENCH, cell, "per_layer") if m["name"] in SPAN_METRICS]
    assert mine
    for m in mine:
        if m["source"] == "device_trace":
            assert m["name"] not in line["metrics"]  # no device on the CPU
        else:
            assert isinstance(line["metrics"][m["name"]]["value"], float), m["name"]
    if entry == "searcher":
        assert len(batches) >= 1
        assert line["metrics"]["steps_per_batch.bulk"]["value"] == len(steps) / len(batches)
