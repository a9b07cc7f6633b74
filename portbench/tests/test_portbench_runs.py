"""A tiny CPU run of each traffic mix prints a last line of the contract's
shape, with the compared numbers last and every one of them met."""

import json

import pytest

from portbench import harness
from tiny import cells_by_entry, run_tiny

BENCH = harness.load_bench()
CELLS = cells_by_entry()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("entry", sorted(CELLS))
def test_last_line_shape(entry, trace, capsys):
    cell = CELLS[entry]
    line = run_tiny(cell, trace=bool(trace))
    harness.emit(line)
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    key = "per_layer" if trace else "end_to_end"
    allowed = {m["name"]: m["unit"] for m in harness.cell_metrics(BENCH, cell, key)}
    assert set(last["metrics"]) <= set(allowed)
    for name, m in last["metrics"].items():
        assert m["unit"] == allowed[name] and isinstance(m["value"], float)
    if not trace:
        assert set(last["metrics"]) == set(allowed)
    err = out.err.strip().splitlines()
    assert [ln.split()[1] for ln in err[-len(last["checks"]):]] == list(last["checks"])
