"""Every name in BENCHMARK.json resolves to its files, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from portbench import harness, plugins, reference
from portbench import traffic as T

ROOT = harness.ROOT
BENCH = harness.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert word.startswith("portbench/")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w = harness.find(BENCH["workloads"], cell, "workload")
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    cfg = harness.load_config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    assert callable(plugins.load("data", cfg["data"], "data generator").make)
    dist = reference.load(cfg["spec"]["distance"])
    assert all(callable(getattr(dist, f)) for f in ("pairs", "left_matrix", "right_matrix"))
    assert cfg["spec"]["build_policy"] in reference.POLICIES
    mix = T.load(w["traffic"])
    entry = T.entry(mix)
    assert callable(entry.run) and callable(entry.control)
    if "arrivals" in mix:
        assert callable(plugins.load("arrivals", mix["arrivals"], "arrival law").times)
    assert harness.load_limits(cell)
    reported = [m["name"] for m in harness.cell_metrics(BENCH, cell, "end_to_end")]
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_resolves(name):
    m = harness.find(BENCH["per_layer"], name, "metric")
    assert callable(harness.reader(name))
    e2e = harness.find(BENCH["end_to_end"], m["moves"], "metric")
    for cell in m["workloads"]:
        assert cell in CELLS
        assert "workloads" not in e2e or cell in e2e["workloads"]


@pytest.mark.parametrize("folder,what", [("entries", "entry"), ("reference", "reference distance"),
                                         ("arrivals", "arrival law"), ("data", "data generator"),
                                         ("metrics", "per-layer metric")])
def test_unknown_name_raises(folder, what):
    with pytest.raises(ValueError, match="no " + what):
        plugins.load(folder, "no_such_name", what)


def test_unknown_build_policy_raises():
    with pytest.raises(ValueError, match="build policy"):
        reference.policy("l2")


def test_names_units_and_configs():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced"]
    assert (ROOT / "BENCHMARK.json").stat().st_size < 64 * 1024
