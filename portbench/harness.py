"""Run one cell of ``BENCHMARK.json`` and print its result line.

Everything a cell needs is found by name (``plugins``): the configuration's
file from ``configs``, with its data generator ``data/<data>.py`` and its
reference distance ``reference/<distance>.py``; the traffic mix
``traffic/<traffic>.json``, with its entry ``entries/<entry>.py`` and its
arrival law ``arrivals/<law>.py``; the cell's limits
``limits/<workload>.json``; and each per-layer metric's reader
``metrics/<name>.py``, whose ``read(run)`` returns a number or ``None`` when
it finds nothing to read.

Order of a run: set-up (data, the program's library, the build a cell
needs, warm-up), the measured window, a profiled segment when ``--trace
1``, the peak of device memory, the program's state freed, then the
comparison with the plain reference (``judge``), whose numbers are printed
beside their limits as the last lines of standard error and, under
``checks``, as the last key of the result line.
"""

from __future__ import annotations

import json
import pathlib
import sys
import time

import torch

from portbench import plugins
from portbench import traffic as T

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench: dict, name: str) -> dict:
    entry = find(bench["configs"], name, "config")
    return json.loads((ROOT / entry["file"]).read_text())


def load_limits(workload: str) -> dict:
    """The cell's limits: ``portbench/limits/<workload>.json``."""
    return json.loads((HERE / "limits" / f"{workload}.json").read_text())


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return plugins.load("metrics", name, "per-layer metric").read


def peaks(kind: str) -> dict:
    table = json.loads((HERE / "peaks.json").read_text())
    return table.get(kind, {})


def merged(base: dict, over: dict) -> dict:
    """``base`` with the keys of ``over``; a dict in both is merged one level down."""
    out = dict(base)
    for k, v in over.items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell_metrics(bench: dict, workload: str, key: str) -> list:
    """The metrics of ``bench[key]`` that this cell reports."""
    return [m for m in bench[key] if "workloads" not in m or workload in m["workloads"]]


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: dict | None = None) -> dict:
    """One run of ``workload``; returns the result line as a dict.

    ``overrides`` replaces keys of the configuration and the mix (the CPU
    tests run the same path at a tiny size)."""
    cell = find(bench["workloads"], workload, "workload")
    cfg = load_config(bench, cell["config"])
    mix = T.load(cell["traffic"])
    limits = load_limits(workload)
    if overrides:
        cfg = merged(cfg, overrides.get("config", {}))
        mix = merged(mix, overrides.get("traffic", {}))
        limits = merged(limits, overrides.get("limits", {}))
    t_entry = time.perf_counter()
    run = T.entry(mix).run(cfg, mix, seed, seconds, trace, device, limits)
    setup_s = run.t_window - t_start
    parts = {"process": t_entry - t_start, **run.setup}
    dev = torch.device(device)
    chips = int(cell["chips"])
    if dev.type == "cuda":
        torch.cuda.synchronize()
        kind = torch.cuda.get_device_name(0)
        peak = max(int(torch.cuda.max_memory_allocated(i)) for i in range(chips))
        device_line = {"platform": "gpu", "kind": kind, "count": chips,
                       "memory_peak_bytes": peak}
    else:
        kind = "cpu"
        device_line = {"platform": "cpu", "kind": kind, "count": chips, "memory_peak_bytes": 0}
    if trace and run.trace is not None:
        device_line["busy_s"] = run.trace.busy_s
        device_line["window_s"] = run.trace.window_s
    print("setup " + json.dumps({"setup_s": setup_s, "parts_s": parts}), flush=True)
    print("window " + json.dumps(run.notes), flush=True)

    # the program's state is gone (the entry kept only data and answers): judge
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks = run.judge()
    judge_s = time.perf_counter() - t_judge
    correct = all(ok for _, _, ok in checks.values())
    failed = int(checks.get("invalid", (0,))[0] + checks.get("missing", (0,))[0])
    values = dict(run.metrics, setup_s=setup_s)
    if "recall_at_10" in checks:
        values["recall_at_10"] = checks["recall_at_10"][0]
    print("judge " + json.dumps({"seconds": judge_s,
                                 **{k: v[0] for k, v in checks.items()}}), flush=True)

    if trace:
        run.counters["peaks"] = peaks(kind)
        metrics = {}
        for m in cell_metrics(bench, workload, "per_layer"):
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, workload, "end_to_end")
                   if m["name"] in values}
    line = {"correct": correct, "attempted": run.attempted, "failed": failed,
            "metrics": metrics, "device": device_line}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["checks"] = {k: {"value": v, "limit": lim,
                          "rule": "<=" if k not in ("recall_at_10", "graph_recall") else ">="}
                      for k, (v, lim, _) in checks.items()}
    return line


def emit(line: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} {c['rule']} {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
