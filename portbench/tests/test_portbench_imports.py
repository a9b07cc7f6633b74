"""No module that a run of the harness loads has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``repro``, compared whole: the program's
own name, ``repro_torch``, begins with ``repro`` and is no such module."""

import json
import subprocess
import sys

from portbench import harness

CODE = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
sys.path[2:] = [p for p in sys.path[2:] if p not in ('', '.')]
from portbench.tests.tiny import cells_by_entry, run_tiny
for cell in cells_by_entry().values():
    run_tiny(cell)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def test_no_jax_or_its_package_loaded():
    code = CODE.format(root=str(harness.ROOT), src=str(harness.ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=str(harness.ROOT / "portbench"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_whole_name_comparison(monkeypatch):
    for name in [m for m in sys.modules if m.split(".")[0] == "repro"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", object())
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_modules()


def test_no_result_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    exits with another code than 0 and prints no result line."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "wiki128-kl.bulk",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
