"""Find a piece of the benchmark by its name: the file ``<folder>/<name>.py``.

Entries (``entries/``), arrival laws (``arrivals/``), data generators
(``data/``), reference distances (``reference/``) and per-layer readers
(``metrics/``) are each one file, named as ``BENCHMARK.json``, a
configuration or a traffic mix names it, so that a later cell adds files and
edits none.  An unknown name raises.
"""

from __future__ import annotations

import importlib.util
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent


def load(folder: str, name: str, what: str):
    """The module of ``portbench/<folder>/<name>.py``, loaded once."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file() or name.startswith("_"):
        raise ValueError(f"no {what} named {name!r}: portbench/{folder}/{name}.py does not exist")
    key = f"portbench_{folder}__{name.replace('.', '_')}"
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return mod
