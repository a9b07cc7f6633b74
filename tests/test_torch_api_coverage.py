"""The port's API against ``repro``'s: a same-named counterpart for every
module, public top-level function, public class and public method of
``src/repro``, with each of its public parameters, in ``src/repro_torch``.

Pure ``ast`` over the source files: neither package is imported.  A
parameter ``repro`` has and the port lacks passes only through ``IDIOMS``,
where the port says the same thing its own way (a PRNG key becomes a
generator, a sharded array this rank's block); a method may live on a base
class of the port's class, found where the class's module defines or
imports that base.  ``ABSENT`` lists the one public function the
port has no counterpart for.  Each entry carries its reason, and a test
fails an entry that no longer excuses anything.
"""

import ast
import functools
import pathlib

import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

# repro parameter -> (the port's names for it, why); () = no counterpart
IDIOMS = {
    "key": (("generator", "rng", "seed"),
            "a jax PRNG key becomes a torch.Generator, a numpy Generator or a seed"),
    "params": (("model",), "a parameter pytree becomes an nn.Module"),
    "X": (("X_local",), "the sharded corpus becomes this rank's block (the local view)"),
    "X_sharded": (("X_local",), "a sharded array becomes this rank's block (the local view)"),
    "neighbors": (("neighbors_local",), "the sharded adjacency becomes this rank's block"),
    "neighbors_sharded": (("neighbors_local",), "the sharded adjacency becomes this rank's "
                                                "block"),
    "mesh": (("group",), "a jax mesh becomes a torch.distributed process group"),
    "db_axes": (("group",), "the mesh axes sharding the corpus become the process group"),
    "use_pallas": ((), "a TPU switch: the tensor's device picks the kernel or its plain "
                       "version"),
    "interpret": ((), "Pallas interpret mode: a CUDA kernel has none"),
    "block_q": ((), "TPU tiling of a Pallas grid"),
    "block_x": ((), "TPU tiling of a Pallas grid"),
    "block_k": ((), "TPU tiling of a Pallas grid"),
    "score_fn": (("dist",), "the distance's own scoring; no pluggable scorer"),
}
# (module, name) -> why the port has none
ABSENT = {
    ("launch.roofline", "parse_collectives"):
        "it reads XLA's HLO text, which torch does not produce",
}


def _module_name(path: pathlib.Path, root: pathlib.Path) -> str:
    parts = list(path.relative_to(root).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "__init__"


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return [n for n in names if not n.startswith("_") and n not in ("self", "cls")]


@functools.lru_cache(maxsize=None)
def _walk(package: str) -> dict:
    """module -> {"functions": {name: params}, "classes": {name: (bases,
    {method: params})}, "imports": {name: (module, name)}} for every public
    top-level name; ``imports`` holds the names a top-level ``from`` import
    takes from the package itself."""
    root = SRC / package
    out = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        functions, classes, imports = {}, {}, {}
        for node in tree.body:
            if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(package):
                source = node.module[len(package) + 1:] or "__init__"
                imports |= {a.asname or a.name: (source, a.name) for a in node.names}
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                functions[node.name] = _params(node)
            elif isinstance(node, ast.ClassDef):
                methods = {b.name: _params(b) for b in node.body
                           if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))}
                bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
                classes[node.name] = (bases, methods)
        out[_module_name(path, root)] = {"functions": functions, "classes": classes,
                                         "imports": imports}
    return out


def _public(name: str) -> bool:
    return not name.startswith("_") or name == "__init__"


def _port_method(module: str, cls: str, method: str):
    """The port's ``cls.method`` params, looked up through its base classes:
    a base is the class that the naming module defines, or the one it
    imports from the port under that name (followed through re-exports)."""
    port = _walk("repro_torch")
    seen, todo = set(), [(module, cls)]
    while todo:
        mod, name = todo.pop(0)
        if (mod, name) in seen:
            continue
        seen.add((mod, name))
        entry = port.get(mod, {})
        hit = entry.get("classes", {}).get(name)
        if hit is None:
            if name in entry.get("imports", {}):
                todo.append(entry["imports"][name])
            continue
        bases, methods = hit
        if method in methods:
            return methods[method]
        todo += [(mod, b) for b in bases]
    return None


def _missing_params(want: list, got: list) -> list:
    missing = []
    for p in want:
        if p in got:
            continue
        alternatives, _ = IDIOMS.get(p, (None, None))
        if alternatives is None or (alternatives and not set(alternatives) & set(got)):
            missing.append(p)
    return missing


def _gaps(module: str) -> list:
    """Every name or parameter of ``repro``'s ``module`` the port lacks."""
    want, port = _walk("repro")[module], _walk("repro_torch").get(module)
    if port is None:
        return [f"module {module}"]
    gaps = []
    for name, params in want["functions"].items():
        if not _public(name) or (module, name) in ABSENT:
            continue
        if name not in port["functions"]:
            gaps.append(f"{module}.{name}")
            continue
        gaps += [f"{module}.{name}({p})"
                 for p in _missing_params(params, port["functions"][name])]
    for cls, (_, methods) in want["classes"].items():
        if not _public(cls):
            continue
        if cls not in port["classes"]:
            gaps.append(f"{module}.{cls}")
            continue
        for method, params in methods.items():
            if not _public(method):
                continue
            got = _port_method(module, cls, method)
            if got is None:
                gaps.append(f"{module}.{cls}.{method}")
                continue
            gaps += [f"{module}.{cls}.{method}({p})" for p in _missing_params(params, got)]
    return gaps


@pytest.mark.parametrize("module", sorted(_walk("repro")))
def test_port_has_repro_module(module):
    assert _gaps(module) == []


def test_exceptions_still_excuse_something():
    """No entry of ``IDIOMS`` or ``ABSENT`` is stale: each names a parameter
    or a function ``repro`` has and the port lacks."""
    repro, port = _walk("repro"), _walk("repro_torch")
    for (module, name), _ in ABSENT.items():
        assert name in repro[module]["functions"]
        assert name not in port[module]["functions"]
    used = set()
    for module, entry in repro.items():
        for name, params in entry["functions"].items():
            got = port.get(module, {}).get("functions", {}).get(name)
            if got is not None:
                used |= {p for p in params if p not in got}
        for cls, (_, methods) in entry["classes"].items():
            for method, params in methods.items():
                got = _port_method(module, cls, method)
                if got is not None:
                    used |= {p for p in params if p not in got}
    assert set(IDIOMS) <= used, set(IDIOMS) - used


def test_the_walk_sees_both_packages():
    repro, port = _walk("repro"), _walk("repro_torch")
    assert len(repro) >= 50 and set(repro) <= set(port)
    assert "recompile_guard" in port["core.runtime_checks"]["functions"]
    assert "decay" in port["train.optimizer"]["functions"]["adafactor"]
