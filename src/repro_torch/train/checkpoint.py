"""Crash-safe checkpoints (PyTorch port of ``repro.train.checkpoint``).

The protocol is ``repro``'s:
  1. write every chunk file into ``<dir>/step_N.tmp/`` and fsync it;
  2. write ``manifest.json`` last: per leaf its shape, dtype and chunks, and
     the sha256 of every chunk;
  3. atomically rename ``step_N.tmp -> step_N``;
  4. update the ``LATEST`` pointer atomically (write a tmp file, rename).
A crash at any point leaves either the previous LATEST intact or a complete
new step, never a torn checkpoint.  ``restore`` verifies every hash before
it hands the tree back.

The format is the port's own (``repro`` packs chunks with msgpack): each
chunk is the raw bytes of a C-ordered numpy array, cut along axis 0 by
``chunk_mb``.  bfloat16 leaves are stored as their uint16 view and the
manifest names the dtype.  Leaves are tensors or Python ints and floats
(the optimizer's step counter).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/{i}", v)
        else:
            flat[prefix] = node

    walk("", tree)
    return flat


def _unflatten_into(template, flat: Dict[str, Any]):
    def walk(prefix, node):
        if isinstance(node, dict):
            return {k: walk(f"{prefix}/{k}" if prefix else str(k), v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [walk(f"{prefix}/{i}", v) for i, v in enumerate(node)]
            return type(node)(t) if isinstance(node, tuple) else t
        return flat[prefix]

    return walk("", template)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(host array to write, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).removeprefix("torch.")
    if isinstance(leaf, (bool, int, float)):
        arr = np.asarray(leaf)
        return arr, f"py_{type(leaf).__name__}"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _chunks(arr: np.ndarray, chunk_mb: int):
    if arr.ndim == 0 or arr.nbytes <= chunk_mb * 2 ** 20:
        yield arr
        return
    rows_per = max(1, int(chunk_mb * 2 ** 20 / max(arr.nbytes // max(arr.shape[0], 1), 1)))
    for start in range(0, arr.shape[0], rows_per):
        yield arr[start:start + rows_per]


def _write_synced(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def save(directory: str, step: int, tree, *, chunk_mb: int = 256) -> str:
    """Write ``tree`` as ``<directory>/step_<step>`` and point LATEST at it."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "entries": {}}
    for name, leaf in _flatten(tree).items():
        arr, dtype = _to_numpy(leaf)
        entry = {"shape": list(arr.shape), "dtype": dtype, "storage": str(arr.dtype),
                 "chunks": []}
        for ci, chunk in enumerate(_chunks(arr, chunk_mb)):
            fname = f"{hashlib.sha1(name.encode()).hexdigest()[:16]}_{ci}.bin"
            payload = np.ascontiguousarray(chunk).tobytes()
            _write_synced(os.path.join(tmp, fname), payload)
            entry["chunks"].append({"file": fname, "sha256": hashlib.sha256(payload).hexdigest(),
                                    "shape": list(chunk.shape)})
        manifest["entries"][name] = entry

    _write_synced(os.path.join(tmp, "manifest.json"), json.dumps(manifest).encode())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = os.path.join(directory, "LATEST.tmp")
    _write_synced(latest_tmp, str(step).encode())
    os.replace(latest_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _leaf_from(arr: np.ndarray, dtype: str, like, name: str):
    """The restored leaf, shaped, typed and placed as the template's ``like``."""
    if dtype.startswith("py_"):
        return {"py_bool": bool, "py_int": int, "py_float": float}[dtype](arr.item())
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if isinstance(like, torch.Tensor):
        if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
            raise ValueError(f"checkpoint leaf {name}: {tuple(t.shape)} {t.dtype}, the "
                             f"template's {tuple(like.shape)} {like.dtype}")
        t = t.to(like.device)
    return t


def restore(directory: str, template, step: Optional[int] = None):
    """(tree shaped as ``template``, step): leaves take the template's device;
    ``IOError`` when a chunk's hash disagrees with the manifest."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)

    like = _flatten(template)
    flat = {}
    for name, entry in manifest["entries"].items():
        parts = []
        for c in entry["chunks"]:
            with open(os.path.join(base, c["file"]), "rb") as f:
                payload = f.read()
            if hashlib.sha256(payload).hexdigest() != c["sha256"]:
                raise IOError(f"checkpoint corruption in {name} ({c['file']})")
            parts.append(np.frombuffer(payload, dtype=entry["storage"]).reshape(c["shape"]))
        arr = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=0)
        arr = arr.reshape(entry["shape"]).copy()  # writable, owns its bytes
        flat[name] = _leaf_from(arr, entry["dtype"], like.get(name), name)
    return _unflatten_into(template, flat), step


class CheckpointManager:
    """Keep-last-k manager with resume support (restart after a failure)."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100):
        self.directory = directory
        self.keep = keep
        self.every = every
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, tree) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = save(self.directory, step, tree)
        self._gc()
        return path

    def _gc(self):
        steps = sorted(int(d.split("_", 1)[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def resume(self, template) -> Tuple[Any, int]:
        """(restored tree, its step), or (``template``, -1) on a cold start."""
        try:
            return restore(self.directory, template)
        except FileNotFoundError:
            return template, -1
