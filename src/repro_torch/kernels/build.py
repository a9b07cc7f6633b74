"""Build the CUDA kernels with ``nvcc`` on first use and load them with ctypes.

Each source under ``kernels/csrc/`` compiles into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so <source>.cu

The library lands in ``build/repro_torch/`` at the root of the checkout, named
after the source and a hash of its content, so an edited source rebuilds and
an unchanged one is reused.  ``ptxas`` reports each kernel's registers and
shared memory into a ``.log`` file beside the library.  Only the sources in
the repository are used.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
                       "are built on the machine with the card")


def library_path(name: str) -> pathlib.Path:
    """Where the library built from ``csrc/<name>.cu`` lives (built or not)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename: concurrent builders never see a
    # half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> list[pathlib.Path]:
    """Build every source under ``csrc/``, one ``nvcc`` each, all started
    together (a parent builds before it spawns ranks, which then only load)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; one handle per process."""
    return ctypes.CDLL(str(build(name)))


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``.

    ``dtype`` may be a tuple of accepted types.
    """
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    accepted = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in accepted:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {' or '.join(map(str, accepted))}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name`` (``ops.launch_counts``)."""
    from repro_torch.core import trace  # here: the core package imports the kernels

    trace.count("launches." + name)


def build_log(name: str) -> str:
    """The nvcc command and ptxas report of the last build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""
