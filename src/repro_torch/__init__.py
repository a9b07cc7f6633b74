"""PyTorch/CUDA port of the non-metric neighborhood-graph retrieval system.

The package mirrors ``repro`` module for module (``core``, ``kernels``,
``data``, ``launch``) and runs on an NVIDIA H100.  It imports ``torch`` and
never ``jax`` or ``repro``: where it needs code that ``repro`` also has, it
keeps its own copy.

Device rule: entry points default to ``device="cuda"`` and raise when CUDA is
missing.  They run on the CPU only when the caller passes ``device="cpu"``
(the CPU tests do); the kernel wrappers then take their plain PyTorch
versions because the tensors they are given lie on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device() -> torch.device:
    """The CUDA device, or ``RuntimeError`` when this process has none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' explicitly to run the plain path")
    return torch.device("cuda")


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA request without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        default_device()
    return dev
