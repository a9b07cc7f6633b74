"""Production mesh definitions (PyTorch port of ``repro.launch.mesh``).

Functions, not module-level meshes: a mesh is built over the ranks of a
process group that the caller has initialised.  The constants are the
card's: an NVIDIA H100 SXM5 80 GB at its 700 W power limit, from the spec
sheet (dense bf16 tensor-core rate, HBM3 bandwidth and size, NVLink 4),
and the links of a DGX H100 node of ``CARDS_PER_NODE`` cards: NVLink within
a node, one 400 Gb/s ConnectX-7 port per card between nodes (the DGX H100
datasheet).  A collective whose group lies within one node moves at
``NVLINK_BW``, one whose group spans nodes at ``NET_BW``.
"""

from __future__ import annotations

from repro_torch.core.distributed import CARDS_PER_NODE
from repro_torch.sharding.api import Mesh

__all__ = ["CARDS_PER_NODE", "HBM_BW", "HBM_PER_CHIP", "NET_BW", "NVLINK_BW", "PEAK_FLOPS_BF16",
           "make_debug_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False, group=None) -> Mesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``; ``ValueError`` unless ``group`` has 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, group)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"), group=None) -> Mesh:
    """A small mesh over ``prod(shape)`` ranks (tests, one card's ranks)."""
    return Mesh(shape, axes, group)


# NVIDIA H100 SXM5 80 GB at 700 W (spec sheet), per card
PEAK_FLOPS_BF16 = 989e12  # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # bytes/s
NVLINK_BW = 450e9  # bytes/s per direction (NVLink 4: 900 GB/s both ways)
NET_BW = 50e9  # bytes/s per card between nodes: one ConnectX-7 at 400 Gb/s (DGX H100 datasheet)
HBM_PER_CHIP = 80e9  # bytes
