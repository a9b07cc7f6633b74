"""Roofline terms of a dry-run cell on the H100 (PyTorch port of
``repro.launch.roofline``).

Three terms per (arch x shape x mesh), in seconds, per card:

    compute    = FLOPs / (cards x PEAK_FLOPS_BF16)
    memory     = HBM bytes per card / HBM_BW
    collective = wire bytes within a node / NVLINK_BW + across nodes / NET_BW

with the card's constants (``launch/mesh.py``).  ``Roofline`` and
``build_roofline`` keep ``repro``'s arithmetic: given ``repro``'s constants
(one link rate for both kinds of link) they give its numbers.

The collective bytes come from the rank's counted collectives
(``core.distributed.collective_stats``: every call of the step, by kind,
with its group's size and whether the group spans nodes), turned into bytes
on the wire per card by ``repro``'s per-algorithm factors (ring all-reduce
2(g-1)/g of its result, all-gather (g-1)/g, reduce-scatter g-1 times its
result).  ``repro``'s ``parse_collectives`` has no counterpart: torch
compiles no HLO to parse, and since every call is counted as it runs (each
microbatch, each layer) no loop hint multiplies anything.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.mesh import HBM_BW, NET_BW, NVLINK_BW, PEAK_FLOPS_BF16

# the port's counted kinds as repro's HLO collectives
_KIND = {"all_gather": "all-gather", "fsdp_gather": "all-gather", "psum": "all-reduce",
         "pmax": "all-reduce", "psum_scatter": "reduce-scatter"}

_WIRE_FACTOR = {
    # bytes-on-wire per device as a multiple of the RESULT shape bytes
    "all-gather": lambda g: (g - 1) / g,
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "reduce-scatter": lambda g: (g - 1),  # result is 1/g of operand
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}


def collective_totals(stats: dict) -> Dict[str, float]:
    """Wire bytes per card by ``repro``'s collective kind, from
    ``collective_stats()``; ``_net_bytes`` is the part over groups that span
    nodes and ``_n_calls`` the number of calls (keys with ``_`` are not bytes
    of a kind).  The counted bytes are an all-gather's result, an
    all-reduce's operand (= result) and a reduce-scatter's operand (g times
    its result)."""
    totals: Dict[str, float] = {}
    net, calls = 0.0, 0
    for kind, st in stats["kinds"].items():
        op = _KIND[kind]
        for grp in st["groups"]:
            g = grp["size"]
            result = grp["bytes"] / g if op == "reduce-scatter" else grp["bytes"]
            wire = _WIRE_FACTOR[op](g) * result
            totals[op] = totals.get(op, 0.0) + wire
            net += wire if grp["spans_nodes"] else 0.0
            calls += grp["calls"]
    totals["_net_bytes"] = net
    totals["_n_calls"] = calls
    return totals


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    ici_bytes_per_chip: float  # every wire byte
    n_chips: int
    net_bytes_per_chip: float = 0.0  # the part over groups that span nodes

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return ((self.ici_bytes_per_chip - self.net_bytes_per_chip) / NVLINK_BW
                + self.net_bytes_per_chip / NET_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self):
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "ici_bytes_per_chip": self.ici_bytes_per_chip,
            "net_bytes_per_chip": self.net_bytes_per_chip,
        }


def build_roofline(*, model_flops: float, hlo_bytes_per_chip: float,
                   collective_totals: Dict[str, float], n_chips: int,
                   analytic_flops: Optional[float] = None) -> Roofline:
    """Compute term uses max(analytic, model) flops distributed over chips -
    analytic counts attention; MODEL_FLOPS is the 6ND convention.  The
    collective term reads ``collective_totals``' bytes by kind, and its
    ``_net_bytes`` as the part across nodes (none when absent)."""
    flops = max(analytic_flops or 0.0, model_flops) / n_chips
    ici = sum(v for k, v in collective_totals.items() if not k.startswith("_"))
    return Roofline(flops, hlo_bytes_per_chip, ici, n_chips,
                    collective_totals.get("_net_bytes", 0.0))
