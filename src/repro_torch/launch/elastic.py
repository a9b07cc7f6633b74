"""Elastic scaling + failure handling (PyTorch port of ``repro.launch.elastic``,
copied exactly: pure Python).

Two mechanisms, both checkpoint-centric (the TPU-pod reality: failed chips
take down the whole slice, so recovery = reshard + restart, not in-place
repair):

1. ``reshard_plan`` - given a checkpoint manifest saved from an N-chip mesh
   and a new M-chip mesh, produce the chunk->host reassignment.  Because
   checkpoints store GLOBAL arrays as row-chunks (train/checkpoint.py), any
   mesh can restore any checkpoint: restore() concatenates chunks and jit
   re-shards on first use.  This function exists to make the data movement
   EXPLICIT and minimal for big tables (only rows whose owner changed).

2. ``shrink_mesh`` - degraded-capacity plan: drop failed hosts, build the
   largest (data', model) mesh from survivors, and return the new
   global-batch/accum settings that keep per-device shapes identical (so
   the compiled step is reusable when shapes allow).

Retrieval shards additionally re-replicate from manifest peers: each DB
shard is stored with replication factor r (default 2) so losing < r
consecutive hosts never loses index data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass
class ReshardMove:
    entry: str
    chunk_file: str
    src_host: int
    dst_host: int


def _owner(chunk_idx: int, n_chunks: int, n_hosts: int) -> int:
    return chunk_idx * n_hosts // max(n_chunks, 1)


def reshard_plan(manifest: Dict, n_hosts_old: int, n_hosts_new: int) -> List[ReshardMove]:
    """Chunks whose owning host changes when the host count changes."""
    moves = []
    for name, entry in manifest["entries"].items():
        chunks = entry["chunks"]
        n = len(chunks)
        for i, c in enumerate(chunks):
            src = _owner(i, n, n_hosts_old)
            dst = _owner(i, n, n_hosts_new)
            if src != dst:
                moves.append(ReshardMove(name, c["file"], src, dst))
    return moves


def shrink_mesh(n_devices: int, failed: int, *, model_axis: int = 16,
                global_batch: int = 256, accum: int = 1) -> Dict:
    """Largest viable (data, model) layout after ``failed`` devices drop.

    Keeps the model axis intact (TP groups cannot straddle failures) and
    shrinks the data axis; global batch is preserved by raising grad-accum
    so the OPTIMIZATION trajectory is unchanged (sync SGD semantics).
    """
    surviving = n_devices - failed
    data_axis = surviving // model_axis
    if data_axis < 1:
        raise ValueError("not enough devices to keep one model-parallel group")
    used = data_axis * model_axis
    # scale accumulation to preserve the global batch with fewer data shards
    old_data = n_devices // model_axis
    new_accum = accum
    while (global_batch % (new_accum * data_axis) != 0
           or global_batch // new_accum // data_axis
           > global_batch // accum // old_data):
        new_accum += accum
        if new_accum > global_batch:
            new_accum = accum
            break
    return {
        "mesh_shape": (data_axis, model_axis),
        "devices_used": used,
        "devices_idle": surviving - used,
        "accum_steps": new_accum,
        "per_device_batch": global_batch // new_accum // data_axis,
    }


@dataclasses.dataclass
class ShardReplicaMap:
    """Retrieval-index replication: shard s lives on hosts
    {s, (s+1) % H, ... (s+r-1) % H}; losing < r consecutive hosts keeps
    every shard recoverable."""

    n_shards: int
    replication: int = 2

    def hosts_for(self, shard: int, n_hosts: int) -> List[int]:
        return [(shard + i) % n_hosts for i in range(self.replication)]

    def recovery_sources(self, shard: int, n_hosts: int,
                         dead: Tuple[int, ...]) -> List[int]:
        return [h for h in self.hosts_for(shard, n_hosts) if h not in dead]

    def survives(self, n_hosts: int, dead: Tuple[int, ...]) -> bool:
        return all(self.recovery_sources(s, n_hosts, dead)
                   for s in range(self.n_shards))
