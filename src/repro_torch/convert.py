"""Carry an index built by the JAX package across to the port.

``arrays`` holds numpy ``X`` (n, m), ``neighbors`` (n, M) and ``entries`` (E,),
taken with ``np.asarray`` from a ``repro`` ``ANNIndex``; ``spec_dict`` is its
``spec.to_dict()``.  Nothing here imports JAX: the caller hands over plain
arrays, as a model's weights would be handed over.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.index import ANNIndex, bind_policies, check_supported, make_build_info
from repro_torch.core.spec import RetrievalSpec


def index_from_jax(arrays: dict, spec_dict: dict, device="cuda") -> ANNIndex:
    """The port's ``ANNIndex`` over the JAX-built graph, on ``device``."""
    dev = resolve_device(device)
    spec = RetrievalSpec.from_dict(spec_dict)
    check_supported(spec)
    def tensor(name, dtype):
        # np.array copies: arrays taken from JAX are read-only buffers
        return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)

    X = tensor("X", np.float32)
    neighbors = tensor("neighbors", np.int32)
    entries = tensor("entries", np.int32)
    if neighbors.shape[0] != X.shape[0]:
        raise ValueError(f"neighbors has {neighbors.shape[0]} rows, X has {X.shape[0]}")
    dist = spec.base_distance()
    build_policy, search_policy, build_dist, search_dist = bind_policies(spec, dist, X)
    degrees = (neighbors >= 0).sum(dim=1, dtype=torch.int32)
    return ANNIndex(
        X=X,
        neighbors=neighbors,
        dist=dist,
        search_dist=search_dist,
        query_sym=str(spec.search_policy),
        entries=entries,
        build_info=make_build_info(spec, degrees, build_policy, search_policy),
        build_dist=build_dist,
        spec=spec,
    )
