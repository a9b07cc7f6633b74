"""Carry an index built by the JAX package across to the port.

``index_from_jax`` takes numpy ``X`` (n, m), ``neighbors`` (n, M) and
``entries`` (E,), taken with ``np.asarray`` from a ``repro`` ``ANNIndex``;
``online_from_jax`` takes the state of a ``repro`` ``OnlineIndex``, mid-churn
if need be; ``shard_from_jax`` takes ``repro``'s sharded state (the rows and
``build_local_subgraphs``' padded local adjacency) and returns one rank's
block.  ``spec_dict`` is the index's ``spec.to_dict()``.
``recsys_params_from_jax`` loads ``repro``'s recsys param dict (any
interaction) into the port's module, ``lm_params_from_jax`` its LM's stacked
params (dense or MoE), ``gnn_params_from_jax`` its GCN's, and
``mahalanobis_from_jax`` takes a fitted map; ``shard_tree`` cuts any of
these trees to one rank's blocks of a mesh.  Nothing here imports JAX: the
caller hands over plain arrays, as a model's weights would be handed over.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.distributed import local_block
from repro_torch.core.index import ANNIndex, bind_policies, make_build_info
from repro_torch.core.online import OnlineIndex
from repro_torch.core.spec import RetrievalSpec
from repro_torch.sharding.api import P, flatten, shard


def _tensor(arrays, name, dtype, dev):
    # np.array copies: arrays taken from JAX are read-only buffers
    return torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)


def index_from_jax(arrays: dict, spec_dict: dict, device="cuda") -> ANNIndex:
    """The port's ``ANNIndex`` over the JAX-built graph, on ``device``; mutable
    (with fresh online state) when the spec has a ``capacity``, as ``build``."""
    dev = resolve_device(device)
    spec = RetrievalSpec.from_dict(spec_dict)
    X = _tensor(arrays, "X", np.float32, dev)
    neighbors = _tensor(arrays, "neighbors", np.int32, dev)
    entries = _tensor(arrays, "entries", np.int32, dev)
    if neighbors.shape[0] != X.shape[0]:
        raise ValueError(f"neighbors has {neighbors.shape[0]} rows, X has {X.shape[0]}")
    dist = spec.base_distance()
    build_policy, search_policy, build_dist, search_dist = bind_policies(spec, dist, X)
    degrees = (neighbors >= 0).sum(dim=1, dtype=torch.int32)
    idx = ANNIndex(
        X=X,
        neighbors=neighbors,
        dist=dist,
        search_dist=search_dist,
        query_sym=str(spec.search_policy),
        entries=entries,
        build_info=make_build_info(spec, degrees, build_policy, search_policy),
        build_dist=build_dist,
        capacity=spec.capacity,
        spec=spec,
    )
    if spec.capacity is not None:
        idx.ensure_online()
    return idx


def online_from_jax(arrays: dict, spec_dict: dict, device="cuda") -> OnlineIndex:
    """The port's ``OnlineIndex`` holding a ``repro`` ``OnlineIndex``'s state, on ``device``.

    ``arrays`` holds numpy ``X`` (capacity, m), ``adj`` and ``adj_d``
    (capacity, M), ``alive`` (capacity,), ``entries`` (E,) and
    ``killed_epoch`` (capacity,), and the host state ``n_total``, ``free``
    (the free list, oldest first) and ``mutation_epoch``.  Optional:
    ``repair_pending`` and ``compact_dirty`` (a partly drained
    ``compact_slice``) and ``rng_state`` (``_rng.bit_generator.state``, so
    the entry refresh draws what ``repro``'s would).  The knobs are those
    ``ANNIndex.ensure_online`` gives for the spec.  A data-calibrated policy
    parameter resolves against the live rows.
    """
    dev = resolve_device(device)
    spec = RetrievalSpec.from_dict(spec_dict)
    X = _tensor(arrays, "X", np.float32, dev)
    alive = _tensor(arrays, "alive", bool, dev)
    dist = spec.base_distance()
    _, _, build_dist, search_dist = bind_policies(spec, dist, X[alive])
    # ensure_online's wave: the build's wave for a SW-graph wave build, else 32
    wave = spec.wave if (spec.builder, spec.build_engine) == ("swgraph", "wave") else 32
    o = OnlineIndex(
        X, _tensor(arrays, "adj", np.int32, dev), _tensor(arrays, "adj_d", np.float32, dev),
        alive, int(arrays["n_total"]), build_dist, search_dist,
        np.asarray(arrays["entries"], np.int32),
        NN=spec.NN, ef_construction=spec.ef_construction, wave=wave, spec=spec)
    o._free = [int(i) for i in arrays["free"]]
    o.killed_epoch = np.array(arrays["killed_epoch"], np.int64)
    o.mutation_epoch = int(arrays["mutation_epoch"])
    o._repair_pending = collections.deque(int(u) for u in arrays.get("repair_pending", ()))
    o._compact_dirty = bool(arrays.get("compact_dirty", False))
    if "rng_state" in arrays:
        o._rng.bit_generator.state = arrays["rng_state"]
    return o


class ShardBlock(NamedTuple):
    """One rank's block of a sharded index."""

    X: torch.Tensor  # (n_local, m) float32: the shard's rows of the padded layout
    neighbors: torch.Tensor  # (n_local, M) int32 adjacency in LOCAL row ids, -1 padding
    n_real: int  # rows of the corpus before padding
    n_local: int  # rows per shard


def shard_from_jax(arrays: dict, shard: int, n_shards: int, device="cuda") -> ShardBlock:
    """Rank ``shard``'s block of a ``repro`` sharded index, on ``device``.

    ``arrays`` holds numpy ``X`` (n, m), the corpus before padding, and
    ``neighbors`` (n_pad, M), ``repro.core.distributed.build_local_subgraphs``'
    adjacency over ``n_shards`` shards of the padded layout (``pad_to_shards``:
    n_pad = n_shards * ceil(n / n_shards), local row ids).  ``ValueError``
    when the shapes or ids do not fit that layout.
    """
    dev = resolve_device(device)
    X = _tensor(arrays, "X", np.float32, "cpu")
    nbrs = np.asarray(arrays["neighbors"])
    n = X.shape[0]
    n_local = -(-n // n_shards)
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    if nbrs.ndim != 2 or nbrs.shape[0] != n_local * n_shards:
        raise ValueError(f"neighbors has shape {nbrs.shape}; {n} rows over {n_shards} shards "
                         f"pad to {n_local * n_shards}")
    if nbrs.min() < -1 or nbrs.max() >= n_local:
        raise ValueError(f"neighbors holds ids outside [-1, {n_local}): not local row ids")
    X_local, n_real, _ = local_block(X, shard, n_shards)
    block = nbrs[shard * n_local:(shard + 1) * n_local]
    return ShardBlock(X_local.to(dev), torch.from_numpy(np.array(block, np.int32)).to(dev),
                      n_real, n_local)


def shard_tree(tree, specs, mesh):
    """This rank's blocks of a carried-across parameter tree: ``tree`` a
    nested dict / list of tensors or numpy arrays, ``specs`` the matching
    tree of ``P`` (``param_specs``' layout), ``mesh`` the ranks' mesh.  The
    blocks keep the leaves' dtypes, on the leaves' devices."""
    if isinstance(specs, P):
        t = tree if isinstance(tree, torch.Tensor) else _from_np(tree)
        with torch.no_grad():
            return shard(t, specs, mesh)
    if isinstance(specs, dict):
        return {k: shard_tree(tree[k], v, mesh) for k, v in specs.items()}
    return [shard_tree(t, s, mesh) for t, s in zip(tree, specs)]


def recsys_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's recsys model (any interaction) holding ``repro``'s params,
    on ``device``.

    ``params_np`` is ``repro.models.recsys.init_params``' dict as numpy arrays:
    ``table`` (padded rows, d) and the interaction's layers: ``user_tower`` /
    ``item_tower`` and ``att_mlp`` / ``head``, each ``{"w": [(d_in, d_out),
    ...], "b": [(d_out,), ...]}``; ``attn``, a list of ``{"wq", "wk", "wv",
    "wres"}``; ``cross``, a list of ``{"w", "b"}``.  ``ValueError`` when a
    name or shape differs from what ``cfg`` gives.
    """
    from repro_torch.models.recsys import init_params

    model = init_params(cfg, device=device)
    arrays = flatten(params_np)
    params = dict(model.named_parameters())
    if set(arrays) != set(params):
        raise ValueError(f"param names {sorted(arrays)} differ from the model's {sorted(params)}")
    # np.array copies: arrays taken from JAX are read-only buffers
    arrays = {name: np.array(a, dtype=np.float32) for name, a in arrays.items()}
    with torch.no_grad():
        for name, p in params.items():
            if arrays[name].shape != tuple(p.shape):
                raise ValueError(f"{name}: shape {arrays[name].shape}, the model's "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(arrays[name]))
    return model


def mahalanobis_from_jax(L, device="cuda") -> torch.Tensor:
    """A fitted Mahalanobis map (``repro.core.metric_learning.fit_mahalanobis_map``'s
    (m, rank) array) as a float32 tensor on ``device``."""
    return torch.from_numpy(np.array(L, dtype=np.float32)).to(resolve_device(device))


def _from_np(a) -> torch.Tensor:
    """A numpy array (float32, or ``ml_dtypes.bfloat16`` as JAX hands bf16
    over, which ``torch.from_numpy`` rejects) as a writable CPU tensor."""
    a = np.array(a)  # a copy: arrays taken from JAX are read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's ``LMParams`` holding ``repro``'s LM params (dense or MoE), on
    ``device``.

    ``params_np`` is ``repro.models.transformer.init_params``' dict as numpy
    arrays: ``embed``, ``ln_f``, ``layers`` (stacked (L, ...) arrays; an MoE
    model's ``router`` in float32) and ``lm_head`` when untied.
    ``ValueError`` when a name, shape or dtype differs from what ``cfg`` gives.
    """
    from repro_torch.models.transformer import LMParams, _dt, layer_shapes

    dev = resolve_device(device)
    d, V = cfg.d_model, cfg.vocab_size
    want = {"embed": ((V, d), _dt(cfg)), "ln_f": ((d,), _dt(cfg)),
            **{f"layers.{k}": v for k, v in layer_shapes(cfg).items()}}
    if not cfg.tie_embeddings:
        want["lm_head"] = ((d, V), _dt(cfg))
    arrays = {k: v for k, v in params_np.items() if k != "layers"}
    arrays.update({f"layers.{k}": v for k, v in params_np.get("layers", {}).items()})
    if set(arrays) != set(want):
        raise ValueError(f"param names {sorted(arrays)} differ from the model's {sorted(want)}")
    tensors = {}
    for name, (shape, dt) in want.items():
        t = _from_np(arrays[name])
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, the model's {shape} {dt}")
        tensors[name] = t.to(dev)
    layers = {k.removeprefix("layers."): t for k, t in tensors.items() if k.startswith("layers.")}
    return LMParams(tensors["embed"], tensors["ln_f"], layers, tensors.get("lm_head"))


def gnn_params_from_jax(params_np: dict, cfg, device="cuda"):
    """The port's GCN holding ``repro``'s params, on ``device``.

    ``params_np`` is ``repro.models.gnn.init_params``' dict as numpy arrays:
    ``{"w": [(d_in, d_out), ...], "b": [(d_out,), ...]}``.  ``ValueError``
    when the layer count or a shape differs from what ``cfg`` gives.
    """
    from repro_torch.models.gnn import GCNParams, layer_dims

    dims = layer_dims(cfg)
    ws, bs = list(params_np["w"]), list(params_np["b"])
    if len(ws) != cfg.n_layers or len(bs) != cfg.n_layers:
        raise ValueError(f"{len(ws)} weights and {len(bs)} biases, the model has "
                         f"{cfg.n_layers} layers")
    for i, (w, b) in enumerate(zip(ws, bs)):
        if np.shape(w) != (dims[i], dims[i + 1]) or np.shape(b) != (dims[i + 1],):
            raise ValueError(f"layer {i}: w {np.shape(w)}, b {np.shape(b)}, the model's "
                             f"({dims[i]}, {dims[i + 1]}) and ({dims[i + 1]},)")
    dev = resolve_device(device)
    # np.array copies: arrays taken from JAX are read-only buffers
    return GCNParams([torch.from_numpy(np.array(w, np.float32)) for w in ws],
                     [torch.from_numpy(np.array(b, np.float32)) for b in bs], dev)
