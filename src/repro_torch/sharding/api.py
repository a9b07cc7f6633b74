"""The device mesh over ``torch.distributed`` ranks and its collectives
(PyTorch port of ``repro.sharding.api``).

The local view.  ``repro`` writes every on-mesh path as an explicit
``shard_map`` region: the region takes global arrays and hands each device
its block by ``in_specs``.  In the port each rank holds only its blocks.
Under ``use_mesh(mesh)`` a region's entry point takes the rank's local
blocks of its inputs, laid out by ``repro``'s ``in_specs``, and returns the
rank's block of the output, laid out by ``out_specs``; a ``P()`` output is
the replicated value.  Outside the regions the dense layers run on
replicated weights, or on FSDP x TP blocks where the parameters carry their
specs (``models/transformer.py``): ``fsdp_gather`` all-gathers a block over
its data axes just before use, and its backward is the reduce-scatter of
the gradient.  ``shard(x, spec, mesh)`` takes a global tensor to this
rank's block and ``unshard(x_local, spec, mesh)`` all-gathers it back;
``local_shape`` and ``global_shape`` convert shapes.

A spec entry is None (the dim is whole on every rank), an axis name, or a
tuple of names; a dim over several axes is split row-major over them in the
entry's order, as ``jax.make_mesh`` and ``shard_map`` split it.

Gradients: the loss is replicated and counted once, so each rank's gradient
of a block is that block of the global gradient, and of a replicated tensor
the whole global gradient.
  - ``psum``: its output is used alike on every rank, so its backward is
    the identity (``torch.distributed.nn.functional.all_reduce`` sums in
    its backward, a gradient ``world`` times too large).
  - ``pmax``: the cotangent goes to the ranks that hold the maximum, split
    evenly among them.
  - ``all_gather``: the cotangent's block, or with ``varying=True`` (the
    gathered tensor's users differ by rank) its ``psum_scatter``.
  - ``psum_scatter``: the all-gather of the cotangents.
  - ``pvary``: the identity forward, a ``psum`` of the cotangent backward:
    it marks a tensor replicated over axes that enters rank-varying use
    (``shard_map`` transposes an input's unmentioned axes so).
  - ``shard``: the all-gather of the block cotangents; ``unshard``: the block.

Each collective, forward or backward, is one of ``core.distributed``'s
counted collectives over the mesh's subgroup for its axes, so it is counted
by kind with its bytes and timed there (``core.distributed.
collective_stats``).  NCCL gathers with ``all_gather_into_tensor`` and
scatters with ``reduce_scatter_tensor``; on gloo, decided by the backend, a
gather is ``all_gather`` into a list and a ``psum_scatter`` is composed (an
all-reduce, then the rank's block), counted under its own kind.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import distributed as cd

_STATE = threading.local()


class P(tuple):
    """A partition spec: a tuple of entries, each None, an axis name or a
    tuple of names (``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes(entry) -> tuple:
    """An entry (None, a name or a tuple of names) as a tuple of names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A (shape, axis_names) mesh over the ``prod(shape)`` ranks of ``group``
    (default: the default group).  A rank's coordinates are row-major over
    its group rank, as ``jax.make_mesh`` lays out devices.

    Every rank builds every subgroup it may reduce over, one per set of axes
    and coordinates of the other axes, with ``new_group`` in the same order.
    ``ValueError`` when the group's size is not ``prod(shape)``.
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], group=None):
        import torch.distributed as tdist

        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} do not match")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.size = math.prod(shape)
        world = tdist.get_world_size(group)
        if world != self.size:
            raise ValueError(f"a {shape} mesh needs {self.size} ranks, the group has {world}")
        self.group = group
        self.backend = str(tdist.get_backend(group))
        self.rank = tdist.get_rank(group)
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank, shape))
        globals_ = (tdist.get_process_group_ranks(group) if group is not None
                    else list(range(world)))
        grid = np.arange(self.size).reshape(shape)
        self._groups = {}  # frozenset(axes) -> (process group, member mesh ranks)
        self._orders = {}  # axes -> (process group, group rank of each block index)
        for n in range(1, len(axis_names) + 1):
            for subset in itertools.combinations(range(len(axis_names)), n):
                key = frozenset(axis_names[i] for i in subset)
                if n == len(axis_names):
                    self._groups[key] = (group, list(range(self.size)))
                    continue
                rest = [i for i in range(len(axis_names)) if i not in subset]
                for other in itertools.product(*(range(shape[i]) for i in rest)):
                    index = [slice(None)] * len(shape)
                    for i, c in zip(rest, other):
                        index[i] = c
                    members = sorted(int(r) for r in grid[tuple(index)].reshape(-1))
                    g = tdist.new_group([globals_[r] for r in members])
                    if self.rank in members:
                        self._groups[key] = (g, members)
        # a psum_scatter on gloo is an all-reduce and the rank's block; the
        # fake test backend takes NCCL's forms (core.distributed)
        self.composed = ({} if self.backend in ("nccl", "fake")
                         else {"psum_scatter": "all_reduce + the rank's block"})

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.backend})"

    def axis_index(self, axis: str) -> int:
        return self.coords[self.axis_names.index(axis)]

    def index(self, axes) -> int:
        """This rank's block index over ``axes``, row-major in their order."""
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.axis_index(a)
        return i

    def size_of(self, axes) -> int:
        return math.prod(self.shape[a] for a in _axes(axes))

    def _group(self, axes: tuple):
        """(process group, group rank of each block index over ``axes``)."""
        if axes not in self._orders:
            group, members = self._groups[frozenset(axes)]
            pos = [self.axis_names.index(a) for a in axes]
            dims = [self.shape[a] for a in axes]
            order = [0] * len(members)
            for g, r in enumerate(members):
                c = np.unravel_index(r, tuple(self.shape.values()))
                order[int(np.ravel_multi_index([c[p] for p in pos], dims))] = g
            self._orders[axes] = (group, order)
        return self._orders[axes]


def current_mesh() -> Optional[Mesh]:
    return getattr(_STATE, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Make ``mesh`` the current mesh: the regions below run on its ranks."""
    prev = getattr(_STATE, "mesh", None)
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def constrain(x, spec):
    """The identity on a local block (``repro``'s sharding annotation); a
    spec longer than the block's rank raises."""
    if current_mesh() is not None and len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the block's {x.ndim} dims")
    return x


def flatten(tree, prefix: str = "") -> dict:
    """A nested dict / list as {"a.b.0": leaf}: keys and list positions
    joined by dots (the port's parameter names); a ``P`` is a leaf."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def batch_axes() -> tuple:
    """The data-parallel axes present on the current mesh ('pod' optional)."""
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def has_axis(name: str) -> bool:
    mesh = current_mesh()
    return mesh is not None and name in mesh.axis_names


# ---------------------------------------------------------------------------
# communication over the mesh's subgroups
# ---------------------------------------------------------------------------


def _all_reduce(x, axes: tuple, mesh: Mesh, op: str = "sum"):
    group, _ = mesh._group(axes)
    return cd.all_reduce(x, op, group)


def _gather_blocks(x, axes: tuple, mesh: Mesh, kind: str = "all_gather") -> list:
    """Every rank's ``x`` over ``axes``, in block-index order."""
    group, order = mesh._group(axes)
    parts = cd.all_gather(x, group, kind)  # in group-rank order
    return [parts[g] for g in order]


def _block(x, axes: tuple, dim: int, mesh: Mesh):
    """This rank's block of ``x`` along ``dim``, split over ``axes``."""
    n = mesh.size_of(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {axes} ({n})")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * size, size)


def _reduce_scatter(x, axes: tuple, dim: int, mesh: Mesh):
    """The sum over ``axes`` of every rank's ``x``, this rank's block along ``dim``."""
    group, order = mesh._group(axes)
    n = len(order)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split over {axes} ({n})")
    blocks = x.chunk(n, dim)  # in block-index order
    by_rank = torch.stack([blocks[order.index(g)] for g in range(n)])
    return cd.reduce_scatter(by_rank, group)[0]


def _gather(x, axes: tuple, dim: int, tiled: bool, mesh: Mesh, kind: str = "all_gather"):
    parts = _gather_blocks(x, axes, mesh, kind)
    return torch.cat(parts, dim) if tiled else torch.stack(parts, dim)


# ---------------------------------------------------------------------------
# the collectives of a region (autograd Functions)
# ---------------------------------------------------------------------------


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        return _all_reduce(x, axes, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _PMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        y = _all_reduce(x, axes, mesh, op="max")
        ctx.save_for_backward(x, y)
        ctx.args = (axes, mesh)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        axes, mesh = ctx.args
        mask = (x == y).to(g.dtype)
        return g * mask / _all_reduce(mask, axes, mesh), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, tiled, varying, mesh, kind="all_gather"):
        ctx.args = (axes, dim, tiled, varying, mesh)
        return _gather(x, axes, dim, tiled, mesh, kind)

    @staticmethod
    def backward(ctx, g):
        axes, dim, tiled, varying, mesh = ctx.args
        if not tiled:  # the stacked dim holds one block per rank
            g = g.movedim(dim, 0)
        cut = dim if tiled else 0
        out = _reduce_scatter(g, axes, cut, mesh) if varying else _block(g, axes, cut, mesh)
        out = out if tiled else out.squeeze(0)
        return out.contiguous(), None, None, None, None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim, mesh):
        ctx.args = (axes, dim, mesh)
        return _reduce_scatter(x, axes, dim, mesh)

    @staticmethod
    def backward(ctx, g):
        axes, dim, mesh = ctx.args
        return _gather(g, axes, dim, True, mesh), None, None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, mesh):
        ctx.args = (axes, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axes, mesh = ctx.args
        return _all_reduce(g, axes, mesh), None, None


def _mesh(mesh):
    m = mesh if mesh is not None else current_mesh()
    if m is None:
        raise ValueError("no mesh: pass one or enter use_mesh(mesh)")
    return m


def psum(x, axes, mesh=None):
    """The sum of every rank's ``x`` over ``axes``, on every one of them."""
    axes = _axes(axes)
    return _PSum.apply(x, axes, _mesh(mesh)) if axes else x


def pmean(x, axes, mesh=None):
    axes = _axes(axes)
    return psum(x, axes, mesh) / _mesh(mesh).size_of(axes) if axes else x


def pmax(x, axes, mesh=None):
    """The elementwise maximum of every rank's ``x`` over ``axes``."""
    axes = _axes(axes)
    return _PMax.apply(x, axes, _mesh(mesh)) if axes else x


def all_gather(x, axes, dim: int = 0, tiled: bool = False, *, varying: bool = False,
               mesh=None):
    """Every rank's ``x`` over ``axes`` in block-index order: concatenated
    along ``dim`` (``tiled``) or stacked on a new ``dim``.  ``varying``: the
    result's users differ by rank, so the backward sums their cotangents."""
    axes = _axes(axes)
    if not axes:
        return x if tiled else x.unsqueeze(dim)
    return _AllGather.apply(x, axes, dim, tiled, varying, _mesh(mesh))


def psum_scatter(x, axes, dim: int = 0, mesh=None):
    """The sum of every rank's ``x`` over ``axes``, this rank's block along
    ``dim`` (tiled: ``x.shape[dim]`` splits into one block per rank, the
    only form a region calls)."""
    axes = _axes(axes)
    return _PsumScatter.apply(x, axes, dim, _mesh(mesh)) if axes else x


def pvary(x, axes, mesh=None):
    """``x``, replicated over ``axes``, entering rank-varying use: the
    backward sums the cotangents over ``axes``."""
    axes = _axes(axes)
    return _PVary.apply(x, axes, _mesh(mesh)) if axes else x


def spec_axes(spec) -> tuple:
    """Every axis that ``spec`` names, in its order."""
    return tuple(a for e in spec for a in _axes(e))


def fsdp_gather(w, spec, tp_axes=("model",), mesh=None):
    """The weight block ``w`` (laid out by ``spec``) whole along every dim
    split over axes other than ``tp_axes``: FSDP's all-gather just before
    use, whose backward is the reduce-scatter of the gradient over those
    axes (the gathered weight is used with each rank's own batch block).
    A data axis of the mesh that ``spec`` does not name is one the weight is
    replicated over and used on rank-varying data: it is ``pvary``ed, so
    its gradient sums there too.  The dims over ``tp_axes`` stay this
    rank's blocks; a dim split over both kinds raises."""
    mesh = _mesh(mesh)
    tp_axes = tuple(tp_axes or ())
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        fsdp = tuple(a for a in axes if a not in tp_axes)
        if fsdp and len(fsdp) != len(axes):
            raise ValueError(f"dim {dim} of spec {spec} is split over both FSDP and TP axes")
        if fsdp:  # counted as "fsdp_gather"
            w = _AllGather.apply(w, fsdp, dim, True, True, mesh, "fsdp_gather")
    named = spec_axes(spec)
    rest = tuple(a for a in ("pod", "data") if a in mesh.axis_names and a not in named)
    return pvary(w, rest, mesh)


# ---------------------------------------------------------------------------
# global <-> local
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh) -> tuple:
    """This rank's block shape of a global ``shape`` under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = mesh.size_of(_axes(entry))
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {entry} ({n})")
        out[dim] //= n
    return tuple(out)


def global_shape(shape, spec, mesh) -> tuple:
    """The global shape whose block under ``spec`` has ``shape``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] *= mesh.size_of(_axes(entry))
    return tuple(out)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.args = (spec, mesh)
        for dim, entry in enumerate(spec):
            if _axes(entry):
                x = _block(x, _axes(entry), dim, mesh)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        spec, mesh = ctx.args
        for dim, entry in enumerate(spec):
            if _axes(entry):
                g = _gather(g, _axes(entry), dim, True, mesh)
        return g, None, None


def _check_spec(x, spec, mesh: Mesh):
    if len(spec) > x.ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {x.ndim} dims")
    used = [a for e in spec for a in _axes(e)]
    if len(set(used)) != len(used) or not set(used) <= set(mesh.axis_names):
        raise ValueError(f"spec {spec} names an axis twice or one the mesh lacks "
                         f"({mesh.axis_names})")


def shard(x, spec, mesh=None):
    """This rank's block of the global tensor ``x`` under ``spec``."""
    mesh = _mesh(mesh)
    _check_spec(x, spec, mesh)
    return _Shard.apply(x, tuple(spec), mesh)


def unshard(x_local, spec, mesh=None):
    """The global tensor whose block under ``spec`` this rank holds."""
    mesh = _mesh(mesh)
    _check_spec(x_local, spec, mesh)
    for dim, entry in enumerate(spec):
        if _axes(entry):
            x_local = all_gather(x_local, _axes(entry), dim, tiled=True, mesh=mesh)
    return x_local
