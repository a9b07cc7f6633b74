"""GCN (Kipf & Welling 2017) by edge-list message passing (PyTorch port of
``repro.models.gnn``).

The normalized adjacency product ``A_hat @ X`` is an edge gather followed by
a segment sum over the receivers: ``x[senders]`` and ``index_add_`` (the
counterpart of ``jax.ops.segment_sum``); ``max`` aggregation is
``scatter_reduce_`` with ``amax``.  Degrees are ``index_add_``s of ones.
Under the ``sym`` norm the gathered (E, d) message block is scaled in
place, so it exists once: on ogb-products' shape (64.3 M edges with the
self loops, d = 100) it is 25.7 GB in float32.  On the card ``index_add_`` adds with
atomics, so its sums are not in edge order: the card and the CPU agree to
float32 rounding, not bit for bit.

Also the fanout neighbour sampler (minibatch_lg: 1,024 seed nodes, fanouts
15 and 10): ``build_csr``'s fixed-width neighbour table, ``sample_subgraph``
and ``sampled_forward``.  Picks come from a ``torch.Generator``; ``picks=``
replays given ones (``jax.random`` cannot be replayed).

The parameters mirror ``repro``'s dict as module attributes ``w.<i>`` and
``b.<i>`` (``convert.gnn_params_from_jax``), drawn on the CPU and then moved.

Edge-sharded (``forward(edge_sharded=True)`` under a mesh, the local view of
``sharding/api.py``): each rank holds its slice of the edge list, self loops
included, over the data axes, and the node features and weights whole.  It
``index_add_``s its messages, and its in- and out-degrees, into full (n, .)
tensors, and one ``psum`` over those axes follows each (``segment_sum`` is
linear, so this is ``repro``'s math); ``max`` takes a ``pmax``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import GNNConfig
from repro_torch.models.layers import dense_init
from repro_torch.sharding.api import P, batch_axes, pmax, psum, pvary


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def layer_dims(cfg: GNNConfig) -> list:
    return [cfg.d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]


class GCNParams(nn.Module):
    """Per layer a weight ``w.<i>`` (d_in, d_out) and a bias ``b.<i>``, float32."""

    def __init__(self, weights, biases, device):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w.to(device)) for w in weights])
        self.b = nn.ParameterList([nn.Parameter(b.to(device)) for b in biases])


def init_params(cfg: GNNConfig, generator=None, device="cuda") -> GCNParams:
    """``repro``'s scales (weights N(0, 1) / sqrt(d_in), zero biases), drawn on
    the CPU from ``generator`` (default: seed 0) and moved to ``device``."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    dims = layer_dims(cfg)
    return GCNParams([dense_init(gen, dims[i], dims[i + 1]) for i in range(cfg.n_layers)],
                     [torch.zeros(dims[i + 1]) for i in range(cfg.n_layers)], dev)


def param_specs(cfg: GNNConfig, fsdp_axis="data", tp_axis="model"):
    """The GCN's weights are tiny (1433 x 16 + 16 x 7 on Cora): replicated."""
    return {"w": [P(None, None) for _ in range(cfg.n_layers)],
            "b": [P(None) for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------------------
# message passing
# ---------------------------------------------------------------------------


def _counts(index, n: int):
    """How often each of 0..n-1 occurs in ``index``, float32 (exact below
    2**24).  An ``index_add_`` of ones: unlike ``bincount`` it reads no
    maximum back to the host, so the host does not wait for the card."""
    ones = torch.ones(index.shape[0], dtype=torch.float32, device=index.device)
    return torch.zeros(n, dtype=torch.float32, device=index.device).index_add_(0, index, ones)


def _degree(receivers, senders, n_nodes: int, axes=()):
    """In- and out-degree, float32 (exact counts), summed over ``axes``."""
    return psum(_counts(receivers, n_nodes), axes), psum(_counts(senders, n_nodes), axes)


def _segment_sum(msgs, segments, n: int):
    out = torch.zeros((n,) + tuple(msgs.shape[1:]), dtype=msgs.dtype, device=msgs.device)
    return out.index_add_(0, segments, msgs)


def gcn_aggregate(x, senders, receivers, n_nodes: int, norm: str = "sym",
                  aggregator: str = "mean", *, axes=()):
    """One round of (normalized) neighbourhood aggregation.

    x: (n, d); senders / receivers: (E,) integer.  Self loops are the
    caller's choice (``forward`` adds them).  ``sym``: each message scaled by
    deg_out(s)^-1/2 deg_in(r)^-1/2 and summed; else ``mean`` (the sum over
    max(deg_in, 1)), ``max`` (0 for a node without in-edges) or ``sum``.
    ``axes``: the mesh axes the edges are split over; every partial sum is
    ``psum``med over them and the max ``pmax``ed (``x`` is replicated there).
    """
    senders, receivers = senders.long(), receivers.long()
    x = pvary(x, axes)  # replicated, gathered at this rank's edges
    if norm == "sym":
        deg_in, deg_out = _degree(receivers, senders, n_nodes, axes)
        scale = torch.rsqrt(deg_out.clamp(min=1.0))[senders] * torch.rsqrt(
            deg_in.clamp(min=1.0))[receivers]
        # in place: the gathered block is the largest tensor of the pass
        return psum(_segment_sum(x[senders].mul_(scale[:, None]), receivers, n_nodes), axes)
    if aggregator == "mean":
        deg_in, _ = _degree(receivers, senders, n_nodes, axes)
        s = psum(_segment_sum(x[senders], receivers, n_nodes), axes)
        return s / deg_in.clamp(min=1.0)[:, None]
    if aggregator == "max":
        # seeded at -inf (never a finite maximum's tie): a node without
        # in-edges stays -inf through the pmax and becomes 0
        index = receivers[:, None].expand(-1, x.shape[1])
        agg = torch.full((n_nodes, x.shape[1]), -torch.inf, dtype=x.dtype, device=x.device)
        agg = pmax(agg.scatter_reduce(0, index, x[senders], "amax"), axes)
        return torch.where(torch.isfinite(agg), agg, 0.0)
    return psum(_segment_sum(x[senders], receivers, n_nodes), axes)


def _with_self_loops(senders, receivers, n: int):
    loops = torch.arange(n, device=senders.device)
    return torch.cat([senders.long(), loops]), torch.cat([receivers.long(), loops])


def _layers(params: GCNParams, x, senders, receivers, n: int, cfg: GNNConfig, axes=()):
    last = len(params.w) - 1
    for i, (w, b) in enumerate(zip(params.w, params.b)):
        x = gcn_aggregate(x, senders, receivers, n, norm=cfg.norm, aggregator=cfg.aggregator,
                          axes=axes)
        x = x @ w + b
        if i < last:
            x = torch.relu(x)
    return x


def _nll(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def forward(params: GCNParams, graph: dict, cfg: GNNConfig, *, edge_sharded: bool = False):
    """Full-batch GCN forward over ``graph`` (``features`` (n, d_feat),
    ``senders``, ``receivers``): node logits (n, n_classes).

    ``edge_sharded`` under a mesh: ``senders`` and ``receivers`` are this
    rank's slice over the data axes of the edge list with the self loops
    appended (``repro`` appends them, then shards the whole list), and the
    logits are replicated."""
    x = graph["features"]
    n = x.shape[0]
    axes = batch_axes() if edge_sharded else ()
    if axes:
        senders, receivers = graph["senders"].long(), graph["receivers"].long()
    else:
        senders, receivers = _with_self_loops(graph["senders"], graph["receivers"], n)
    return _layers(params, x, senders, receivers, n, cfg, axes)


def loss_fn(params: GCNParams, graph: dict, cfg: GNNConfig, mask=None, **kw):
    """Mean node cross-entropy against ``graph["labels"]``; with ``mask``, the
    masked mean (over max(sum(mask), 1))."""
    nll = _nll(forward(params, graph, cfg, **kw), graph["labels"])
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def graph_classify_loss(params: GCNParams, batch: dict, cfg: GNNConfig):
    """Batched small graphs: a block-diagonal edge list over the flat node
    array, a segment-mean readout per ``graph_ids``, the per-graph
    cross-entropy.  Returns (loss, {"nll": loss})."""
    x = batch["features"]
    n = x.shape[0]
    senders, receivers = _with_self_loops(batch["senders"], batch["receivers"], n)
    x = _layers(params, x, senders, receivers, n, cfg)
    n_graphs = batch["graph_labels"].shape[0]
    graph_ids = batch["graph_ids"].long()
    pooled = _segment_sum(x, graph_ids, n_graphs)
    counts = _segment_sum(torch.ones((n,), dtype=x.dtype, device=x.device), graph_ids, n_graphs)
    pooled = pooled / torch.clamp(counts, min=1.0)[:, None]
    loss = torch.mean(_nll(pooled, batch["graph_labels"]))
    return loss, {"nll": loss.detach()}


# ---------------------------------------------------------------------------
# fanout neighbour sampler (minibatch_lg: batch_nodes=1024, fanout 15-10)
# ---------------------------------------------------------------------------


def build_csr(senders, receivers, n_nodes: int, max_degree: int):
    """Fixed-width in-neighbour table (n, max_degree), -1 padded, in the
    senders' dtype: row r holds r's first ``max_degree`` senders in edge order
    (a stable sort by receiver).

    ``repro`` writes every entry past the width as -1 into the last column,
    so a node with in-degree above ``max_degree`` loses its last kept
    neighbour there (the -1 lands last on its CPU path; ROADMAP §3).  The
    port writes that -1 explicitly, so the table does not depend on the
    order in which duplicate writes land.
    """
    r = receivers.long()
    order = torch.argsort(r, stable=True)
    s_sorted, r_sorted = senders[order], r[order]
    starts = torch.searchsorted(r_sorted, torch.arange(n_nodes, device=r.device))
    rank = torch.arange(r_sorted.shape[0], device=r.device) - starts[r_sorted]
    keep = rank < max_degree
    table = torch.full((n_nodes, max_degree), -1, dtype=senders.dtype, device=senders.device)
    table[r_sorted[keep], rank[keep]] = s_sorted[keep]
    table[_counts(r, n_nodes) > max_degree, max_degree - 1] = -1
    return table


def sample_subgraph(generator, table, seed_nodes, fanouts, *, picks=None) -> dict:
    """Layered fanout sampling.  Hop h draws ``fanouts[h]`` columns of each
    frontier node's table row (uniform over the whole width, pads included)
    from ``generator`` (default: seed 0 on the table's device), or takes
    ``picks[h]`` ((frontier, fanout) column ids); a pad becomes a self edge.

    Returns ``nodes`` (the seeds, then each hop's sampled senders),
    ``senders`` and ``receivers`` (global node ids, hop by hop).
    """
    gen = generator
    if gen is None and picks is None:
        gen = torch.Generator(device=table.device).manual_seed(0)
    layers = [seed_nodes]
    edges_s, edges_r = [], []
    frontier = seed_nodes
    for hop, fan in enumerate(fanouts):
        nbrs = table[frontier.long()]  # (f, max_degree)
        if picks is not None:
            pick = picks[hop].to(table.device).long()
        else:
            pick = torch.randint(0, nbrs.shape[1], (frontier.shape[0], fan), generator=gen,
                                 device=table.device)
        src = torch.gather(nbrs, 1, pick).reshape(-1)
        dst = torch.repeat_interleave(frontier, fan)
        src = torch.where(src >= 0, src, dst)  # self edge for a pad
        edges_s.append(src)
        edges_r.append(dst)
        frontier = src
        layers.append(src)
    return {"nodes": torch.cat(layers), "senders": torch.cat(edges_s),
            "receivers": torch.cat(edges_r)}


def sampled_forward(params: GCNParams, features, labels, sub: dict, cfg: GNNConfig,
                    n_seed: int, *, edge_sharded: bool = False):
    """GCN forward over a sampled subgraph in the global node-id space (no
    self loops: the sampled edges only).  Returns (mean cross-entropy of the
    seed nodes, their logits (n_seed, n_classes)).  ``edge_sharded`` under a
    mesh: ``sub``'s ``senders`` and ``receivers`` are this rank's slice of the
    sampled edges over the data axes (``forward``'s edge-sharded sums)."""
    n = features.shape[0]
    axes = batch_axes() if edge_sharded else ()
    x = _layers(params, features, sub["senders"], sub["receivers"], n, cfg, axes)
    seed = sub["nodes"][:n_seed].long()
    logits = x[seed]
    return torch.mean(_nll(logits, labels[seed])), logits
