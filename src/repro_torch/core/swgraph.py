"""SW-graph construction (Malkov et al. 2014), the paper's index: the
sequential reference builder (PyTorch port of ``repro.core.swgraph``).

Point i is inserted by a beam search (efConstruction) over the graph of
points 0..i-1 under the build distance, then linked both ways to the NN
nearest points found.  Node degree is capped at M_max with farthest-edge
eviction, so the adjacency stays a static (n, M_max) array.  The slot of
node j holding neighbor t stores d_build(x_t, x_j), the left-query distance
of the neighbor towards the owner.

This builder is the reference: ``build_engine.build_swgraph_wave`` at W=1
must give the same adjacency.  It is a serial chain of n - 1 searches, so it
runs on the card only at small n.
"""

from __future__ import annotations

import torch

from repro_torch.core.beam_search import beam_search_impl
from repro_torch.core.distances import tree_map
from repro_torch.kernels.ops import gathered_scores, prepped

INF = float("inf")


def build_swgraph(dist, X, NN: int = 15, ef_construction: int = 100,
                  M_max: int | None = None):
    """Build an SW-graph over X under ``dist``.

    Returns ``(neighbors (n, M_max) int32, degrees (n,) int32)`` on X's device.
    """
    if M_max is None:
        M_max = 2 * NN
    if M_max < NN:
        raise ValueError(f"M_max {M_max} < NN {NN}")
    n = X.shape[0]
    dev = X.device
    consts = prepped(dist.prep_scan(X))
    qc_all = prepped(dist.prep_queries(X))
    ef = max(ef_construction, NN)

    # row n is a sentinel that absorbs the writes of invalid reverse edges
    adj = torch.full((n + 1, M_max), -1, dtype=torch.int32, device=dev)
    adj_d = torch.full((n + 1, M_max), INF, dtype=torch.float32, device=dev)
    sentinel = torch.tensor(n, device=dev)
    for i in range(1, n):
        qc = tree_map(lambda a: a[i:i + 1], qc_all)
        st = beam_search_impl(adj[:n], consts, qc, dist, 0, ef, n_active=i)
        ids = st.beam_i[0, :NN]
        ds = st.beam_d[0, :NN]
        valid = (ids >= 0) & torch.isfinite(ds)

        # forward edges: i -> ids, slot distance d_build(x_t, x_i) = ds
        adj[i, :NN] = torch.where(valid, ids, -1)
        adj_d[i, :NN] = torch.where(valid, ds, INF)

        # reverse edges: insert i into each neighbor j's list, evicting the
        # farthest.  The beam's ids are distinct, so each row j takes at
        # most one update and the JAX package's serial loop over t is one
        # vectorized step here.
        j_safe = torch.where(valid, ids, 0).long()
        # d_build(x_i, x_j): i is the candidate (left), j the owner (query side)
        qc_j = tree_map(lambda a: a[j_safe], qc_all)
        d_ij = gathered_scores(dist, torch.full_like(ids, i)[:, None], qc_j, consts)[:, 0]
        rows_d = adj_d[j_safe]
        slot = torch.argmax(rows_d, dim=1)  # free slots are +inf -> the first chosen
        do = valid & (d_ij < rows_d.gather(1, slot[:, None])[:, 0])
        j_w = torch.where(do, j_safe, sentinel)
        adj[j_w, slot] = i
        adj_d[j_w, slot] = d_ij
    adj = adj[:n].contiguous()
    degrees = (adj >= 0).sum(dim=1, dtype=torch.int32)
    return adj, degrees
