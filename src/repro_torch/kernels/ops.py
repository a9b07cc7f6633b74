"""Dispatch between the CUDA kernels and their plain PyTorch versions.

The rule is the tensor's device, nothing else: a CUDA tensor launches the
kernel (or the kernel wrapper raises), a CPU tensor takes the plain version.
There is no fallback from one to the other.  A meta tensor (the dry run's
counting pass, shapes without data) takes the plain version's shapes.

Two levels.  ``distance_matrix_branch``, ``pair_scores``,
``frontier_gather_scores`` and ``nndescent_round_scores`` score ONE
matmul-form branch (a ``Distance``, or a ``Branch`` with prepped reps).
``query_distance_matrix``, ``gathered_scores``, ``row_scores`` and
``round_scores`` take ANY distance, the symmetrized, combined, learned and
viewed wrappers included: they lower it to its branches (``dist.branches``),
launch the branch's kernel once per branch and combine the outputs in place
into the first branch's (``dist.combine_``).  A CUDA tensor therefore never
meets a plain version, whatever the distance.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.distance_matrix import distance_matrix
from repro_torch.kernels.frontier_gather import frontier_scores, two_hop_scores
from repro_torch.kernels.gather_topk import gather_scores
from repro_torch.kernels.ref import distance_matrix_ref, gather_scores_ref, two_hop_scores_ref


def _device_type(t) -> str:
    if t.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no kernel path for device {t.device}")
    return t.device.type


def prepped(tree):
    """Prepped constants (``prep_scan`` / ``prep_queries``) with every tensor
    contiguous, as the kernels read them."""
    # core imports stay inside the functions: the core package imports the kernels
    from repro_torch.core.distances import tree_map

    return tree_map(lambda a: a.contiguous(), tree)


def _branches(dist, consts, qc):
    """(branch, x, q) for every matmul-form branch of ``dist``."""
    return zip(dist.branches, dist.branch_reps(consts), dist.branch_reps(qc))


# ---------------------------------------------------------------------------
# one branch
# ---------------------------------------------------------------------------


def distance_matrix_branch(dist, q_rep, x_rep, q_bias, x_bias):
    """(B, N) left-query distances of one branch from prepped reps: the
    tensor-core ``distance_matrix`` on the card, its plain version (the
    matmul and the post-combine, in the JAX package's bias order) on the CPU."""
    q_rep, x_rep = q_rep.contiguous(), x_rep.contiguous()
    q_bias, x_bias = q_bias.float().contiguous(), x_bias.float().contiguous()
    if _device_type(q_rep) == "cuda":
        return distance_matrix(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0)
    return distance_matrix_ref(q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0,
                               dist.query_left)


def pair_scores(dist, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, M) distances of gathered rows from ALREADY-PREPPED reps, through
    the per-cell gather kernel ``gather_scores``.

    The batched beam engine calls this once per lock-step and branch with
    the full (B, frontier*M) candidate block, in search and in the wave
    builder; the wave builder also scores its reverse-edge candidates with
    it, every (owner, candidate) pair its own query with M = 1.
    """
    if _device_type(ids) == "cuda":
        return gather_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0,
                             dist.query_left)


def frontier_gather_scores(dist, ids, q_rep, q_bias, x_rep, x_bias):
    """(B, R) distances of candidate rows from ALREADY-PREPPED reps, through
    the per-query kernel ``frontier_scores``.

    NN-descent calls it with its (n, C) candidate blocks, every database row
    acting as its own query.
    """
    if _device_type(ids) == "cuda":
        return frontier_scores(ids, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0)
    return gather_scores_ref(ids, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0,
                             dist.query_left)


def nndescent_round_scores(dist, safe_adj, rest, q_rep, q_bias, x_rep, x_bias, out):
    """Score an NN-descent round's (n, K*K + C) candidate block into ``out``.

    The first K*K columns are the two-hop join ``safe_adj[safe_adj]`` with
    self loops scored +inf; ``rest`` (n, C) holds the remaining candidates
    (-1 padding).  ``out`` is an (n, K*K + C) float32 block, possibly a
    column range of a wider one.  On the card the join columns go through
    the grouped ``two_hop_scores`` kernel and ``rest`` through
    ``frontier_scores``, both writing into ``out``; on the CPU their plain
    versions, the join materialised from ``safe_adj`` as the kernel reads it.
    """
    KK = safe_adj.shape[1] ** 2
    if _device_type(safe_adj) == "cuda":
        two_hop_scores(safe_adj, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                       out=out[:, :KK])
        frontier_scores(rest, q_rep, q_bias, x_rep, x_bias, dist.post_id, dist.c0,
                        out=out[:, KK:])
        return out
    out[:, :KK] = two_hop_scores_ref(safe_adj, q_rep, q_bias, x_rep, x_bias, dist.post_id,
                                     dist.c0, dist.query_left)
    out[:, KK:] = gather_scores_ref(rest, q_rep, x_rep, q_bias, x_bias, dist.post_id, dist.c0,
                                    dist.query_left)
    return out


# ---------------------------------------------------------------------------
# any distance: one launch per branch, then the combine
# ---------------------------------------------------------------------------


def query_distance_matrix(dist, Q, X, mode: str = "left"):
    """(B, N) distances between queries Q and database rows X under any
    distance: d(X[i], Q[b]) for ``mode="left"`` (the paper's convention),
    d(Q[b], X[i]) for ``mode="right"`` (the left mode of ``reverse_of(dist)``).

    Each branch is one ``distance_matrix``: every ``knn_scan`` chunk (the
    ground truth and ``filter_and_refine``'s proxy scan), ``build_sharded``'s
    stitch, entry selection and ``calibrate_tau``.
    """
    from repro_torch.core.symmetrize import reverse_of

    if mode == "right":
        dist = reverse_of(dist)
    elif mode != "left":
        raise ValueError(f"unknown query mode {mode!r}")
    consts, qc = prepped(dist.prep_scan(X)), prepped(dist.prep_queries(Q))
    return dist.combine_([distance_matrix_branch(b, q["rep"], x["rep"], q["bias"], x["bias"])
                          for b, x, q in _branches(dist, consts, qc)])


def gathered_scores(dist, ids, qc, consts):
    """(B, M) left-query distances d(x[ids[b, j]], q[b]) under any distance.

    ``consts`` is ``prepped(dist.prep_scan(X))``, ``qc`` the B queries'
    ``prepped(dist.prep_queries(Q))``; ``ids`` row ids, -1 scoring +inf.
    Each branch is one ``pair_scores`` (``gather_scores`` on the card): the
    batched search steps, the wave builder, the reference engine, rerank.
    """
    ids = ids.to(torch.int32).contiguous()
    return dist.combine_([pair_scores(b, ids, q["rep"], q["bias"], x["rep"], x["bias"])
                          for b, x, q in _branches(dist, consts, qc)])


def row_scores(dist, ids, qc, consts):
    """(B, R) distances as ``gathered_scores``, each branch through the
    per-query ``frontier_scores`` (NN-descent's initial neighbours)."""
    ids = ids.to(torch.int32).contiguous()
    return dist.combine_([frontier_gather_scores(b, ids, q["rep"], q["bias"], x["rep"],
                                                 x["bias"])
                          for b, x, q in _branches(dist, consts, qc)])


def round_scores(dist, safe_adj, rest, qc, consts, out):
    """An NN-descent round's (n, K*K + C) block under any distance, into ``out``.

    Each branch is one ``nndescent_round_scores`` (``two_hop_scores`` and
    ``frontier_scores`` on the card): the first writes into ``out``, every
    other into a block of its own, and the combine writes into ``out``.
    """
    outs = []
    for i, (b, x, q) in enumerate(_branches(dist, consts, qc)):
        block = out if i == 0 else torch.empty(out.shape, dtype=out.dtype, device=out.device)
        outs.append(nndescent_round_scores(b, safe_adj, rest, q["rep"], q["bias"], x["rep"],
                                           x["bias"], block))
    dist.combine_(outs)
    return out


def beam_gather_scores(dist, ids, Q, X):
    """(B, M) distances of neighbor rows ``ids`` under the left-query
    convention, prepping Q and all of X on every call."""
    return gathered_scores(dist, ids, prepped(dist.prep_queries(Q)), prepped(dist.prep_scan(X)))


KERNELS = ("frontier_scores", "two_hop_scores", "gather_scores", "distance_matrix")


def launch_counts() -> dict:
    """Launches of each CUDA kernel wrapper so far in this process, by name
    (the ``launches.<name>`` counters of ``core.trace``)."""
    from repro_torch.core import trace

    counts = trace.counters("launches.")
    return {name: counts.get(name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.core import trace

    trace.reset("launches.")
