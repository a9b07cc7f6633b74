"""The plain reference the benchmark judges by: one file per base distance.

``load(name)`` gives ``reference/<name>.py`` for the base distance that a
configuration's ``spec`` names (the program's registry name), and raises for
a distance that has no file, so that no cell is judged against another
distance's truth.  A distance file is plain PyTorch written from the
paper's definitions, imports nothing of the program and defines, for its
``d(x, y)`` with the data point on the left:

* ``pairs(U, V)``: ``d(U[..], V[..])`` over the last axis, in float64;
* ``left_matrix(Q, Xb, tf32)``: ``D[b, i] = d(Xb[i], Q[b])``, float32;
* ``right_matrix(Q, Xb, tf32)``: ``D[b, i] = d(Q[b], Xb[i])``, float32.

The search is left-query, ``d(x, q)``.  A build policy (``POLICIES``) makes
the build distance from both directions; a policy with no entry raises.

Two precisions: the truth, float32 matrix products with TF32 off
(``exact_topk``), and float64 for the distance of one named pair; the
control, the same exact scan with every matrix product in TF32
(``tf32=True``): the inputs are rounded to TF32's 10-bit mantissa
(``round_tf32``), and on the card the products also run with TF32 on, which
a CPU run cannot.
"""

from __future__ import annotations

import contextlib

import torch

from portbench import plugins

# build policy -> how the build distance combines d(x, y) (left) and d(y, x) (right)
POLICIES = {
    "none": lambda left, right: left(),
    "reverse": lambda left, right: right(),
    "avg": lambda left, right: 0.5 * (left() + right()),
    "min": lambda left, right: torch.minimum(left(), right()),
    "max": lambda left, right: torch.maximum(left(), right()),
}


def load(name: str):
    return plugins.load("reference", name, "reference distance")


def policy(name: str):
    if name not in POLICIES:
        raise ValueError(f"no reference for the build policy {name!r}; known: {sorted(POLICIES)}")
    return POLICIES[name]


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest at TF32's 10 explicit mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """Products in TF32 (the control) or in float32 (the truth) on the card."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def pair_distance(dist, name: str, X_cand: torch.Tensor, X_node: torch.Tensor) -> torch.Tensor:
    """The build distance under policy ``name`` between a node and its
    candidates, in float64; ``none`` is ``d(x_cand, x_node)``."""
    return policy(name)(lambda: dist.pairs(X_cand, X_node), lambda: dist.pairs(X_node, X_cand))


def distance_matrix(dist, name: str, Q: torch.Tensor, Xb: torch.Tensor,
                    tf32: bool = False) -> torch.Tensor:
    """``D[b, i]``, the distance of row ``Xb[i]`` to ``Q[b]`` under policy ``name``."""
    return policy(name)(lambda: dist.left_matrix(Q, Xb, tf32),
                        lambda: dist.right_matrix(Q, Xb, tf32))


def exact_topk(dist, Q: torch.Tensor, X: torch.Tensor, k: int, *, policy_name: str = "none",
               exclude=None, tf32: bool = False, block_q: int = 8192,
               block_x: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """The exact k nearest rows of X for every row of Q, in blocks.

    Returns ``(dists (B, k) float32 ascending, ids (B, k) int64)``.
    ``exclude`` (B,) drops one row id per query (a node's own row).
    """
    policy(policy_name)
    B, n = Q.shape[0], X.shape[0]
    out_d = torch.empty((B, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((B, k), dtype=torch.int64, device=Q.device)
    with matmul_precision(tf32):
        for q0 in range(0, B, block_q):
            qb = Q[q0:q0 + block_q]
            best_d = torch.full((qb.shape[0], k), float("inf"), device=Q.device)
            best_i = torch.full((qb.shape[0], k), -1, dtype=torch.int64, device=Q.device)
            for x0 in range(0, n, block_x):
                D = distance_matrix(dist, policy_name, qb, X[x0:x0 + block_x], tf32)
                if exclude is not None:
                    own = exclude[q0:q0 + block_q] - x0
                    hit = (own >= 0) & (own < D.shape[1])
                    rows = torch.nonzero(hit).squeeze(1)
                    D[rows, own[rows]] = float("inf")
                kk = min(k, D.shape[1])
                d, i = torch.topk(D, kk, dim=1, largest=False, sorted=True)
                cat_d = torch.cat([best_d, d], dim=1)
                cat_i = torch.cat([best_i, i + x0], dim=1)
                sel = torch.topk(cat_d, k, dim=1, largest=False, sorted=True).indices
                best_d = torch.gather(cat_d, 1, sel)
                best_i = torch.gather(cat_i, 1, sel)
                del D
            out_d[q0:q0 + block_q] = best_d
            out_i[q0:q0 + block_q] = best_i
    return out_d, out_i
