"""Distance zoo in matmul form (PyTorch port of ``repro.core.distances``).

Every distance factors as

    d(u, v) = post( prep_left(u) . prep_right(v), bias_left(u), bias_right(v) )

with ``u`` the LEFT argument.  The paper's left queries compute ``d(x, q)``
with the data point on the left, so a query-vs-database scan is one matmul
of ``prep_right(Q)`` against the database prepped once by ``prep_left``.

The post-combine ids are shared with the CUDA kernel
(``repro_torch/kernels/csrc/frontier_gather.cu``):

    POST_LINEAR : s + bias_l + bias_r            (KL, Itakura-Saito)
    POST_RENYI  : log(max(s, tiny)) * c0         (Renyi, c0 = 1/(alpha-1))
    POST_NEG    : -s                             (BM25 / negative inner product)
    POST_L2     : bias_l - 2 s + bias_r          (squared Euclidean)

Every distance, the wrappers of ``symmetrize.py`` included, also lowers to
its matmul-form BRANCHES (``branches``, ``branch_reps``, ``combine_``): a
``Distance`` is one branch, a symmetrized or combined distance two or three
plus a pointwise combine.  The kernel sites score each branch with one
launch and combine the outputs (``repro_torch.kernels.ops``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple

import torch

POST_LINEAR = 0
POST_RENYI = 1
POST_NEG = 2
POST_L2 = 3

_TINY = 1e-30
EPS = 1e-6  # histogram floor; matches the data generators


class Branch(NamedTuple):
    """One matmul-form branch of a distance: what a kernel takes beside the reps.

    ``query_left`` marks a reversed branch, whose query is the LEFT argument
    of the base distance: its plain version adds the query's bias before
    the row's, as the JAX package's ``ReversedDistance.score`` does (the
    kernels add the row's first, a difference of at most one ulp).
    """

    post_id: int
    c0: float
    query_left: bool


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a nested dict of prepped constants."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, v) for key, v in tree.items()}
    return fn(tree)


def apply_post(post_id: int, s, bias_l, bias_r, c0: float = 0.0):
    """Apply a post-combine; ``bias_l``/``bias_r`` broadcast against ``s``."""
    if post_id == POST_LINEAR:
        return s + bias_l + bias_r
    if post_id == POST_RENYI:
        return torch.log(torch.clamp(s, min=_TINY)) * c0
    if post_id == POST_NEG:
        return -s
    if post_id == POST_L2:
        return bias_l - 2.0 * s + bias_r
    raise ValueError(f"unknown post id {post_id}")


@dataclasses.dataclass(frozen=True)
class Distance:
    """A (possibly non-symmetric, non-metric) distance in matmul form.

    ``prep_left``/``prep_right`` map a batch of raw vectors (N, m) to the
    transformed representation (N, m'); ``bias_left``/``bias_right`` map the
    same batch to per-row biases (N,).  ``pairwise`` is the pointwise oracle
    d(u, v), written over the last axis so it also takes equal-length batches.
    """

    name: str
    post_id: int
    prep_left: Callable
    prep_right: Callable
    bias_left: Callable
    bias_right: Callable
    pairwise: Callable  # (..., m), (..., m) -> (...)
    c0: float = 0.0
    symmetric: bool = False
    needs_simplex: bool = True  # defined over positive histograms
    query_left: ClassVar[bool] = False  # a Distance is its own forward branch

    def matrix(self, U, V):
        """D[i, j] = d(U[i], V[j]) via one matmul."""
        s = self.prep_left(U) @ self.prep_right(V).T
        return apply_post(
            self.post_id, s, self.bias_left(U)[:, None], self.bias_right(V)[None, :], self.c0
        )

    def query_matrix(self, Q, X, mode: str = "left"):
        """(B, N) distances between queries Q (B, m) and database X (N, m).

        mode="left"  (paper default): D[b, i] = d(X[i], Q[b])
        mode="right"                : D[b, i] = d(Q[b], X[i])
        """
        if mode == "left":
            s = self.prep_right(Q) @ self.prep_left(X).T
            return apply_post(
                self.post_id, s, self.bias_left(X)[None, :], self.bias_right(Q)[:, None], self.c0
            )
        if mode == "right":
            s = self.prep_left(Q) @ self.prep_right(X).T
            return apply_post(
                self.post_id, s, self.bias_left(Q)[:, None], self.bias_right(X)[None, :], self.c0
            )
        raise ValueError(f"unknown query mode {mode!r}")

    def pairwise_batch(self, U, V):
        """d(U[i], V[i]) elementwise over two equal-length batches."""
        return self.pairwise(U, V)

    # -- gather-able per-row constants (beam-search contract) ---------------

    def prep_scan(self, X):
        return {"rep": self.prep_left(X), "bias": self.bias_left(X)}

    def prep_query(self, q):
        """Per-query constants matching ``prep_scan`` (q: (m,) raw vector)."""
        return {"rep": self.prep_right(q[None, :])[0], "bias": self.bias_right(q[None, :])[0]}

    def prep_queries(self, Q):
        """``prep_query`` of every row of Q (B, m) at once."""
        return {"rep": self.prep_right(Q), "bias": self.bias_right(Q)}

    def score(self, rows, qc):
        """rows: dict from prep_scan gathered to (R, ...); qc: from prep_query.

        Also batched: rows gathered to (B, R, ...) with qc from ``prep_queries``.
        """
        s = (rows["rep"] @ qc["rep"][..., :, None])[..., 0]
        return apply_post(self.post_id, s, rows["bias"], qc["bias"][..., None], self.c0)

    # -- branch lowering (the kernel sites' contract) ------------------------

    @property
    def branches(self) -> tuple:
        return (Branch(self.post_id, self.c0, False),)

    def branch_reps(self, prepped) -> list:
        """The ``{"rep", "bias"}`` dicts of ``prepped`` in branch order."""
        return [prepped]

    def combine_(self, outs):
        """Combine the branches' outputs (here the one) into the first, in place."""
        return outs[0]


def _safe(x):
    return torch.clamp(x, min=EPS)


def _zeros_bias(U):
    return torch.zeros(U.shape[:-1], dtype=U.dtype, device=U.device)


def kl_divergence() -> Distance:
    """KL(u || v) = sum u log(u/v).  Non-symmetric, non-metric (Bregman)."""

    def pairwise(u, v):
        u, v = _safe(u), _safe(v)
        return torch.sum(u * (torch.log(u) - torch.log(v)), dim=-1)

    return Distance(
        name="kl",
        post_id=POST_LINEAR,
        prep_left=_safe,
        prep_right=lambda V: -torch.log(_safe(V)),
        bias_left=lambda U: torch.sum(_safe(U) * torch.log(_safe(U)), dim=-1),
        bias_right=_zeros_bias,
        pairwise=pairwise,
    )


def itakura_saito() -> Distance:
    """IS(u, v) = sum [ u/v - log(u/v) - 1 ].  Strongly non-symmetric."""

    def pairwise(u, v):
        u, v = _safe(u), _safe(v)
        r = u / v
        return torch.sum(r - torch.log(r) - 1.0, dim=-1)

    def bias_left(U):
        m = U.shape[-1]
        return -torch.sum(torch.log(_safe(U)), dim=-1) - float(m)

    return Distance(
        name="itakura_saito",
        post_id=POST_LINEAR,
        prep_left=_safe,
        prep_right=lambda V: 1.0 / _safe(V),
        bias_left=bias_left,
        bias_right=lambda V: torch.sum(torch.log(_safe(V)), dim=-1),
        pairwise=pairwise,
    )


def renyi_divergence(alpha: float) -> Distance:
    """Renyi_a(u||v) = log( sum u^a v^(1-a) ) / (a - 1), a > 0, a != 1."""
    if alpha <= 0 or alpha == 1.0:
        raise ValueError("Renyi divergence needs alpha > 0, alpha != 1")
    c0 = 1.0 / (alpha - 1.0)

    def pairwise(u, v):
        u, v = _safe(u), _safe(v)
        s = torch.sum(u**alpha * v ** (1.0 - alpha), dim=-1)
        return torch.log(torch.clamp(s, min=_TINY)) * c0

    return Distance(
        name=f"renyi_{alpha:g}",
        post_id=POST_RENYI,
        prep_left=lambda U: _safe(U) ** alpha,
        prep_right=lambda V: _safe(V) ** (1.0 - alpha),
        bias_left=_zeros_bias,
        bias_right=_zeros_bias,
        pairwise=pairwise,
        c0=c0,
        symmetric=(alpha == 0.5),
    )


def neg_inner_product(name: str = "negdot") -> Distance:
    """Negative inner product: the BM25 similarity as a distance (Eq. 1)."""

    def pairwise(u, v):
        return -torch.sum(u * v, dim=-1)

    return Distance(
        name=name,
        post_id=POST_NEG,
        prep_left=lambda U: U,
        prep_right=lambda V: V,
        bias_left=_zeros_bias,
        bias_right=_zeros_bias,
        pairwise=pairwise,
        symmetric=False,
        needs_simplex=False,
    )


def l2_squared() -> Distance:
    """Squared Euclidean - the quasi-symmetrization proxy of the paper."""

    def pairwise(u, v):
        w = u - v
        return torch.sum(w * w, dim=-1)

    return Distance(
        name="l2",
        post_id=POST_L2,
        prep_left=lambda U: U,
        prep_right=lambda V: V,
        bias_left=lambda U: torch.sum(U * U, dim=-1),
        bias_right=lambda V: torch.sum(V * V, dim=-1),
        pairwise=pairwise,
        symmetric=True,
        needs_simplex=False,
    )


_FACTORIES = {
    "kl": kl_divergence,
    "itakura_saito": itakura_saito,
    "renyi_0.25": lambda: renyi_divergence(0.25),
    "renyi_0.75": lambda: renyi_divergence(0.75),
    "renyi_2": lambda: renyi_divergence(2.0),
    "negdot": neg_inner_product,
    "bm25": neg_inner_product,  # alias: BM25-as-distance over vectorized reps
    "l2": l2_squared,
}


def get_distance(name: str) -> Distance:
    if name.startswith("renyi_"):
        alpha = float(name.split("_", 1)[1])
        return renyi_divergence(alpha)
    try:
        return _FACTORIES[name]()
    except KeyError:
        raise ValueError(f"unknown distance {name!r}; known: {sorted(_FACTORIES)}") from None


def available_distances():
    return sorted(_FACTORIES)
