"""Distance symmetrization, combinators and learned construction distances
(PyTorch port of ``repro.core.symmetrize``).

The paper's central knob: the distance used to CONSTRUCT the neighborhood
graph may differ from the distance used to SEARCH it.

    none    : the original distance d(u, v)
    avg     : (d(u, v) + d(v, u)) / 2                      (Eq. 2)
    min     : min(d(u, v), d(v, u))                        (Eq. 3)
    reverse : d(v, u)              (argument-reversed quasi-symmetrization)
    l2      : squared Euclidean    (quasi-symmetrization proxy)
    natural : distance-specific natural symmetrization; for BM25 both sides
              are vectorized as TF * sqrt(IDF)             (Eq. 4)

plus the combinators ``CombinedDistance`` (blend, max, rankblend) and the
trained ``LearnedDistance``.  Every wrapper has the forms of
``repro_torch.core.distances.Distance``: ``matrix``, ``query_matrix`` (left
and right), ``pairwise``/``pairwise_batch``, ``prep_scan``/``prep_query``/
``prep_queries``/``score``, and the branch lowering the kernel sites use
(``branches``, ``branch_reps``, ``combine_``): a wrapper is at most three
matmul-form branches (forward, reverse, Mahalanobis) and a pointwise
combine.  The wrappers' own forms are the plain versions; the kernels are
reached through ``repro_torch.kernels.ops``.

Order of operations follows the JAX package so that the CPU results agree
bit for bit where the float operations are the same: a reversed branch
adds the query's bias first, ``avg`` is ``(a + b) * 0.5``, ``blend`` is
``alpha * a + (1 - alpha) * b`` with each product rounded, and the
rankblend proxy is ``(tau * sign(x)) * log1p(|x| / tau)``.  The combines
work in place on the first branch's output, so a kernel site allocates no
block beyond one per branch.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Callable, Optional

import torch

from repro_torch.core.distances import Branch, Distance, apply_post, l2_squared

SYM_MODES = ("none", "avg", "min", "reverse", "l2", "natural")


def _flip(mode: str) -> str:
    if mode not in ("left", "right"):
        raise ValueError(f"unknown query mode {mode!r}")
    return "right" if mode == "left" else "left"


def _rows(view, u):
    """``view`` of one raw vector (m,) or of a batch of them (n, m)."""
    return view(u[None])[0] if u.dim() == 1 else view(u)


# ---------------------------------------------------------------------------
# single-branch wrappers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ReversedDistance:
    """d_rev(u, v) = d(v, u) over a matmul-form ``Distance``."""

    base: Distance

    @property
    def name(self):
        return f"{self.base.name}-reverse"

    @property
    def needs_simplex(self):
        return self.base.needs_simplex

    @property
    def symmetric(self):
        return self.base.symmetric

    def matrix(self, U, V):
        return self.base.matrix(V, U).T

    def query_matrix(self, Q, X, mode: str = "left"):
        # left mode: D[b, i] = d_rev(X[i], Q[b]) = d(Q[b], X[i]) = base right mode
        return self.base.query_matrix(Q, X, mode=_flip(mode))

    def pairwise(self, u, v):
        return self.base.pairwise(v, u)

    def pairwise_batch(self, U, V):
        return self.base.pairwise(V, U)

    def prep_scan(self, X):
        return {"rep": self.base.prep_right(X), "bias": self.base.bias_right(X)}

    def prep_query(self, q):
        return {"rep": self.base.prep_left(q[None, :])[0],
                "bias": self.base.bias_left(q[None, :])[0]}

    def prep_queries(self, Q):
        return {"rep": self.base.prep_left(Q), "bias": self.base.bias_left(Q)}

    def score(self, rows, qc):
        s = (rows["rep"] @ qc["rep"][..., :, None])[..., 0]
        # left-mode d_rev(x, q) = d(q, x): q is the LEFT argument of base
        return apply_post(self.base.post_id, s, qc["bias"][..., None], rows["bias"], self.base.c0)

    @property
    def branches(self) -> tuple:
        return (Branch(self.base.post_id, self.base.c0, True),)

    def branch_reps(self, prepped) -> list:
        return [prepped]

    def combine_(self, outs):
        return outs[0]


@dataclasses.dataclass(frozen=True)
class ViewedDistance:
    """A distance evaluated over role-dependent representations.

    ``left_view`` maps a raw record matrix to its left-argument (document)
    representation and ``right_view`` to its right-argument (query) one:
    BM25's asymmetric vectorization, and Eq. (4)'s natural symmetrization
    when both views coincide.  ``base`` is a ``Distance`` or its reversal.
    The rows a view yields are what the kernels read, made contiguous by
    the kernel sites.
    """

    base: object
    left_view: Callable
    right_view: Callable
    view_name: str = "viewed"

    @property
    def name(self):
        return f"{self.base.name}-{self.view_name}"

    @property
    def needs_simplex(self):
        return False

    def matrix(self, U, V):
        return self.base.matrix(self.left_view(U), self.right_view(V))

    def query_matrix(self, Q, X, mode: str = "left"):
        if mode == "left":
            return self.base.query_matrix(self.right_view(Q), self.left_view(X), mode="left")
        if mode == "right":
            return self.base.query_matrix(self.left_view(Q), self.right_view(X), mode="right")
        raise ValueError(f"unknown query mode {mode!r}")

    def pairwise(self, u, v):
        return self.base.pairwise(_rows(self.left_view, u), _rows(self.right_view, v))

    def pairwise_batch(self, U, V):
        return self.pairwise(U, V)

    def prep_scan(self, X):
        return self.base.prep_scan(self.left_view(X))

    def prep_query(self, q):
        return self.base.prep_query(self.right_view(q[None])[0])

    def prep_queries(self, Q):
        return self.base.prep_queries(self.right_view(Q))

    def score(self, rows, qc):
        return self.base.score(rows, qc)

    @property
    def branches(self) -> tuple:
        return self.base.branches

    def branch_reps(self, prepped) -> list:
        return self.base.branch_reps(prepped)

    def combine_(self, outs):
        return self.base.combine_(outs)


# ---------------------------------------------------------------------------
# multi-branch wrappers: parts evaluated alike, then merged pointwise
# ---------------------------------------------------------------------------


class _PartsDistance:
    """The forms shared by the wrappers that merge two or three parts.

    ``_parts()`` names each part ``("f" | "r" | "m", distance)``: the base,
    its reversal, the Mahalanobis view; every form evaluates each part and
    hands the outputs to ``_merge_``, which writes into the first.
    """

    def _parts(self) -> tuple:
        raise NotImplementedError

    def _merge_(self, f, r=None, m=None):
        raise NotImplementedError

    def _each(self, fn):
        return self._merge_(**{key: fn(part) for key, part in self._parts()})

    def matrix(self, U, V):
        return self._each(lambda p: p.matrix(U, V))

    def query_matrix(self, Q, X, mode: str = "left"):
        return self._each(lambda p: p.query_matrix(Q, X, mode=mode))

    def pairwise(self, u, v):
        return self._each(lambda p: p.pairwise(u, v))

    def pairwise_batch(self, U, V):
        return self._each(lambda p: p.pairwise_batch(U, V))

    def prep_scan(self, X):
        return {key: p.prep_scan(X) for key, p in self._parts()}

    def prep_query(self, q):
        return {key: p.prep_query(q) for key, p in self._parts()}

    def prep_queries(self, Q):
        return {key: p.prep_queries(Q) for key, p in self._parts()}

    def score(self, rows, qc):
        return self._merge_(**{key: p.score(rows[key], qc[key]) for key, p in self._parts()})

    @property
    def branches(self) -> tuple:
        return sum((p.branches for _, p in self._parts()), ())

    def branch_reps(self, prepped) -> list:
        return sum((p.branch_reps(prepped[key]) for key, p in self._parts()), [])

    def combine_(self, outs):
        merged, at = {}, 0
        for key, p in self._parts():
            width = len(p.branches)
            merged[key] = p.combine_(outs[at:at + width])
            at += width
        return self._merge_(**merged)


def _proxy_(x, tau: float):
    """``x <- (tau * sign(x)) * log1p(|x| / tau)`` in place (the rankblend proxy).

    A tensor divisor: CUDA divides by a host scalar as a product with its
    reciprocal, which rounds otherwise than the division JAX does.
    """
    t = torch.log1p_(torch.abs(x) / torch.tensor(tau, dtype=x.dtype, device=x.device))
    return x.sign_().mul_(tau).mul_(t)


def _blend_(fwd, rev, alpha: float):
    """``fwd <- alpha * fwd + (1 - alpha) * rev``, each product rounded (rev is overwritten)."""
    return fwd.mul_(alpha).add_(rev.mul_(1.0 - alpha))


@dataclasses.dataclass(frozen=True)
class SymmetrizedDistance(_PartsDistance):
    """avg- or min-based symmetrization (Eqs. 2-3) over any distance: the
    base and its argument reversal, combined."""

    base: object
    mode: str  # "avg" | "min"

    def __post_init__(self):
        if self.mode not in ("avg", "min"):
            raise ValueError(self.mode)

    @property
    def name(self):
        return f"{self.base.name}-{self.mode}"

    @property
    def needs_simplex(self):
        return self.base.needs_simplex

    @property
    def symmetric(self):
        return True  # symmetric by construction (Eqs. 2-3)

    def _parts(self):
        return (("f", self.base), ("r", reverse_of(self.base)))

    def _merge_(self, f, r=None, m=None):
        if self.mode == "avg":
            return f.add_(r).mul_(0.5)
        return torch.minimum(f, r, out=f)


@dataclasses.dataclass(frozen=True)
class CombinedDistance(_PartsDistance):
    """Parametric two-branch combinator over a distance:

        blend      alpha * d(u, v) + (1 - alpha) * d(v, u)
        max        max(d(u, v), d(v, u))
        rankblend  alpha * d(u, v) + (1 - alpha) * proxy(d(v, u)),
                   proxy(x) = tau * sign(x) * log1p(|x| / tau)

    ``DistancePolicy.bind`` lowers blend at alpha 1, 0.5 and 0 to the
    original distance, avg and reverse.
    """

    base: object
    combine: str  # "blend" | "max" | "rankblend"
    alpha: float = 0.5
    tau: float = 1.0

    def __post_init__(self):
        if self.combine not in ("blend", "max", "rankblend"):
            raise ValueError(f"unknown combine {self.combine!r}")
        if self.combine in ("blend", "rankblend") and not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        if self.combine == "rankblend" and self.tau <= 0.0:
            raise ValueError(f"tau must be > 0, got {self.tau}")

    @property
    def name(self):
        if self.combine == "max":
            return f"{self.base.name}-max"
        if self.combine == "blend":
            return f"{self.base.name}-blend({self.alpha:g})"
        return f"{self.base.name}-rankblend({self.alpha:g},{self.tau:g})"

    @property
    def needs_simplex(self):
        return self.base.needs_simplex

    @property
    def symmetric(self):
        # blend is symmetric only at the avg point; rankblend never is
        return self.combine == "max" or (self.combine == "blend" and self.alpha == 0.5)

    def _parts(self):
        return (("f", self.base), ("r", reverse_of(self.base)))

    def _merge_(self, f, r=None, m=None):
        if self.combine == "max":
            return torch.maximum(f, r, out=f)
        if self.combine == "rankblend":
            r = _proxy_(r, self.tau)
        return _blend_(f, r, self.alpha)


# ---------------------------------------------------------------------------
# learned construction distances
# ---------------------------------------------------------------------------


def learned_weights_fingerprint(weights: dict) -> str:
    """Content fingerprint of a learned-weights dict (sorted-key JSON,
    sha256, first 12 hex chars), the JAX package's convention."""
    blob = json.dumps(weights, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


# the process's learned-weights dicts, keyed by content fingerprint:
# ``Learned(ref)`` policies resolve their weights here when they bind, and
# ``load_learned_artifact`` fills it, so a spec inside an artifact binds alone
_LEARNED_WEIGHTS: dict = {}


def register_learned_weights(weights: dict, *, fingerprint: Optional[str] = None) -> str:
    """Register a learned-weights dict; returns its fingerprint.

    ``weights`` is plain JSON: ``alpha``, ``beta``, ``tau`` (float or None)
    and ``L`` (nested lists, the low-rank Mahalanobis map, or None).  A
    ``fingerprint`` that differs from the recomputed one means the weights
    were edited after sealing.
    """
    for field in ("alpha", "beta", "tau", "L"):
        if field not in weights:
            raise ValueError(f"learned weights missing field {field!r}")
    fp = learned_weights_fingerprint(weights)
    if fingerprint is not None and fingerprint != fp:
        raise ValueError(
            f"learned weights fingerprint mismatch: recorded {fingerprint}, recomputed {fp}")
    _LEARNED_WEIGHTS[fp] = weights
    return fp


def get_learned_weights(ref: str) -> dict:
    """The learned-weights dict registered under fingerprint ``ref``."""
    try:
        return _LEARNED_WEIGHTS[ref]
    except KeyError:
        raise KeyError(
            f"no learned weights registered under {ref!r}; load the sealed artifact "
            "first (repro_torch.core.spec.load_learned_artifact / load_spec) or call "
            "register_learned_weights") from None


@dataclasses.dataclass(frozen=True)
class LearnedDistance(_PartsDistance):
    """A learned construction distance:

        d(u, v) = alpha * d(u, v) + (1 - alpha) * proxy(d(v, u))
                  + beta * ||L^T u - L^T v||^2

    ``proxy`` is the identity when ``tau is None`` and the rankblend
    compression otherwise.  Unused branches are left out statically
    (alpha == 1: no reverse branch; beta == 0: no Mahalanobis branch), so
    ``(alpha, beta=0, tau=None)`` is arithmetically identical to
    ``CombinedDistance(base, "blend", alpha)``.
    """

    base: object
    alpha: float = 1.0
    beta: float = 0.0
    tau: Optional[float] = None
    maha: Optional[object] = None  # ViewedDistance(l2, M -> M @ L); None iff beta == 0
    weights_fingerprint: str = ""

    def __post_init__(self):
        if not 0.0 <= self.alpha <= 1.0:
            raise ValueError(f"alpha must be in [0, 1], got {self.alpha}")
        if self.tau is not None and self.tau <= 0.0:
            raise ValueError(f"tau must be > 0, got {self.tau}")
        if (self.beta != 0.0) != (self.maha is not None):
            raise ValueError("maha branch must be present exactly when beta != 0")

    @classmethod
    def from_weights(cls, base, weights: dict, *, fingerprint: Optional[str] = None):
        """Build from a plain-JSON weights dict (see ``register_learned_weights``)."""
        fp = register_learned_weights(weights, fingerprint=fingerprint)
        beta = float(weights["beta"])
        maha = None
        if beta != 0.0:
            if weights["L"] is None:
                raise ValueError("beta != 0 requires a Mahalanobis map L")
            L = torch.tensor(weights["L"], dtype=torch.float32)

            def view(M):
                return M @ L.to(M.device)

            maha = ViewedDistance(l2_squared(), left_view=view, right_view=view,
                                  view_name=f"maha({fp})")
        tau = weights["tau"]
        return cls(base, alpha=float(weights["alpha"]), beta=beta,
                   tau=None if tau is None else float(tau), maha=maha, weights_fingerprint=fp)

    @property
    def name(self):
        return f"{self.base.name}-learned({self.weights_fingerprint})"

    @property
    def needs_simplex(self):
        return self.base.needs_simplex

    @property
    def symmetric(self):
        blend_sym = self.alpha == 0.5 and self.tau is None
        return blend_sym or (self.alpha == 1.0 and getattr(self.base, "symmetric", False))

    def _parts(self):
        parts = [("f", self.base)]
        if self.alpha != 1.0:
            parts.append(("r", reverse_of(self.base)))
        if self.beta != 0.0:
            parts.append(("m", self.maha))
        return tuple(parts)

    def _merge_(self, f, r=None, m=None):
        out = f
        if r is not None:
            if self.tau is not None:
                r = _proxy_(r, self.tau)
            out = _blend_(f, r, self.alpha)
        if m is not None:
            out = out.add_(m.mul_(self.beta))
        return out


# ---------------------------------------------------------------------------
# calibration and factories
# ---------------------------------------------------------------------------


def median(values) -> float:
    """The median of a 1-d float tensor as ``jnp.median`` takes it: the mean
    of the two middle values of an even count, ``(lo + hi) * 0.5`` in the
    tensor's dtype (``torch.median`` returns the lower one)."""
    vals = torch.sort(values).values
    k = vals.numel()
    return float((vals[(k - 1) // 2] + vals[k // 2]) * 0.5)


def calibrate_tau(base, X, *, max_rows: int = 256) -> float:
    """Data-calibrated rankblend proxy scale: the median |d(v, u)| over all
    ordered pairs of an evenly strided sample of X (at most ``max_rows``).

    The median of an even count is the mean of the two middle values, as
    ``jnp.median`` takes it (``median``).  1.0
    when the sample is degenerate (fewer than 2 rows, all zero, not finite).
    On the card the sample's block goes through ``distance_matrix``.
    """
    from repro_torch.kernels.ops import query_distance_matrix

    n = int(X.shape[0])
    if n < 2:
        return 1.0
    stride = max(1, n // max_rows)
    S = X[::stride][:max_rows]
    m = int(S.shape[0])
    # D[b, i] = d(S[i], S[b]): base.matrix(S, S).T, d(v, u) over the sample
    D = query_distance_matrix(base, S, S, mode="left")
    off = ~torch.eye(m, dtype=torch.bool, device=D.device)
    med = median(torch.abs(D[off]))
    if not (med > 0.0 and med != float("inf")):
        return 1.0
    return med


def reverse_of(base):
    """Argument reversal of any distance.

    A ``ViewedDistance`` swaps its role views and reverses the inner
    distance: vd_rev(u, v) = vd(v, u) = inner(L(v), R(u)) = inner_rev(R(u), L(v)).
    A reversal reverses back to its base, and a multi-branch wrapper to the
    same wrapper over the reversed base, so every reversal keeps the branch
    lowering (the JAX package wraps those in a ``ReversedDistance``, the
    same values).
    """
    if isinstance(base, ViewedDistance):
        return ViewedDistance(reverse_of(base.base), left_view=base.right_view,
                              right_view=base.left_view, view_name=base.view_name + "-rev")
    if isinstance(base, ReversedDistance):
        return base.base
    if isinstance(base, _PartsDistance):
        return dataclasses.replace(base, base=reverse_of(base.base))
    return ReversedDistance(base)


def symmetrized(base, mode: str, natural: Optional[Callable] = None):
    """Wrap ``base`` with a symmetrization mode.

    ``natural``: optional callable returning the distance-specific natural
    symmetrization (e.g. built from the collection's IDF, Eq. 4).
    """
    if mode == "none":
        return base
    if mode == "reverse":
        return reverse_of(base)
    if mode in ("avg", "min"):
        return SymmetrizedDistance(base, mode)
    if mode == "l2":
        return l2_squared()
    if mode == "natural":
        if natural is None:
            raise ValueError("natural symmetrization requires a dataset-supplied distance")
        return natural()
    raise ValueError(f"unknown symmetrization mode {mode!r}; known: {SYM_MODES}")
