"""RetrievalSpec and DistancePolicy (PyTorch port of ``repro.core.spec``).

``DistancePolicy`` names how a base distance is transformed before use: the
symmetrization modes (none/avg/min/reverse/l2/natural) and the combinators

    Blend(alpha)            alpha*d(u,v) + (1-alpha)*d(v,u)
    MaxSym()                max(d(u,v), d(v,u))
    RankBlend(alpha, tau)   alpha*d(u,v) + (1-alpha)*proxy(d(v,u))
    Learned(ref)            a trained construction distance, by fingerprint

``bind`` lowers a policy over a base distance to a wrapper of
``symmetrize.py``, which the engines and kernels score branch by branch.

``RetrievalSpec`` is the frozen object that describes a whole retrieval
scenario: base distance, build/search policies and rerank ``k_c``, builder,
engine and scheduler knobs.  Its fields, defaults, validation, JSON form and
fingerprint are those of ``repro``: ``to_json()`` and ``fingerprint()`` give
the same bytes in both packages, so a spec or a sealed artifact written by
one loads in the other.  The QoS demotion ladder (``demotion_ladder``,
``class_spec``) serves only the scheduler and is not ported yet (ROADMAP
item M12).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import re
from typing import Callable, Optional

from repro_torch.core.symmetrize import (SYM_MODES, CombinedDistance, LearnedDistance,
                                         calibrate_tau, get_learned_weights,
                                         learned_weights_fingerprint, register_learned_weights,
                                         reverse_of, symmetrized)

POLICY_KINDS = SYM_MODES + ("max", "blend", "rankblend", "learned")

_POLICY_RE = re.compile(r"^([a-z0-9_]+)(?:\(([^)]*)\))?$")
_LEARNED_REF_RE = re.compile(r"^[0-9a-f]{12}$")


@dataclasses.dataclass(frozen=True)
class DistancePolicy:
    """A named, optionally parametric graph-construction distance policy.

    ``str(policy)`` is the canonical serialized form (``"blend(0.25)"``),
    parsed back by ``DistancePolicy.parse``.
    """

    kind: str
    alpha: Optional[float] = None  # blend / rankblend mix weight
    tau: Optional[float] = None  # rankblend proxy scale; None = data-calibrated
    ref: Optional[str] = None  # learned-weights fingerprint (kind == "learned")

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(f"unknown policy kind {self.kind!r}; known: {POLICY_KINDS}")
        if self.kind == "learned":
            if self.ref is None or not _LEARNED_REF_RE.match(self.ref):
                raise ValueError(
                    f"learned needs a 12-hex weights fingerprint ref, got {self.ref!r}"
                )
            if self.alpha is not None or self.tau is not None:
                raise ValueError("learned takes only a weights ref")
            return
        if self.ref is not None:
            raise ValueError(f"policy {self.kind!r} takes no weights ref")
        if self.kind in ("blend", "rankblend"):
            if self.alpha is None or not 0.0 <= self.alpha <= 1.0:
                raise ValueError(f"{self.kind} needs alpha in [0, 1], got {self.alpha}")
        elif self.alpha is not None or self.tau is not None:
            raise ValueError(f"policy {self.kind!r} takes no parameters")
        if self.kind == "blend" and self.tau is not None:
            raise ValueError("blend takes no tau")
        if self.kind == "rankblend" and self.tau is not None and self.tau <= 0:
            raise ValueError(f"rankblend needs tau > 0, got {self.tau}")

    @property
    def is_none(self) -> bool:
        return self.kind == "none"

    def __str__(self) -> str:
        # repr() is the shortest float form that round-trips exactly
        if self.kind == "blend":
            return f"blend({self.alpha!r})"
        if self.kind == "rankblend":
            if self.tau is None:
                return f"rankblend({self.alpha!r})"
            return f"rankblend({self.alpha!r},{self.tau!r})"
        if self.kind == "learned":
            return f"learned({self.ref})"
        return self.kind

    @classmethod
    def parse(cls, spec) -> "DistancePolicy":
        """Coerce a policy from its serialized form (or pass one through)."""
        if isinstance(spec, DistancePolicy):
            return spec
        if spec is None:
            return cls("none")
        if not isinstance(spec, str):
            raise TypeError(f"cannot parse a policy from {type(spec).__name__}")
        m = _POLICY_RE.match(spec.strip())
        if not m:
            raise ValueError(f"malformed policy {spec!r}")
        kind, args = m.group(1), m.group(2)
        if kind == "learned":
            if not args or not args.strip():
                raise ValueError(f"learned policy needs a weights ref: {spec!r}")
            return cls("learned", ref=args.strip())
        params = [float(a) for a in args.split(",") if a.strip()] if args else []
        if len(params) > 2:
            raise ValueError(f"too many parameters in policy {spec!r}")
        return cls(
            kind,
            alpha=params[0] if params else None,
            tau=params[1] if len(params) > 1 else None,
        )

    def resolve(self, base=None, data=None) -> "DistancePolicy":
        """Make a data-calibrated parameter concrete.

        Only ``rankblend`` with ``tau=None`` resolves: given ``base`` and a
        database sample ``data``, tau becomes the median reversed-distance
        scale (``calibrate_tau``, deterministic in the data); without data
        the fixed constant 1.0.  Every other policy returns itself.
        """
        if self.kind == "rankblend" and self.tau is None:
            tau = calibrate_tau(base, data) if base is not None and data is not None else 1.0
            return dataclasses.replace(self, tau=tau)
        return self

    def bind(self, base, natural: Optional[Callable] = None, data=None):
        """Lower the policy over ``base``, returning a distance.

        ``blend`` at alpha 0.5, 0 and 1 lowers to ``avg``, ``reverse`` and
        the original distance, so that it equals them bit for bit.  ``data``
        (an (n, m) database sample) resolves a data-calibrated tau first.
        """
        if self.kind in SYM_MODES:
            return symmetrized(base, self.kind, natural=natural)
        if self.kind == "learned":
            return LearnedDistance.from_weights(base, get_learned_weights(self.ref),
                                                fingerprint=self.ref)
        if self.kind == "max":
            return CombinedDistance(base, "max")
        if self.kind == "blend":
            if self.alpha == 1.0:
                return base
            if self.alpha == 0.5:
                return symmetrized(base, "avg")
            if self.alpha == 0.0:
                return reverse_of(base)
            return CombinedDistance(base, "blend", alpha=self.alpha)
        if self.kind == "rankblend":
            p = self.resolve(base, data)
            return CombinedDistance(base, "rankblend", alpha=p.alpha, tau=p.tau)
        raise ValueError(f"unknown policy kind {self.kind!r}")


def Blend(alpha: float) -> DistancePolicy:  # noqa: N802 - combinator constructor
    """alpha*d(u,v) + (1-alpha)*d(v,u)."""
    return DistancePolicy("blend", alpha=float(alpha))


def MaxSym() -> DistancePolicy:  # noqa: N802
    """max(d(u,v), d(v,u)): the pessimistic symmetrization."""
    return DistancePolicy("max")


def RankBlend(alpha: float, tau: Optional[float] = 1.0) -> DistancePolicy:  # noqa: N802
    """Convex mix of d(u,v) with a monotone proxy of the reversed distance;
    ``tau=None`` is calibrated on the database when the policy binds."""
    return DistancePolicy("rankblend", alpha=float(alpha),
                          tau=None if tau is None else float(tau))


def Learned(weights_or_ref) -> DistancePolicy:  # noqa: N802
    """The learned construction distance, by the content fingerprint of its
    weights: a weights dict (registered on the spot) or a 12-hex ref whose
    weights are registered already (``load_learned_artifact``)."""
    if isinstance(weights_or_ref, dict):
        ref = register_learned_weights(weights_or_ref)
    else:
        ref = str(weights_or_ref)
    return DistancePolicy("learned", ref=ref)


NONE_POLICY = DistancePolicy("none")

_BUILDERS = ("nndescent", "swgraph")
_BUILD_ENGINES = ("wave", "sequential")
_ENGINES = ("batched", "reference")


@dataclasses.dataclass(frozen=True)
class RetrievalSpec:
    """One frozen object describing a complete retrieval scenario."""

    # -- distance scenario
    distance: str = "kl"  # base distance registry name
    build_policy: DistancePolicy = NONE_POLICY  # graph-construction distance
    search_policy: DistancePolicy = NONE_POLICY  # beam-guidance distance
    k_c: Optional[int] = None  # rerank candidates (search_policy != none)

    # -- construction
    builder: str = "nndescent"
    build_engine: str = "wave"
    wave: int = 32
    build_frontier: Optional[int] = None
    NN: int = 15
    ef_construction: int = 100
    M_max: Optional[int] = None
    nnd_iters: int = 8
    n_entries: int = 4
    capacity: Optional[int] = None

    # -- search
    k: int = 10
    ef_search: int = 96
    engine: str = "batched"
    frontier: int = 2
    adaptive: bool = False
    patience: int = 1

    # -- scheduler (continuous batching)
    slots: int = 32
    sched_frontier: int = 4
    steps_per_sync: int = 1
    compact: int = 32

    def __post_init__(self):
        for f in ("build_policy", "search_policy"):
            v = getattr(self, f)
            if not isinstance(v, DistancePolicy):
                object.__setattr__(self, f, DistancePolicy.parse(v))
        if self.builder not in _BUILDERS:
            raise ValueError(f"unknown builder {self.builder!r}; known: {_BUILDERS}")
        if self.build_engine not in _BUILD_ENGINES:
            raise ValueError(
                f"unknown build_engine {self.build_engine!r}; known: {_BUILD_ENGINES}"
            )
        if self.engine not in _ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; known: {_ENGINES}")
        for f in ("wave", "NN", "ef_construction", "nnd_iters", "n_entries", "k",
                  "ef_search", "frontier", "patience", "slots", "sched_frontier",
                  "steps_per_sync", "compact"):
            if int(getattr(self, f)) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.k_c is not None and self.k_c < self.k:
            raise ValueError(f"k_c {self.k_c} < k {self.k}")

    def base_distance(self):
        from repro_torch.core.distances import get_distance

        return get_distance(self.distance)

    def bind_build(self, base=None, natural: Optional[Callable] = None, data=None):
        """Lower ``build_policy`` over the base distance (graph construction)."""
        base = base if base is not None else self.base_distance()
        return self.build_policy.bind(base, natural=natural, data=data)

    def bind_search(self, base=None, natural: Optional[Callable] = None, data=None):
        """Lower ``search_policy`` over the base distance (beam guidance)."""
        base = base if base is not None else self.base_distance()
        return self.search_policy.bind(base, natural=natural, data=data)

    @property
    def needs_rerank(self) -> bool:
        """True when the beam runs under a modified distance and the results
        must be re-ranked under the original one."""
        return not self.search_policy.is_none

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["build_policy"] = str(self.build_policy)
        d["search_policy"] = str(self.search_policy)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "RetrievalSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown RetrievalSpec fields: {sorted(unknown)}")
        return cls(**d)

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(self.to_dict(), indent=1, sort_keys=True)
        if path is not None:
            with open(path, "w") as f:
                f.write(s + "\n")
        return s

    @classmethod
    def from_json(cls, src: str) -> "RetrievalSpec":
        """Parse a spec from a JSON string or a path to a JSON file."""
        if "{" not in src:
            with open(src) as f:
                src = f.read()
        return cls.from_dict(json.loads(src))

    def fingerprint(self) -> str:
        """Stable short hash of the canonical serialized form."""
        canon = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(canon.encode()).hexdigest()[:12]

    def replace(self, **changes) -> "RetrievalSpec":
        return dataclasses.replace(self, **changes)

    def grid(self, **axes) -> list["RetrievalSpec"]:
        """One spec per combination of ``axes`` (field -> values), in
        ``itertools.product`` order."""
        if not axes:
            return [self]
        names = list(axes)
        return [self.replace(**dict(zip(names, combo)))
                for combo in itertools.product(*(axes[n] for n in names))]


# ---------------------------------------------------------------------------
# Pareto dominance (the auto-tuner's objective algebra)
# ---------------------------------------------------------------------------


def dominates(a: dict, b: dict, *, maximize=(), minimize=()) -> bool:
    """True iff objective point ``a`` is at least as good as ``b`` on every
    listed objective and strictly better on one.  A missing key raises."""
    if not maximize and not minimize:
        raise ValueError("dominates() needs at least one objective key")
    as_good = all(a[m] >= b[m] for m in maximize) and all(a[m] <= b[m] for m in minimize)
    strictly = any(a[m] > b[m] for m in maximize) or any(a[m] < b[m] for m in minimize)
    return as_good and strictly


def pareto_frontier(points, *, maximize=(), minimize=(), key=None) -> list:
    """The non-dominated subset of ``points`` in input order; ties keep all.

    ``key(point) -> dict`` extracts the objectives (identity by default).
    """
    key = key if key is not None else (lambda p: p)
    objs = [key(p) for p in points]
    return [p for i, p in enumerate(points)
            if not any(dominates(objs[j], objs[i], maximize=maximize, minimize=minimize)
                       for j in range(len(points)) if j != i)]


# ---------------------------------------------------------------------------
# sealed artifacts: the auto-tuner's tuned spec and the trainer's learned weights
# ---------------------------------------------------------------------------

TUNED_ARTIFACT_KIND = "repro.autotune/tuned-spec@1"
LEARNED_ARTIFACT_KIND = "repro.learned/construction-distance@1"


def _doc(src) -> dict:
    """An artifact as a dict, from a dict, a JSON string or a path."""
    if isinstance(src, dict):
        return src
    if "{" not in src:
        with open(src) as f:
            src = f.read()
    return json.loads(src)


def tuned_artifact(spec: RetrievalSpec, objectives: dict, *, frontier=(),
                   calibration: Optional[dict] = None,
                   provenance: Optional[dict] = None) -> dict:
    """The tuned-spec artifact: the chosen spec, its fingerprint (the seal),
    its objectives, and the ``(spec, objectives)`` frontier it came from."""
    return {
        "kind": TUNED_ARTIFACT_KIND,
        "tuned_spec": spec.to_dict(),
        "spec_fingerprint": spec.fingerprint(),
        "objectives": dict(objectives),
        "frontier": [{"spec": s.to_dict(), "spec_fingerprint": s.fingerprint(), **o}
                     for s, o in frontier],
        "calibration": dict(calibration or {}),
        "provenance": {"tool": "repro.core.autotune", **(provenance or {})},
    }


def load_tuned_artifact(src) -> tuple[RetrievalSpec, dict]:
    """``(spec, artifact)`` from a tuned-spec artifact (path, JSON or dict).

    ``ValueError`` on an unknown ``kind`` or when the recorded
    ``spec_fingerprint`` does not match the embedded spec (it was edited).
    """
    doc = _doc(src)
    kind = doc.get("kind")
    if kind != TUNED_ARTIFACT_KIND:
        raise ValueError(f"not a tuned-spec artifact (kind={kind!r}; "
                         f"expected {TUNED_ARTIFACT_KIND!r})")
    spec = RetrievalSpec.from_dict(doc["tuned_spec"])
    if spec.fingerprint() != doc.get("spec_fingerprint"):
        raise ValueError(
            f"tuned-spec fingerprint mismatch: artifact says {doc.get('spec_fingerprint')!r} "
            f"but the embedded spec hashes to {spec.fingerprint()!r}; the artifact was "
            f"edited after tuning")
    return spec, doc


def learned_artifact(spec: RetrievalSpec, weights: dict, objectives: dict, *,
                     anchor: Optional[dict] = None, candidates=(),
                     calibration: Optional[dict] = None,
                     provenance: Optional[dict] = None) -> dict:
    """The learned-construction-distance artifact: the weights and the spec
    whose ``build_policy`` is ``learned(<their fingerprint>)``, both sealed."""
    wfp = learned_weights_fingerprint(weights)
    if spec.build_policy.kind != "learned" or spec.build_policy.ref != wfp:
        raise ValueError(f"spec build_policy {spec.build_policy} does not reference the "
                         f"sealed weights (fingerprint {wfp})")
    return {
        "kind": LEARNED_ARTIFACT_KIND,
        "spec": spec.to_dict(),
        "spec_fingerprint": spec.fingerprint(),
        "weights": dict(weights),
        "weights_fingerprint": wfp,
        "objectives": dict(objectives),
        "anchor": dict(anchor or {}),
        "candidates": [dict(c) for c in candidates],
        "calibration": dict(calibration or {}),
        "provenance": {"tool": "repro.core.learned", **(provenance or {})},
    }


def load_learned_artifact(src) -> tuple[RetrievalSpec, dict]:
    """``(spec, artifact)`` from a learned-weights artifact; registers the weights.

    Three seals: the weights' recomputed fingerprint equals the recorded
    one, the spec's ``build_policy`` references exactly those weights, and
    the spec's fingerprint equals the recorded one.
    """
    doc = _doc(src)
    kind = doc.get("kind")
    if kind != LEARNED_ARTIFACT_KIND:
        raise ValueError(f"not a learned-weights artifact (kind={kind!r}; "
                         f"expected {LEARNED_ARTIFACT_KIND!r})")
    weights = doc.get("weights")
    if not isinstance(weights, dict):
        raise ValueError("learned artifact carries no weights dict")
    wfp = learned_weights_fingerprint(weights)
    if wfp != doc.get("weights_fingerprint"):
        raise ValueError(
            f"learned weights fingerprint mismatch: artifact says "
            f"{doc.get('weights_fingerprint')!r} but the embedded weights hash to {wfp!r}; "
            f"the artifact was edited after training")
    spec = RetrievalSpec.from_dict(doc["spec"])
    if spec.build_policy.kind != "learned" or spec.build_policy.ref != wfp:
        raise ValueError(f"learned artifact spec build_policy {spec.build_policy} does not "
                         f"reference the sealed weights ({wfp})")
    if spec.fingerprint() != doc.get("spec_fingerprint"):
        raise ValueError(
            f"learned-spec fingerprint mismatch: artifact says "
            f"{doc.get('spec_fingerprint')!r} but the embedded spec hashes to "
            f"{spec.fingerprint()!r}")
    register_learned_weights(weights, fingerprint=wfp)
    return spec, doc


def load_spec(src) -> RetrievalSpec:
    """A ``RetrievalSpec`` from a plain spec, a tuned-spec artifact or a
    learned-weights artifact (a path, a JSON string or a dict), each seal
    checked: what ``launch/serve.py --spec`` reads."""
    doc = _doc(src)
    if doc.get("kind") == TUNED_ARTIFACT_KIND:
        return load_tuned_artifact(doc)[0]
    if doc.get("kind") == LEARNED_ARTIFACT_KIND:
        return load_learned_artifact(doc)[0]
    return RetrievalSpec.from_dict(doc)


# ---------------------------------------------------------------------------
# QoS demotion ladders (per-request class -> operating point)
# ---------------------------------------------------------------------------

# the knobs a demotion rung may vary: everything else (the distance scenario,
# the construction, k/k_c, the scheduler's shape) is pinned to the serving spec
_LADDER_SEARCH_FIELDS = ("ef_search", "frontier", "adaptive", "patience")


def _ladder_key(spec: RetrievalSpec) -> str:
    d = spec.to_dict()
    for f in _LADDER_SEARCH_FIELDS:
        d.pop(f)
    return json.dumps(d, sort_keys=True)


def demotion_ladder(spec: RetrievalSpec, source=None, *, max_rungs: int = 3,
                    floor_ef: Optional[int] = None) -> list[RetrievalSpec]:
    """Operating points for SLO admission, full fidelity first, cheapest last.

    Rung 0 is ``spec``.  ``source`` (a tuned-spec artifact: path, JSON or
    dict) supplies the cheaper rungs from its Pareto frontier: the entries
    whose every field but the search knobs equals ``spec``'s and whose
    ``ef_search`` lies in ``[floor, spec.ef_search)``, most expensive first.
    Without a source, or when no entry qualifies, ``ef_search`` is halved
    down to the floor.  The floor is ``max(k, k_c, floor_ef or 16)``.
    """
    floor = max(spec.k, spec.k_c or spec.k, 16 if floor_ef is None else int(floor_ef))
    rungs = [spec]
    if source is not None:
        if not (isinstance(source, dict) and "frontier" in source):
            _, source = load_tuned_artifact(source)
        key = _ladder_key(spec)
        cands: dict = {}
        for entry in source.get("frontier", ()):
            try:
                s = RetrievalSpec.from_dict(entry["spec"])
            except (KeyError, TypeError, ValueError):
                continue
            if _ladder_key(s) != key or not floor <= s.ef_search < spec.ef_search:
                continue
            cands.setdefault((s.ef_search, s.adaptive), s)
        for ef_a in sorted(cands, key=lambda t: (-t[0], t[1])):
            if len(rungs) >= max_rungs:
                break
            rungs.append(cands[ef_a])
    if len(rungs) == 1:
        e = spec.ef_search // 2
        while len(rungs) < max_rungs and e >= floor:
            rungs.append(spec.replace(ef_search=e))
            e //= 2
    return rungs


def class_spec(ladder: list[RetrievalSpec], priority: int) -> RetrievalSpec:
    """The spec of QoS class ``priority`` (0 = highest): ladder rung
    ``min(priority, len(ladder) - 1)``, where admission starts its walk."""
    return ladder[min(max(int(priority), 0), len(ladder) - 1)]
