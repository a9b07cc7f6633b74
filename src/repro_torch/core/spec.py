"""RetrievalSpec and DistancePolicy (PyTorch port of ``repro.core.spec``).

``RetrievalSpec`` is the frozen object that describes a whole retrieval
scenario: base distance, build/search policies, builder, engine and
scheduler knobs.  Its fields, defaults, validation, JSON form and
fingerprint are those of ``repro``: ``to_json()`` and ``fingerprint()`` give
the same bytes in both packages, so a spec written by one loads in the other.

``DistancePolicy`` parses and prints every policy kind of ``repro``.  In
this slice ``bind`` lowers only ``none``; the symmetrized, combined and
learned policies come with the port of ``symmetrize.py`` (ROADMAP item M8).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import re
from typing import Optional

POLICY_KINDS = ("none", "avg", "min", "reverse", "l2", "natural",
                "max", "blend", "rankblend", "learned")

_POLICY_RE = re.compile(r"^([a-z0-9_]+)(?:\(([^)]*)\))?$")
_LEARNED_REF_RE = re.compile(r"^[0-9a-f]{12}$")

_SYMMETRIZE_ITEM = "ROADMAP item M8 (symmetrize.py policies, filter_refine.py rerank)"


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

    def bind(self, base):
        """Lower the policy over ``base``.  Only ``none`` lowers in this slice."""
        if self.is_none:
            return base
        # every other kind, named so tools/jaxlint (JL004) sees each one handled
        if self.kind in ("avg", "min", "reverse", "l2", "natural", "max", "blend",
                         "rankblend", "learned"):
            raise NotImplementedError(
                f"policy {str(self)!r} needs the symmetrized/combined distances, "
                f"not ported yet: {_SYMMETRIZE_ITEM}")
        raise ValueError(f"unknown policy kind {self.kind!r}")


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
