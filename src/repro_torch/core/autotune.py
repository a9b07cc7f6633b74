"""Spec auto-tuner (PyTorch port of ``repro.core.autotune``).

Successive-halving Pareto search over ``RetrievalSpec.grid()``: the
construction blend alpha x ef_search x frontier x wave x adaptive patience.

  * candidates come from ``base.grid(**axes)`` plus always-kept ``anchors``
    (e.g. the hand-tuned incumbent a bench wants to beat);
  * rung r evaluates the survivors on a subsampled workload (a fixed
    permutation prefix of the database, a prefix of the calibration
    queries);
  * after each rung, configs outside the (recall, evals, build-cost) Pareto
    frontier are pruned and the frontier is capped to a ``keep`` fraction;
  * specs that differ only in search knobs share one index per rung;
  * the final rung runs at full size and yields the Pareto frontier and a
    tuned spec, exported as a fingerprint-sealed artifact
    (``spec.tuned_artifact``) that ``launch/serve.py --spec`` and
    ``ANNIndex.build(spec=...)`` read.

Objectives per candidate: ``recall`` (recall@k against ``knn_scan`` of the
rung's database), ``evals_per_query`` (mean distance evaluations, the
paper's hardware-free cost) and ``build_cost`` (``build_cost_proxy``, the
sequential dispatch depth).  Everything is deterministic under a fixed
``seed``: the rung permutation and each build group's generator are seeded
from sha256 digests of the seed and the group's build fields (``fold_seed``),
and promotion ties end on the spec fingerprint.

The database stays on its device: each rung indexes it with the
permutation there; each candidate reads its ids and eval counts to the host
once.  Scoring goes through the index's kernels (``gather_scores`` for the
builds and searches, ``distance_matrix`` for each rung's ground truth).
``TuneDraws`` replaces the permutation and each build's entry points (a
test feeds the JAX package's).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.brute_force import knn_scan
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.spec import Blend, RetrievalSpec, pareto_frontier, tuned_artifact

# objective directions (keys of every Candidate.objectives dict)
MAXIMIZE = ("recall",)
MINIMIZE = ("evals_per_query", "build_cost")

# spec fields that change the BUILT GRAPH; specs agreeing on all of them
# share one index per rung (search knobs re-use it)
_BUILD_FIELDS = (
    "distance", "build_policy", "builder", "build_engine", "wave",
    "build_frontier", "NN", "ef_construction", "M_max", "nnd_iters",
    "n_entries",
)


def default_axes(quick: bool = False) -> dict:
    """The five tuning axes with their sweep values (``quick``: fewer values)."""
    if quick:
        return dict(
            build_policy=[Blend(a) for a in (0.0, 0.25, 0.5, 0.75, 1.0)],
            ef_search=[16, 32],
            frontier=[1, 2],
            adaptive=[False, True],
        )
    return dict(
        build_policy=[Blend(a) for a in (0.0, 0.25, 0.5, 0.75, 1.0)],
        ef_search=[16, 32, 96],
        frontier=[1, 2],
        wave=[32, 64],
        adaptive=[False, True],
        patience=[1, 2],
    )


def build_cost_proxy(spec: RetrievalSpec, n: int) -> float:
    """Deterministic construction-cost proxy: sequential dispatch depth.

        swgraph/wave        ceil(n / wave) * ef_construction
        swgraph/sequential  n * ef_construction
        nndescent           nnd_iters * NN  (refinement rounds x row width)

    Only comparable within one builder family.
    """
    if spec.builder == "swgraph":
        rounds = n if spec.build_engine == "sequential" else math.ceil(n / spec.wave)
        return float(rounds * spec.ef_construction)
    return float(spec.nnd_iters * spec.NN)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One evaluated configuration: a concrete spec + measured objectives."""

    spec: RetrievalSpec
    objectives: dict  # recall / evals_per_query / build_cost

    @property
    def fingerprint(self) -> str:
        return self.spec.fingerprint()


@dataclasses.dataclass
class TuneResult:
    """Everything ``autotune`` measured, plus selection and export.

    ``candidates``: the final rung's evaluations in grid order; ``frontier``:
    their (recall, evals_per_query, build_cost) Pareto subset; ``history``:
    one ``{"n", "n_queries", "evaluated", "survivors"}`` record per rung
    (fingerprint lists); ``calibration``: the workload and the resolved
    rankblend tau.
    """

    base: RetrievalSpec
    candidates: list[Candidate]
    frontier: list[Candidate]
    history: list[dict]
    calibration: dict

    def lookup(self, spec: RetrievalSpec) -> Candidate:
        """Final-rung candidate for ``spec`` (by fingerprint; KeyError if the
        spec was pruned before the final rung or never in the grid)."""
        fp = _canonical(spec).fingerprint()
        for c in self.candidates:
            if c.fingerprint == fp:
                return c
        raise KeyError(f"spec {fp} not in the final rung")

    def pick(self, max_evals: Optional[float] = None) -> Candidate:
        """The tuned spec: among final-rung candidates within ``max_evals``
        mean evaluations per query, the highest recall, then the fewest
        evals, then the lowest build cost, then the fingerprint.
        ``ValueError`` when no candidate fits the budget."""
        elig = [c for c in self.candidates
                if max_evals is None or c.objectives["evals_per_query"] <= max_evals]
        if not elig:
            raise ValueError(
                f"no candidate within evals budget {max_evals}; frontier minimum is "
                f"{min(c.objectives['evals_per_query'] for c in self.candidates)}")
        return min(elig, key=_choice_order)

    def artifact(self, choice: Optional[Candidate] = None) -> dict:
        """Fingerprint-sealed tuned-spec artifact (``spec.tuned_artifact``)."""
        choice = choice if choice is not None else self.pick()
        return tuned_artifact(
            choice.spec,
            choice.objectives,
            frontier=[(c.spec, c.objectives) for c in self.frontier],
            calibration=self.calibration,
            provenance={
                "rungs": [dict(n=h["n"], n_queries=h["n_queries"],
                               evaluated=len(h["evaluated"]), survivors=len(h["survivors"]))
                          for h in self.history],
                "grid_size": len(self.history[0]["evaluated"]),
            },
        )

    def save(self, path: str, choice: Optional[Candidate] = None) -> dict:
        """Write ``artifact(choice)`` as JSON; returns the artifact dict."""
        art = self.artifact(choice)
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
            f.write("\n")
        return art


@dataclasses.dataclass(frozen=True)
class TuneDraws:
    """Replacements for the random draws of one ``autotune`` call."""

    perm: torch.Tensor  # (n,) the rung subsample permutation
    # (rung, spec, X_r) -> (E,) int32 entry points of that rung's build of spec
    entries: Callable


def fold_seed(seed: int, *parts) -> int:
    """A 63-bit generator seed from ``seed`` and any hashable parts (sha256)."""
    blob = "\x1f".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(blob).digest()[:8], "big") >> 1


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _choice_order(c: Candidate):
    return (-c.objectives["recall"], c.objectives["evals_per_query"],
            c.objectives["build_cost"], c.fingerprint)


def _canonical(spec: RetrievalSpec) -> RetrievalSpec:
    """Collapse knobs that cannot affect results so the grid deduplicates:
    adaptive is dead at ``frontier == 1``, patience when adaptive is off."""
    if spec.frontier <= 1 and spec.adaptive:
        spec = spec.replace(adaptive=False)
    if not spec.adaptive and spec.patience != 1:
        spec = spec.replace(patience=1)
    return spec


def _build_key(spec: RetrievalSpec) -> tuple:
    return tuple(str(getattr(spec, f)) for f in _BUILD_FIELDS)


def _rung_sizes(n: int, n_q: int, rungs: int, min_n: int, min_q: int):
    """Geometric (database, query) subsample schedule ending at full size."""
    out = []
    for r in range(rungs):
        shift = rungs - 1 - r
        out.append((min(n, max(min_n, n >> shift)), min(n_q, max(min_q, n_q >> shift))))
    # collapse rungs that saturated to the same size (tiny workloads)
    dedup = []
    for size in out:
        if not dedup or size != dedup[-1]:
            dedup.append(size)
    return dedup


def _evaluate_rung(specs: Sequence[RetrievalSpec], X, Q, k: int, seed: int, verbose: bool,
                   tag: str, dist=None, natural=None, entries=None) -> list[Candidate]:
    """Build (shared per build group) + search + score every spec on (X, Q).

    ``entries(spec)`` replaces a build's entry points."""
    from repro_torch.core.index import ANNIndex  # local: index imports spec, avoid a cycle

    n = int(X.shape[0])
    dist = dist if dist is not None else specs[0].base_distance()
    _, true_ids = knn_scan(dist, Q, X, k)
    true_np = true_ids.cpu().numpy()

    builds: dict[tuple, object] = {}
    out = []
    for spec in specs:
        bk = _build_key(spec)
        idx = builds.get(bk)
        if idx is None:
            idx = ANNIndex.build(X, dist, spec=spec, natural=natural,
                                 generator=_generator(fold_seed(seed, "build", *bk), X.device))
            if entries is not None:
                idx.entries = entries(spec).to(device=X.device, dtype=torch.int32)
            builds[bk] = idx
        _, ids, n_evals, _ = idx.searcher(spec=spec)(Q)
        # one host read per candidate spec by design: successive halving
        # scores each configuration on the host before pruning the rung
        host = torch.cat([ids, n_evals[:, None].to(ids.dtype)], dim=1)
        host = host.cpu().numpy()  # jaxlint: disable=JL003 (per-candidate)
        obj = {
            "recall": round(recall_at_k(host[:, :-1], true_np), 4),
            "evals_per_query": round(float(np.mean(host[:, -1])), 1),
            "build_cost": build_cost_proxy(spec, n),
        }
        out.append(Candidate(spec, obj))
        if verbose:
            print(f"[autotune/{tag}] {spec.build_policy} ef={spec.ef_search} "
                  f"T={spec.frontier} wave={spec.wave} "
                  f"adaptive={int(spec.adaptive)}/p{spec.patience}: "
                  f"recall={obj['recall']:.4f} evals={obj['evals_per_query']:.0f} "
                  f"build~{obj['build_cost']:.0f}")
    return out


def autotune(X, Q, *, base: Optional[RetrievalSpec] = None, axes: Optional[dict] = None,
             anchors: Sequence[RetrievalSpec] = (), k: int = 10, rungs: int = 3,
             keep: float = 0.4, min_rung_n: int = 256, min_rung_q: int = 16, dist=None,
             natural=None, seed: int = 0, verbose: bool = True,
             draws: Optional[TuneDraws] = None) -> TuneResult:
    """Successive-halving Pareto-frontier search over ``base.grid(**axes)``.

    Args:
        X: (n, m) float32 database on the device to tune on (full size;
            rungs subsample it there).
        Q: (B, m) calibration queries on the same device (not the queries
            held-out numbers are later reported on).
        base: the spec the axes pivot around (default ``RetrievalSpec(k=k)``).
        axes: ``grid()`` axes; default ``default_axes()``.
        anchors: specs evaluated at every rung regardless of dominance
            (e.g. the hand-tuned incumbent).
        k: neighbours per query (recall@k is the quality objective).
        rungs: subsample rungs (the last always runs at full size).
        keep: survivor fraction cap per rung.
        min_rung_n / min_rung_q: floors of the subsample schedule.
        dist: explicit base distance (e.g. a ``ViewedDistance``); default
            ``base.base_distance()``.
        natural: forwarded to ``ANNIndex.build`` for ``natural`` policies.
        seed: fixed seed => identical history, frontier and choice.
        draws: the rung permutation and each build's entry points, replacing
            the draws from ``seed``.
    """
    base = base if base is not None else RetrievalSpec()
    base = _canonical(base.replace(k=k))
    axes = axes if axes is not None else default_axes()
    n, n_q = int(X.shape[0]), int(Q.shape[0])

    # resolve data-calibrated parameters ONCE against the full database so
    # every evaluated spec is concrete and the artifact reproducible
    dist = dist if dist is not None else base.base_distance()
    tau_cal = None

    def _resolve(spec: RetrievalSpec) -> RetrievalSpec:
        nonlocal tau_cal
        changes = {}
        for field in ("build_policy", "search_policy"):
            pol = getattr(spec, field)
            if pol.kind == "rankblend" and pol.tau is None:
                if tau_cal is None:
                    tau_cal = pol.resolve(dist, X).tau
                changes[field] = dataclasses.replace(pol, tau=tau_cal)
        return spec.replace(**changes) if changes else spec

    survivors: list[RetrievalSpec] = []
    seen = set()
    for spec in list(base.grid(**axes)) + list(anchors):
        spec = _resolve(_canonical(spec))
        if spec.distance != base.distance:
            raise ValueError("autotune sweeps one base distance at a time")
        fp = spec.fingerprint()
        if fp not in seen:
            seen.add(fp)
            survivors.append(spec)
    anchor_fps = {_resolve(_canonical(a)).fingerprint() for a in anchors}

    if draws is not None:
        perm = draws.perm.to(X.device).long()
    else:
        perm = torch.randperm(n, generator=_generator(fold_seed(seed, "perm"), X.device),
                              device=X.device)
    sizes = _rung_sizes(n, n_q, rungs, min_rung_n, min_rung_q)

    history: list[dict] = []
    cands: list[Candidate] = []
    for r, (n_r, q_r) in enumerate(sizes):
        final = r == len(sizes) - 1
        X_r = X[perm[:n_r]] if not final else X
        Q_r = Q[:q_r] if not final else Q
        entries = None
        if draws is not None:
            entries = (lambda spec, r=r, X_r=X_r: draws.entries(r, spec, X_r))
        cands = _evaluate_rung(survivors, X_r, Q_r, k, fold_seed(seed, "rung", r), verbose,
                               f"rung{r} n={X_r.shape[0]}", dist=dist, natural=natural,
                               entries=entries)
        record = {"n": int(X_r.shape[0]), "n_queries": int(Q_r.shape[0]),
                  "evaluated": [c.fingerprint for c in cands]}
        if not final:
            front = pareto_frontier(cands, maximize=MAXIMIZE, minimize=MINIMIZE,
                                    key=lambda c: c.objectives)
            cap = max(4, math.ceil(len(cands) * keep))
            promoted = sorted(front, key=_choice_order)[:cap]
            kept = {c.fingerprint for c in promoted}
            # anchors ride every rung: the incumbent must reach the final
            # rung even if a cheap proxy rung briefly dominates it
            promoted += [c for c in cands
                         if c.fingerprint in anchor_fps and c.fingerprint not in kept]
            survivors = [c.spec for c in promoted]
            record["survivors"] = [c.fingerprint for c in promoted]
        else:
            record["survivors"] = [c.fingerprint for c in cands]
        history.append(record)
        if verbose:
            print(f"[autotune] rung {r}: {len(record['evaluated'])} evaluated "
                  f"-> {len(record['survivors'])} promoted "
                  f"(n={record['n']}, q={record['n_queries']})")

    frontier = pareto_frontier(cands, maximize=MAXIMIZE, minimize=MINIMIZE,
                               key=lambda c: c.objectives)
    calibration = {
        "n_db": n, "n_queries": n_q, "k": k, "distance": base.distance,
        "seed": seed, "rungs": [list(s) for s in sizes],
        "rankblend_tau": tau_cal,
    }
    return TuneResult(base=base, candidates=cands, frontier=frontier, history=history,
                      calibration=calibration)
