"""Learned construction distances (PyTorch port of ``repro.core.learned``).

The paper ends at "designing index-specific graph-construction distance
functions"; this module learns one on a calibration sample:

  1. fit a low-rank Mahalanobis map ``L`` by margin ranking against
     ``knn_scan`` ground truth under the ORIGINAL distance
     (``metric_learning.fit_mahalanobis_map``), and measure the scales that
     make the candidate betas unit-free (``learned_terms``);
  2. assemble a small family over
     ``alpha * d(u,v) + (1-alpha) * proxy(d(v,u)) + beta * ||L^T(u-v)||^2``
     (blend alphas x Mahalanobis betas x an optional rankblend proxy at the
     data-calibrated tau), always including the degenerate clone of the
     hand anchor (``alpha = hand_alpha, beta = 0, tau = None``), which
     ``LearnedDistance`` evaluates with the same arithmetic as the blend;
  3. measure every candidate AS a construction distance: build with it
     (the same build draws for every candidate), search under the original
     distance, score recall against ``knn_scan``;
  4. select the best candidate whose eval cost does not exceed the
     anchor's, and seal its weights into a fingerprint-checked artifact
     (``spec.learned_artifact``) that ``load_spec`` / ``serve.py --spec`` read.

The builds and searches score through ``gather_scores`` (and the NN-descent
kernels under that builder), the ground truth through ``distance_matrix``.
``_median_scales``' sample matrix stays a plain matmul, as in ``repro``.
``terms`` and ``entries`` replace the fitted terms and the shared build's
entry points (a test feeds the JAX package's).
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.autotune import fold_seed
from repro_torch.core.brute_force import knn_scan
from repro_torch.core.index import ANNIndex
from repro_torch.core.metric_learning import fit_mahalanobis_map
from repro_torch.core.metrics import recall_at_k
from repro_torch.core.spec import Blend, Learned, RetrievalSpec, learned_artifact
from repro_torch.core.symmetrize import calibrate_tau, learned_weights_fingerprint, median
from repro_torch.kernels.ref import exact_float32_matmul


def mahalanobis_weights(L, alpha: float, beta: float, tau: Optional[float] = None) -> dict:
    """Plain-JSON learned-weights dict (the registry / artifact currency).

    ``L`` may be None (no Mahalanobis term; required when ``beta == 0``) or an
    (m, rank) tensor or array, stored as nested float32 lists so the content
    fingerprint is platform-stable.
    """
    if beta != 0.0 and L is None:
        raise ValueError("beta != 0 requires a Mahalanobis map L")
    if isinstance(L, torch.Tensor):
        L = L.detach().cpu().numpy()
    return {
        "alpha": float(alpha),
        "beta": float(beta),
        "tau": None if tau is None else float(tau),
        "L": None if L is None or beta == 0.0 else np.asarray(L, np.float32).tolist(),
    }


def _median_scales(dist, L, X, *, max_rows: int = 256):
    """(median |base distance|, median mapped-L2 distance) over a strided
    sample: the scale normalizer that makes candidate betas unit-free."""
    n = int(X.shape[0])
    stride = max(1, n // max_rows)
    S = X[::stride][:max_rows]
    m = int(S.shape[0])
    off = ~torch.eye(m, dtype=torch.bool, device=S.device)
    with exact_float32_matmul():
        med_base = median(torch.abs(dist.matrix(S, S)[off]))
        Z = S @ torch.as_tensor(L, dtype=torch.float32, device=S.device)
        n2 = torch.sum(Z * Z, dim=1)
        D = torch.clamp(n2[:, None] - 2.0 * (Z @ Z.T) + n2[None, :], min=0.0)
        med_maha = median(D[off])
    return med_base, med_maha


class LearnedTerms(NamedTuple):
    """What the candidate family is built from."""

    L: torch.Tensor  # (m, rank) the fitted Mahalanobis map
    beta_unit: float  # median base distance / median mapped distance (0: no maha term)
    tau_cal: float  # the data-calibrated rankblend tau


def learned_terms(X, dist, generator=None, *, rank: int = 16, steps: int = 150,
                  n_anchors: int = 256, k_pos: int = 10) -> LearnedTerms:
    """Fit the map and measure the scales on the database X."""
    L = fit_mahalanobis_map(X, dist, generator, rank=rank, steps=steps, n_anchors=n_anchors,
                            k_pos=k_pos)
    med_base, med_maha = _median_scales(dist, L, X)
    beta_unit = med_base / med_maha if med_maha > 0.0 and med_base > 0.0 else 0.0
    return LearnedTerms(L, beta_unit, calibrate_tau(dist, X))


@dataclasses.dataclass(frozen=True)
class LearnedResult:
    """Outcome of ``fit_construction_distance``.

    ``spec`` is the winning learned spec (build_policy = ``learned(<fp>)``
    with the weights registered); ``candidates`` records every measured row
    (weights fingerprint, policy string, recall, evals); ``anchor`` is the
    hand combinator's row.
    """

    spec: RetrievalSpec
    weights: dict
    fingerprint: str  # weights content fingerprint (== spec build_policy ref)
    objectives: dict
    anchor: dict
    candidates: tuple
    calibration: dict

    def artifact(self) -> dict:
        return learned_artifact(
            self.spec, self.weights, self.objectives, anchor=self.anchor,
            candidates=self.candidates, calibration=self.calibration,
            provenance={"selection": "max recall s.t. evals <= anchor evals"},
        )

    def save(self, path: str) -> dict:
        art = self.artifact()
        with open(path, "w") as f:
            json.dump(art, f, indent=1)
        return art


def fit_construction_distance(
    X,
    Q_cal,
    *,
    base: RetrievalSpec,
    dist=None,
    natural=None,
    hand_policy=None,
    rank: int = 16,
    steps: int = 150,
    n_anchors: int = 256,
    k_pos: int = 10,
    alphas=(0.5, 0.75, 1.0),
    betas=(0.25, 1.0),
    with_rank_proxy: bool = True,
    seed: int = 0,
    verbose: bool = True,
    terms: Optional[LearnedTerms] = None,
    entries: Optional[torch.Tensor] = None,
) -> LearnedResult:
    """Learn an index-specific construction distance on a calibration sample.

    Args:
        X: (n, m) float32 database rows on the device to fit on.
        Q_cal: (B, m) calibration queries on the same device (keep a
            holdout for honesty checks).
        base: the scenario everything else is pinned to (builder, engine, k,
            ef_search); its ``build_policy`` is ignored.
        dist: explicit base distance (e.g. a ``ViewedDistance``); default
            ``base.base_distance()``.
        natural: forwarded to ``ANNIndex.build`` for ``natural`` policies.
        hand_policy: the hand combinator to anchor against (default
            ``Blend(0.75)``); alpha must not be one of Blend's lowered
            special cases {0, 0.5, 1} for the clone's parity to be exact.
        rank / steps / n_anchors / k_pos: ``fit_mahalanobis_map`` knobs.
        alphas / betas: the candidate grid; betas are unit-free.
        with_rank_proxy: also try rankblend-compressed variants at tau_cal.
        seed: seeds the fit's draws and the build draws every candidate shares.
        terms: the fitted ``LearnedTerms``, replacing the fit and its draws.
        entries: (E,) entry points replacing the shared build's.

    Returns:
        A ``LearnedResult`` whose recall is >= the anchor's at no more
        distance evals per query (the anchor's clone is in the family).
    """
    if dist is None:
        dist = base.base_distance()
    hand_policy = hand_policy if hand_policy is not None else Blend(0.75)
    hand_alpha = float(hand_policy.alpha if hand_policy.alpha is not None else 1.0)
    dev = X.device

    # -- 1. fit the low-rank Mahalanobis map on true neighbourhoods ----------
    if terms is None:
        terms = learned_terms(
            X, dist, torch.Generator(device=dev).manual_seed(fold_seed(seed, "fit")),
            rank=rank, steps=steps, n_anchors=n_anchors, k_pos=k_pos)
    L, beta_unit, tau_cal = terms

    # -- 2. candidate family (the degenerate anchor clone ALWAYS included) ---
    cand_weights = [mahalanobis_weights(None, hand_alpha, 0.0)]
    if beta_unit > 0.0:
        for a in alphas:
            for b in betas:
                cand_weights.append(mahalanobis_weights(L, a, b * beta_unit))
        if with_rank_proxy:
            for a in alphas:
                if a < 1.0:  # tau only touches the reverse branch
                    cand_weights.append(
                        mahalanobis_weights(L, a, betas[0] * beta_unit, tau=tau_cal))
    seen: dict = {}
    for w in cand_weights:
        seen.setdefault(learned_weights_fingerprint(w), w)

    # -- 3. measure the anchor and every candidate on the same build draws ---
    _, true_ids = knn_scan(dist, Q_cal, X, base.k)
    true_np = true_ids.cpu().numpy()
    build_seed = fold_seed(seed, "build")

    def measure(spec):
        idx = ANNIndex.build(X, dist, spec=spec, natural=natural,
                             generator=torch.Generator(device=dev).manual_seed(build_seed))
        if entries is not None:
            idx.entries = entries.to(device=dev, dtype=torch.int32)
        _, ids, n_evals, _ = idx.searcher(spec=spec)(Q_cal)
        # one host read per candidate
        host = torch.cat([ids, n_evals[:, None].to(ids.dtype)], dim=1)
        host = host.cpu().numpy()  # jaxlint: disable=JL003 (per-candidate)
        return {
            "recall": round(recall_at_k(host[:, :-1], true_np), 4),
            "evals_per_query": round(float(np.mean(host[:, -1])), 1),
            "spec_fingerprint": spec.fingerprint(),
        }

    anchor = {"policy": str(hand_policy), **measure(base.replace(build_policy=hand_policy))}
    if verbose:
        print(f"[learned] anchor {hand_policy}: recall={anchor['recall']:.4f} "
              f"evals={anchor['evals_per_query']:.0f}")

    rows = []
    for fp, w in sorted(seen.items()):
        spec = base.replace(build_policy=Learned(w))
        row = {"policy": str(spec.build_policy), "weights_fingerprint": fp, "weights": w,
               **measure(spec)}
        rows.append(row)
        if verbose:
            tag = ("clone" if w["beta"] == 0.0 else
                   f"a={w['alpha']:g} b={w['beta']:.3g}"
                   + (f" tau={w['tau']:.3g}" if w["tau"] is not None else ""))
            print(f"[learned] cand {fp} ({tag}): recall={row['recall']:.4f} "
                  f"evals={row['evals_per_query']:.0f}")

    # -- 4. select: max recall subject to evals <= anchor evals --------------
    eligible = [r for r in rows if r["evals_per_query"] <= anchor["evals_per_query"]]
    if not eligible:
        raise AssertionError(
            "no learned candidate within the anchor's eval budget: the degenerate clone "
            "should always qualify (bit-parity broken?)")
    best = min(eligible, key=lambda r: (-r["recall"], r["evals_per_query"], r["policy"]))
    if best["recall"] < anchor["recall"]:
        raise AssertionError(
            f"learned selection lost to the anchor ({best['recall']} < {anchor['recall']}): "
            "the clone guarantee is broken")

    weights = best["weights"]
    spec = base.replace(build_policy=Learned(weights))
    candidates = tuple({k: v for k, v in r.items() if k != "weights"} for r in rows)
    objectives = {k: best[k] for k in ("recall", "evals_per_query")}
    calibration = {
        "n_db": int(X.shape[0]), "n_cal_queries": int(Q_cal.shape[0]),
        "dim": int(X.shape[1]), "k": base.k, "rank": int(min(rank, X.shape[1])),
        "steps": steps, "n_anchors": n_anchors, "k_pos": k_pos,
        "beta_unit": round(beta_unit, 6), "tau_cal": round(tau_cal, 6),
        "seed": seed,
    }
    return LearnedResult(spec=spec, weights=weights, fingerprint=best["weights_fingerprint"],
                         objectives=objectives, anchor=anchor, candidates=candidates,
                         calibration=calibration)
