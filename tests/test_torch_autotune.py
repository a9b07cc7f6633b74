"""Port parity for the spec auto-tuner (``repro_torch.core.autotune``).

``tests/test_autotune.py``'s workload (KL, n = 420, 24 queries, d = 16,
K = 5, SW-graph wave 32, NN 8, ef_construction 40) runs through both
packages on the same arrays, with ``repro``'s rung permutation and each
build's entry points replayed into the port (``TuneDraws``: torch cannot
replay ``jax.random``).  The promotion history (evaluated and survivors per
rung), every final candidate's recall, evals per query and build cost, the
frontier, the pick under the hand budget and the artifact are then EQUAL to
``repro``'s.  With a ``Learned`` policy on the grid the port prunes the
learned candidate at rung 0, as ``repro`` does: there it recalls as much
as the anchor at more evals and the same build cost, so it is
Pareto-dominated (the cause of ``test_learned_policy_as_grid_axis``'s seed
failure).  Determinism, ``pick``'s budget error and artifacts that cross-load
between the packages close the file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Blend as JBlend
from repro.core import Learned as JLearned
from repro.core import RetrievalSpec as JSpec
from repro.core import autotune as jautotune
from repro.core import load_spec as jload_spec
from repro.core import mahalanobis_weights as jweights
from repro.core.autotune import _fold as jfold
from repro.core.batched_beam import select_entries as jselect_entries
from repro.core.distances import get_distance as jget_distance
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch.core.autotune import TuneDraws, _build_key, _rung_sizes, autotune, fold_seed
from repro_torch.core.distances import get_distance
from repro_torch.core.learned import mahalanobis_weights
from repro_torch.core.spec import Blend, Learned, RetrievalSpec, load_spec

N_DB, N_Q, DIM, K = 420, 24, 16, 5
BASE_KW = dict(distance="kl", builder="swgraph", build_engine="wave", wave=32, NN=8,
               ef_construction=40, k=K, frontier=1)
BASE, JBASE = RetrievalSpec(**BASE_KW), JSpec(**BASE_KW)
HAND, JHAND = (b.replace(build_policy=p(0.75), ef_search=24)
               for b, p in ((BASE, Blend), (JBASE, JBlend)))
ALPHAS = (0.0, 0.5, 0.75, 1.0)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores (the port's lock-step loops run ~10x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workload():
    X = lda_like_histograms(jax.random.PRNGKey(0), N_DB + N_Q, DIM)
    Q, db = split_queries(X, N_Q, jax.random.PRNGKey(1))
    return np.asarray(db), np.asarray(Q)


def _t(a):
    return torch.from_numpy(np.array(a))


def repro_draws(seed: int, n: int, jdist) -> TuneDraws:
    """``repro``'s rung permutation and, per (rung, build group), the entry
    points its ``ANNIndex.build`` selects from the group's folded key."""
    key = jax.random.PRNGKey(seed)
    perm = np.asarray(jax.random.permutation(jfold(key, "perm"), n))

    def entries(rung, spec, X_r):
        bkey = jfold(jfold(key, "rung", rung), "build", *_build_key(spec))
        got = jselect_entries(jdist, jnp.asarray(X_r.numpy()), n_entries=spec.n_entries,
                              key=jax.random.fold_in(bkey, 0xE))
        return _t(got)

    return TuneDraws(perm=_t(perm), entries=entries)


def both(workload, axes, jaxes, anchors=(HAND,), janchors=(JHAND,), seed=0,
         explicit_dist=False):
    """(repro's TuneResult, the port's with repro's draws) on the workload;
    ``explicit_dist`` passes KL as ``dist=`` to both."""
    db, Q = workload
    jdist = jget_distance("kl")
    jres = jautotune(db, Q, base=JBASE, axes=jaxes, anchors=list(janchors), k=K, rungs=2,
                     seed=seed, verbose=False, dist=jdist if explicit_dist else None)
    tres = autotune(_t(db), _t(Q), base=BASE, axes=axes, anchors=list(anchors), k=K, rungs=2,
                    seed=seed, verbose=False,
                    dist=get_distance("kl") if explicit_dist else None,
                    draws=repro_draws(seed, db.shape[0], jdist))
    return jres, tres


@pytest.fixture(scope="module")
def tuned_pair(workload):
    axes = dict(build_policy=[Blend(a) for a in ALPHAS], ef_search=[12, 24],
                adaptive=[False, True])
    jaxes = dict(axes, build_policy=[JBlend(a) for a in ALPHAS])
    return both(workload, axes, jaxes)


def test_rung_schedule_and_build_cost_match_repro():
    from repro.core.autotune import _rung_sizes as jrung_sizes
    from repro.core.autotune import build_cost_proxy as jcost
    from repro_torch.core.autotune import build_cost_proxy

    for args in ((4096, 128, 3, 256, 16), (300, 8, 3, 256, 16), (N_DB, N_Q, 2, 256, 16),
                 (20_000, 64, 4, 256, 16)):
        assert _rung_sizes(*args) == jrung_sizes(*args)
    for engine, wave in (("wave", 64), ("wave", 32), ("sequential", 64)):
        for n in (256, 420, 4096):
            spec = BASE.replace(build_engine=engine, wave=wave)
            jspec = JBASE.replace(build_engine=engine, wave=wave)
            assert build_cost_proxy(spec, n) == jcost(jspec, n)
    assert build_cost_proxy(BASE.replace(builder="nndescent"), 420) == jcost(
        JBASE.replace(builder="nndescent"), 420)


def test_history_objectives_and_frontier_equal_repro(tuned_pair):
    jres, tres = tuned_pair
    assert tres.history == jres.history
    assert [c.fingerprint for c in tres.candidates] == [c.fingerprint for c in jres.candidates]
    assert [c.objectives for c in tres.candidates] == [c.objectives for c in jres.candidates]
    assert [c.fingerprint for c in tres.frontier] == [c.fingerprint for c in jres.frontier]
    assert tres.calibration == jres.calibration
    # successive halving pruned at rung 0, and the anchor rode every rung
    assert len(tres.history[0]["survivors"]) < len(tres.history[0]["evaluated"])
    assert all(HAND.fingerprint() in h["survivors"] for h in tres.history)


def test_pick_and_artifact_equal_repro(tuned_pair):
    jres, tres = tuned_pair
    jhand, thand = jres.lookup(JHAND), tres.lookup(HAND)
    assert thand.objectives == jhand.objectives
    budget = thand.objectives["evals_per_query"]
    tpick, jpick = tres.pick(max_evals=budget), jres.pick(max_evals=budget)
    assert tpick.fingerprint == jpick.fingerprint
    assert tpick.objectives["recall"] >= thand.objectives["recall"]
    assert tres.pick().fingerprint == jres.pick().fingerprint
    tart, jart = tres.artifact(tpick), jres.artifact(jpick)
    assert tart["spec_fingerprint"] == jart["spec_fingerprint"]
    assert json.dumps(tart, sort_keys=True) == json.dumps(jart, sort_keys=True)


def test_pick_budget_too_tight_raises(tuned_pair):
    _, tres = tuned_pair
    with pytest.raises(ValueError, match="budget"):
        tres.pick(max_evals=1.0)
    with pytest.raises(KeyError):
        tres.lookup(BASE.replace(ef_search=999))


def test_artifacts_cross_load(tuned_pair, workload, tmp_path):
    jres, tres = tuned_pair
    tpath, jpath = tmp_path / "torch_tuned.json", tmp_path / "jax_tuned.json"
    tart = tres.save(str(tpath))
    jres.save(str(jpath))
    assert jload_spec(str(tpath)).to_dict() == tres.pick().spec.to_dict()
    assert load_spec(str(jpath)).to_dict() == jres.pick().spec.to_dict()
    assert tart["calibration"]["n_db"] == N_DB
    # the artifact is directly buildable by the port
    from repro_torch.core.index import ANNIndex

    spec = load_spec(str(tpath))
    idx = ANNIndex.build(_t(workload[0]), spec=spec)
    assert idx.build_info["spec_fingerprint"] == spec.fingerprint()


def test_learned_policy_is_pruned_at_rung_0_as_in_repro(workload):
    """The seed failure of ``test_learned_policy_as_grid_axis``, held as
    ``repro`` behaves: the learned candidate recalls as much as blend(0.75)
    at more evals and the same build cost, so rung 0 prunes it."""
    L = np.asarray(jax.random.normal(jax.random.PRNGKey(9), (DIM, 4)), np.float32)
    tlearned = Learned(mahalanobis_weights(torch.from_numpy(L), 0.75, 0.1))
    jlearned = JLearned(jweights(L, 0.75, 0.1))
    assert tlearned.ref == jlearned.ref
    axes = dict(build_policy=[Blend(0.75), tlearned], ef_search=[16])
    jaxes = dict(build_policy=[JBlend(0.75), jlearned], ef_search=[16])
    hand, jhand = BASE.replace(build_policy=Blend(0.75), ef_search=16), JBASE.replace(
        build_policy=JBlend(0.75), ef_search=16)
    jres, tres = both(workload, axes, jaxes, anchors=(hand,), janchors=(jhand,),
                      explicit_dist=True)
    assert tres.history == jres.history
    assert [c.objectives for c in tres.candidates] == [c.objectives for c in jres.candidates]
    assert {c.spec.build_policy.kind for c in tres.candidates} == {"blend"}
    assert len(tres.history[0]["evaluated"]) == 2 and len(tres.history[0]["survivors"]) == 1


def test_promotion_deterministic_under_a_fixed_seed(workload):
    db, Q = workload
    axes = dict(build_policy=[Blend(0.5), Blend(1.0)], ef_search=[12])
    runs = [autotune(_t(db), _t(Q), base=BASE, axes=axes, k=K,
                     rungs=2, seed=3, verbose=False) for _ in range(2)]
    a, b = runs
    assert a.history == b.history
    assert [c.objectives for c in a.candidates] == [c.objectives for c in b.candidates]
    assert a.pick().spec == b.pick().spec
    # the seed reaches the draws: another seed permutes the rung differently
    assert fold_seed(3, "perm") != fold_seed(4, "perm")
