"""Port parity for the slot scheduler (``repro_torch.core.scheduler``), the
QoS ladder (``core.spec.demotion_ladder``) and serve's continuous path.

The data is ``tests/test_scheduler.py``'s: LDA-like histograms (N_DB 420,
N_Q 24, d 16) under KL, a ``repro`` SW-graph wave build (wave 16) carried
across by ``convert.index_from_jax``.  Against ``repro``, on the same
arrays: ids, ``n_evals``, ``hops``, ``level``, ``shed``, the rid -> response
mapping, the DRR grant order and ``t_done`` under ``run_stream``'s
``tick_cost`` clock are exactly equal; distances within rtol = atol = 1e-6
(float32 summation order, ROADMAP section 3).  Against the port's own
one-shot searcher, distances are bit-equal.  Each ``repro`` oracle runs
once per module.  The cases of ``tests/test_scheduler.py`` and
``tests/test_admission.py`` are then held on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ANNIndex, RetrievalSpec, get_distance
from repro.core import batched_beam as jbb
from repro.core import scheduler as jsched
from repro.core import spec as jspec
from repro.data.synthetic import lda_like_histograms, split_queries
from repro.launch import serve as jserve
from repro_torch.convert import index_from_jax
from repro_torch.core import batched_beam as tbb
from repro_torch.core import scheduler as tsched
from repro_torch.core import spec as tspec
from repro_torch.core.brute_force import knn_scan
from repro_torch.core.distances import get_distance as tget_distance
from repro_torch.core.metrics import recall_at_k
from repro_torch.kernels.ops import gathered_scores, prepped
from repro_torch.launch import serve as tserve

N_DB, N_Q, DIM, K, EF = 420, 24, 16, 10, 48
D_TOL = dict(rtol=1e-6, atol=1e-6)
SPEC = dict(distance="kl", builder="swgraph", NN=10, ef_construction=48, wave=16, k=K,
            ef_search=EF, slots=8, sched_frontier=4)
RERANK = dict(distance="kl", build_policy="min", search_policy="min", k_c=40,
              builder="nndescent", NN=8, nnd_iters=4, ef_search=EF, k=K)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the lock-step loops launch many tiny ops, and a
    thread pool per test worker oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(jidx):
    arrays = {a: np.asarray(getattr(jidx, a)) for a in ("X", "neighbors", "entries")}
    return index_from_jax(arrays, jidx.spec.to_dict(), device="cpu")


def _rows(res):
    """(ids, dists, n_evals, hops) of a result list, as numpy."""
    return (np.stack([r.ids for r in res]), np.stack([r.dists for r in res]),
            np.asarray([r.n_evals for r in res]), np.asarray([r.hops for r in res]))


def _assert_same(got, want, dists_bit_equal=False):
    np.testing.assert_array_equal(got[0], want[0], err_msg="ids")
    np.testing.assert_array_equal(got[2], want[2], err_msg="n_evals")
    np.testing.assert_array_equal(got[3], want[3], err_msg="hops")
    if dists_bit_equal:
        np.testing.assert_array_equal(got[1], want[1], err_msg="dists")
    else:
        np.testing.assert_allclose(got[1], want[1], **D_TOL)


@pytest.fixture(scope="module")
def setup():
    """Queries, the database, the repro index and the port's copy of it."""
    X = lda_like_histograms(jax.random.PRNGKey(0), N_DB + N_Q, DIM)
    Q, db = split_queries(X, N_Q, jax.random.PRNGKey(1))
    jidx = ANNIndex.build(db, spec=RetrievalSpec(**SPEC), key=jax.random.PRNGKey(2))
    return np.asarray(Q), np.asarray(db), jidx, _port(jidx)


@pytest.fixture(scope="module")
def oracle(setup):
    """Every repro scheduler run the parity tests compare against, once."""
    Q, db, jidx, _ = setup
    out = {}
    for f in (1, 4):
        out[("no_refill", f)] = _rows(jidx.scheduler(K, EF, slots=N_Q, frontier=f)
                                      .run_stream(Q))
    out["adaptive"] = _rows(jidx.scheduler(K, EF, slots=8, frontier=4, adaptive=True)
                            .run_stream(Q))
    sch = jidx.scheduler(spec=jidx.spec, ladder=jspec.demotion_ladder(jidx.spec, max_rungs=2),
                         slo_ms=50.0)
    sch.warmup(Q[0])
    out["tick_clock"] = sch.run_stream(Q, arrivals=np.arange(N_Q) * 2e-3, warm=False,
                                       tick_cost=1e-3)
    # the rerank scenario on an NN-descent min build, static, then made mutable
    ridx = ANNIndex.build(jnp.asarray(db[:300]), spec=RetrievalSpec(**RERANK),
                          key=jax.random.PRNGKey(4))
    ports = _port(ridx), _port(ridx)
    res = ridx.scheduler(spec=ridx.spec, slots=6, frontier=ridx.spec.frontier).run_stream(Q)
    out["rerank"] = (ports[0], _rows(res))
    ridx.ensure_online(capacity=360)
    ports[1].ensure_online(capacity=360)
    sch = ridx.scheduler(spec=ridx.spec, slots=4)
    base = ridx.search(jnp.asarray(Q[:8]), k=K, ef_search=EF)
    victims = np.unique(np.asarray(base[1])[:, 0])[:4]
    ridx.delete(victims)
    out["rerank_mutable"] = (ports[1], victims, _rows(sch.run_stream(Q[:8])))
    out["online"] = _online_episode(_jax_online(db), Q, _new_points(), victims=None)
    return out


def _jax_online(db):
    """A mutable repro index at the setup's build shapes (its jits are warm)."""
    return ANNIndex.build(jnp.asarray(db), spec=RetrievalSpec(**SPEC, capacity=N_DB + 40),
                          key=jax.random.PRNGKey(2))


def _new_points():
    return np.asarray(lda_like_histograms(jax.random.PRNGKey(7), 8, DIM))


def _online_episode(idx, Q, X_new, victims):
    """``tests/test_scheduler.py``'s mutation episode on either package: 12
    requests through 4 slots, one tick, then a delete of popular answers and
    an insert while they are in flight.  Returns the victims, the inserted
    ids, the first tick's rids, every response by rid and the alive mask."""
    port = isinstance(idx.X, torch.Tensor)
    sched = idx.scheduler(K, EF, slots=4, frontier=2)
    sched.warmup(Q[0])
    for j in range(12):
        sched.submit(Q[j], rid=j)
    first = sched.tick()
    if victims is None:
        base = idx.search(jnp.asarray(Q[:12]), k=K, ef_search=EF)
        victims = np.unique(np.asarray(base[1])[:, 0])[:5]  # popular answers
    idx.delete(victims)
    new_ids = np.asarray(idx.insert(_t(X_new) if port else jnp.asarray(X_new)))
    results = {r.rid: r for r in first}
    while len(results) < 12:
        for r in sched.tick():
            results[r.rid] = r
    alive = np.array(idx.online.alive)
    return {"victims": victims, "new_ids": new_ids, "first": {r.rid for r in first},
            "results": results, "alive": alive, "idx": idx, "sched": sched}


# ---------------------------------------------------------------------------
# the engine: all at once, slot recycling, Poisson arrivals, adaptive
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frontier", [1, 4])
def test_no_refill_equals_repro_and_the_port_searcher(frontier, setup, oracle):
    """S >= B, every query at t=0: repro's scheduler run, and the port's own
    one-shot searcher bit for bit."""
    Q, _, _, tidx = setup
    got = _rows(tidx.scheduler(K, EF, slots=N_Q, frontier=frontier).run_stream(Q))
    _assert_same(got, oracle[("no_refill", frontier)])
    d, ids, evals, hops = tidx.searcher(K, EF, frontier=frontier)(_t(Q))
    _assert_same(got, (ids.numpy(), d.numpy(), evals.numpy(), hops.numpy()),
                 dists_bit_equal=True)


@pytest.mark.parametrize("steps_per_sync", [1, 4])
def test_slot_recycling_preserves_results(steps_per_sync, setup, oracle):
    """6 slots, 24 queries: refilled slots give the all-at-once results."""
    Q, _, _, tidx = setup
    res = tidx.scheduler(K, EF, slots=6, frontier=4, steps_per_sync=steps_per_sync).run_stream(Q)
    assert [r.rid for r in res] == list(range(N_Q))
    _assert_same(_rows(res), oracle[("no_refill", 4)])
    want = _rows(tidx.scheduler(K, EF, slots=N_Q, frontier=4).run_stream(Q))
    _assert_same(_rows(res), want, dists_bit_equal=True)


def test_poisson_arrivals_preserve_request_response_mapping(setup):
    """Staggered arrivals and out-of-order retirement never cross-wire
    responses: each request queries a database point and gets it back first."""
    _, db, _, tidx = setup
    probes = db[37:37 + 16]
    arrivals = np.linspace(0.0, 0.05, 16)[np.random.RandomState(5).permutation(16)]
    res = tidx.scheduler(1, EF, slots=4, frontier=2).run_stream(probes, arrivals)
    assert [r.rid for r in res] == list(range(16))
    np.testing.assert_array_equal([r.ids[0] for r in res], np.arange(37, 37 + 16))
    for r in res:
        assert r.t_done >= r.t_admit >= r.t_arrival >= 0.0


def test_adaptive_frontier_equals_repro_and_cuts_evals(setup, oracle):
    Q, db, _, tidx = setup
    r_a = tidx.scheduler(K, EF, slots=8, frontier=4, adaptive=True).run_stream(Q)
    _assert_same(_rows(r_a), oracle["adaptive"])
    r_f = tidx.scheduler(K, EF, slots=8, frontier=4).run_stream(Q)
    e_f = np.mean([r.n_evals for r in r_f])
    e_a = np.mean([r.n_evals for r in r_a])
    assert e_a < 0.95 * e_f, (e_a, e_f)
    _, true_ids = knn_scan(tget_distance("kl"), _t(Q), _t(db), K)
    rec_f = recall_at_k(np.stack([r.ids for r in r_f]), true_ids)
    rec_a = recall_at_k(np.stack([r.ids for r in r_a]), true_ids)
    assert rec_a >= rec_f - 0.02, (rec_a, rec_f)


# ---------------------------------------------------------------------------
# the mutable index
# ---------------------------------------------------------------------------


def test_online_mutations_interleave_with_inflight_queries(setup, oracle):
    """The same episode in both packages: equal responses by rid; deletes
    mid-flight never surface (the killed-epoch guard voids recycled slots);
    an inserted vector is found by a query admitted after the insert."""
    Q, db, _, _ = setup
    want = oracle["online"]
    got = _online_episode(_port(_jax_online(db)), Q, _new_points(), victims=want["victims"])
    np.testing.assert_array_equal(got["new_ids"], want["new_ids"])
    np.testing.assert_array_equal(got["alive"], want["alive"])
    assert got["first"] == want["first"] and len(got["results"]) == 12
    order = sorted(want["results"])
    _assert_same(_rows([got["results"][j] for j in order]),
                 _rows([want["results"][j] for j in order]))
    victims, alive_now = want["victims"], got["alive"]
    recycled = victims[alive_now[victims]]
    late = [got["results"][j] for j in range(12) if j not in got["first"]]
    assert late, "mutations should have landed while queries were in flight"
    for r in late:
        valid = r.ids[r.ids >= 0].astype(int)
        assert alive_now[valid].all(), (r.rid, r.ids)
        if r.rid < 4:  # in flight when the delete landed
            assert not np.isin(valid, victims).any(), (r.rid, r.ids, victims)
            assert len(valid) == K, (r.rid, r.ids)
        assert not np.isin(valid, np.setdiff1d(victims, recycled)).any()
    idx = got["idx"]
    probe = got["sched"].run_stream(idx.online.X[_t(got["new_ids"][:4])])
    np.testing.assert_array_equal([r.ids[0] for r in probe], got["new_ids"][:4])


def test_static_scheduler_fails_loud_after_online_conversion(setup):
    Q, db, _, _ = setup
    idx = _port_build(db[:150])
    sched = idx.scheduler(K, EF, slots=4)
    assert sched.run_stream(Q[:2])
    idx.delete([5])  # lazy online conversion
    sched.submit(Q[0])
    with pytest.raises(RuntimeError, match="mutable"):
        sched.tick()
    res = idx.scheduler(K, EF, slots=4).run_stream(db[5:6])
    assert 5 not in set(res[0].ids.tolist())


def _port_build(X):
    from repro_torch.core.index import ANNIndex as TIndex

    return TIndex.build(_t(X), spec=tspec.RetrievalSpec(builder="nndescent", NN=8, nnd_iters=4))


# ---------------------------------------------------------------------------
# rerank
# ---------------------------------------------------------------------------


def test_rerank_spec_on_a_static_index(setup, oracle):
    """Slot recycling under a min/min + rerank spec: repro's scheduler run;
    the port's batch searcher + rerank bit for bit, though each request is
    re-ranked on its own (B = 1) and the searcher's in one batch."""
    Q, _, _, _ = setup
    port, want = oracle["rerank"]
    spec = port.spec
    got = _rows(port.scheduler(spec=spec, slots=6, frontier=spec.frontier).run_stream(Q))
    _assert_same(got, want)
    d, ids, evals, hops = port.searcher(spec=spec)(_t(Q))
    _assert_same(got, (ids.numpy(), d.numpy(), evals.numpy(), hops.numpy()),
                 dists_bit_equal=True)
    # the reported distances are the original distance's
    full = port.dist.query_matrix(_t(Q), port.X).numpy()
    for j in range(N_Q):
        ok = got[0][j] >= 0
        np.testing.assert_allclose(got[1][j][ok], full[j][got[0][j][ok]], rtol=1e-4, atol=1e-5)


def test_rerank_spec_on_a_mutable_index(setup, oracle):
    Q, _, _, _ = setup
    port, victims, want = oracle["rerank_mutable"]
    sched = port.scheduler(spec=port.spec, slots=4)
    sched.warmup(Q[0])
    port.delete(victims)
    got = _rows(sched.run_stream(Q[:8]))
    _assert_same(got, want)
    alive = port.online.alive.numpy()
    for ids in got[0]:
        valid = ids[ids >= 0]
        assert alive[valid].all() and not np.isin(valid, victims).any()


# ---------------------------------------------------------------------------
# admission: the estimator, decide(), the clock, demotion
# ---------------------------------------------------------------------------


def _estimator_trace(mod):
    est = mod.ServiceRateEstimator(slots=4, alpha=1.0)
    out = [est.predicted_wait(0, 0)]
    est.observe(0.1)
    out += [est.mean, est.rate_per_slot, est.predicted_wait(0, 1), est.predicted_wait(2, 3),
            est.predicted_wait(3, 1), est.predicted_wait(5, 0)]
    est = mod.ServiceRateEstimator(slots=2, alpha=0.5, n_rungs=2)
    est.observe(1.0, level=0)
    est.observe(3.0, level=0)
    out += [est.mean, est.service_s(1, scale=0.5)]
    est.observe(1.6, level=1)
    est.observe(-1.0)
    out += [est.service_s(1, scale=0.5), est.service_s(0), est.mean]
    est = mod.ServiceRateEstimator(slots=4, prior=0.25, n_rungs=3)
    return out + [est.service_s(0), est.service_s(2, scale=0.25)]


def _decide_trace(mod, case):
    rungs = [mod.Rung(96, scale=1.0), mod.Rung(48, scale=0.5), mod.Rung(24, scale=0.25)]
    kw = {"margin": 1.5} if case == "margin" else {}
    if case == "best_effort":
        rungs, kw = [mod.Rung(96), mod.Rung(24, scale=0.25)], {"shed": False}
    ac = mod.AdmissionController(rungs, slots=4, alpha=1.0, **kw)
    ac.estimator.observe(0.1, level=0)
    calls = {
        "demote_then_shed": [dict(elapsed=e, slo_s=1.0) for e in (0.0, 0.93, 0.97, 0.999)],
        "no_slo_and_base": [dict(elapsed=5.0, slo_s=None), dict(elapsed=5.0, slo_s=None,
                                                                  base_level=2),
                            dict(elapsed=0.93, slo_s=1.0, base_level=1)],
        "best_effort": [dict(elapsed=0.999, slo_s=1.0)],
        "queue_wait": [dict(elapsed=0.0, slo_s=0.15, queue_wait=q) for q in (0.0, 0.08)],
        "margin": [dict(elapsed=0.88, slo_s=1.0)],
    }[case]
    return [ac.decide(**c) for c in calls] + [ac.n_demoted, ac.n_shed]


def test_estimator_equals_repro():
    got = _estimator_trace(tsched)
    assert got == _estimator_trace(jsched)
    assert got[:7] == pytest.approx([0.0, 0.1, 10.0, 0.0, 0.0, 3 * 0.1 / 4, 6 * 0.1 / 4])
    assert got[7:] == pytest.approx([2.0, 1.0, 1.6, 2.0, 1.8, 0.25, 0.0625])


@pytest.mark.parametrize("case", ["demote_then_shed", "no_slo_and_base", "best_effort",
                                  "queue_wait", "margin"])
def test_decide_equals_repro(case):
    got = _decide_trace(tsched, case)
    assert got == _decide_trace(jsched, case)
    want = {"demote_then_shed": [0, 1, 2, None, 2, 1], "no_slo_and_base": [0, 2, 1, 0, 0],
            "best_effort": [1, 1, 0], "queue_wait": [0, 1, 1, 0], "margin": [1, 1, 0]}[case]
    assert got == want
    with pytest.raises(ValueError, match="margin"):
        tsched.AdmissionController([tsched.Rung(96)], slots=4, margin=0.0)


def test_tick_clock_equals_repro_and_is_deterministic(setup, oracle):
    """Under ``tick_cost`` every timestamp, rung and result equals repro's
    and a second run's."""
    Q, _, _, tidx = setup
    spec = tidx.spec
    runs = []
    for _ in range(2):
        sch = tidx.scheduler(spec=spec, ladder=tspec.demotion_ladder(spec, max_rungs=2),
                             slo_ms=50.0)
        sch.warmup(Q[0])
        runs.append(sch.run_stream(Q, arrivals=np.arange(N_Q) * 2e-3, warm=False,
                                   tick_cost=1e-3))
    for a, b, w in zip(*runs, oracle["tick_clock"]):
        assert (a.rid, a.t_admit, a.t_done, a.level, a.shed) == \
            (b.rid, b.t_admit, b.t_done, b.level, b.shed) == \
            (w.rid, w.t_admit, w.t_done, w.level, w.shed)
        np.testing.assert_array_equal(a.ids, w.ids)
        assert (a.n_evals, a.hops) == (w.n_evals, w.hops)
    assert all(r.t_done > r.t_arrival for r in runs[0])
    with pytest.raises(ValueError, match="tick_cost"):
        sch.run_stream(Q, realtime=True, tick_cost=1e-3)


def test_sheds_only_past_budget(setup):
    Q, _, _, tidx = setup
    spec = tidx.spec
    ladder = [spec, spec.replace(ef_search=24)]
    sch = tidx.scheduler(spec=spec, ladder=ladder, slo_ms=1.0, service_prior=10.0)
    res = sch.run_stream(Q)
    assert all(r.shed and r.level == -1 for r in res)
    assert all(r.ids[0] == -1 and not np.isfinite(r.dists[0]) for r in res)
    assert sch.qos_stats["shed"] == N_Q
    sch_be = tidx.scheduler(spec=spec, ladder=ladder, slo_ms=1.0, service_prior=10.0,
                            shed=False)
    res_be = sch_be.run_stream(Q)
    assert not any(r.shed for r in res_be) and all(r.level == 1 for r in res_be)
    assert sch_be.qos_stats["shed"] == 0 and sch_be.qos_stats["demoted"] == N_Q
    res_ok = tidx.scheduler(spec=spec, ladder=ladder, slo_ms=60_000.0,
                            service_prior=1e-6).run_stream(Q)
    assert not any(r.shed for r in res_ok) and all(r.level == 0 for r in res_ok)


def test_demotion_parity_bit_identical(setup):
    """Rung 1 (ef 24) returns exactly what a scheduler built at ef 24 returns."""
    Q, _, _, tidx = setup
    spec = tidx.spec
    ladder = tspec.demotion_ladder(spec, max_rungs=2)
    sch = tidx.scheduler(spec=spec, ladder=ladder)
    for i in range(N_Q):
        sch.submit(Q[i], rid=i, level=1)
    demoted = {r.rid: r for r in sch.drain()}
    low = tidx.scheduler(spec=spec.replace(ef_search=ladder[1].ef_search))
    for i in range(N_Q):
        low.submit(Q[i], rid=i)
    fresh = {r.rid: r for r in low.drain()}
    order = list(range(N_Q))
    _assert_same(_rows([demoted[i] for i in order]), _rows([fresh[i] for i in order]),
                 dists_bit_equal=True)
    assert all(demoted[i].level == 1 for i in order)


@pytest.mark.parametrize("adaptive", [False, True])
def test_rung0_parity_with_the_single_rung_scheduler(adaptive, setup):
    Q, _, _, tidx = setup
    spec = tidx.spec.replace(adaptive=adaptive)
    res_qos = tidx.scheduler(spec=spec, ladder=tspec.demotion_ladder(spec, max_rungs=2))
    res_one = tidx.scheduler(spec=spec)
    _assert_same(_rows(res_qos.run_stream(Q)), _rows(res_one.run_stream(Q)),
                 dists_bit_equal=True)


# ---------------------------------------------------------------------------
# tenants: the DRR grant order
# ---------------------------------------------------------------------------


def _grants(sched, submissions, takes):
    """The rids ``_drr_select`` grants for ``takes`` after ``submissions``."""
    for rid, (q, tenant, priority) in enumerate(submissions):
        sched.submit(q, rid=rid, tenant=tenant, priority=priority)
    out = []
    for n in takes:
        out.append([r.rid for r in sched._drr_select(n)])
    return out


@pytest.mark.parametrize("case", ["skew", "weights", "priority"])
def test_drr_grant_order_equals_repro(case, setup):
    Q, _, jidx, tidx = setup
    if case == "skew":  # 10:1, majority first
        subs = [(Q[i % N_Q], 0, 0) for i in range(10 * N_Q)] + [(Q[i], 1, 0) for i in range(10)]
    elif case == "weights":
        subs = [(Q[i], 0, 0) for i in range(N_Q)] + [(Q[i], 1, 0) for i in range(N_Q)]
    else:
        subs = [(Q[i], 0, i % 2) for i in range(N_Q)]
    weights = {0: 3.0, 1: 1.0} if case == "weights" else None
    takes = [8, 3, 5, 1, 8, 2, 7] * 40
    got = _grants(tidx.scheduler(spec=tidx.spec, tenant_weights=weights), subs, takes)
    assert got == _grants(jidx.scheduler(spec=jidx.spec, tenant_weights=weights), subs, takes)
    flat = [r for g in got for r in g]
    assert sorted(flat) == list(range(len(subs)))
    tenant = {rid: s[1] for rid, s in enumerate(subs)}
    prio = {rid: s[2] for rid, s in enumerate(subs)}
    if case == "skew":
        # the minority tenant alternates with the flood: all 10 within 20 grants
        assert max(flat.index(r) for r in flat if tenant[r] == 1) < 2 * 10
    elif case == "weights":
        head = flat[:N_Q]  # both backlogged: 3 grants to tenant 0 per grant to 1
        assert sum(tenant[r] == 0 for r in head) == 3 * sum(tenant[r] == 1 for r in head)
    else:
        assert all(prio[r] == 0 for r in flat[:N_Q // 2])


def test_drr_through_the_ticks(setup):
    """Fairness end to end: the flood does not starve the minority tenant,
    FIFO holds within a tenant, and priority 0 is admitted first."""
    Q, _, _, tidx = setup
    sch = tidx.scheduler(spec=tidx.spec)
    granted = []
    select = sch._drr_select

    def logged(n):
        out = select(n)
        granted.extend(r.rid for r in out)
        return out

    sch._drr_select = logged
    reps = np.concatenate([np.tile(Q, (10, 1)), Q[:10]])
    for i in range(len(reps)):
        sch.submit(reps[i], rid=i, tenant=int(i >= 10 * N_Q), priority=i % 2)
    res = sch.drain()
    assert sorted(r.rid for r in res) == list(range(len(reps)))
    minority = [granted.index(r) for r in range(10 * N_Q, len(reps))]
    assert max(minority) <= 2 * 10 + sch.S
    for t in (0, 1):
        for p in (0, 1):
            rows = [g for g in granted if int(g >= 10 * N_Q) == t and g % 2 == p]
            assert rows == sorted(rows)


# ---------------------------------------------------------------------------
# idle-tick background work
# ---------------------------------------------------------------------------


def test_background_compaction_interleaves_safely(setup):
    """Idle ticks run compact_slice; tombstones stay invisible and the drained
    graph equals one ``compact()``."""
    Q, _, jidx, _ = setup
    arrays = {a: np.asarray(getattr(jidx, a)) for a in ("X", "neighbors", "entries")}
    spec_m = jidx.spec.replace(capacity=N_DB + 8).to_dict()
    midx, ref = (index_from_jax(arrays, spec_m, device="cpu") for _ in range(2))
    online = midx.online
    dead = np.random.default_rng(3).choice(N_DB, 60, replace=False)
    midx.delete(dead)
    assert online.compaction_debt > 0
    sch = midx.scheduler(spec=midx.spec, background=True)
    res = sch.run_stream(Q, arrivals=np.arange(N_Q) * 1.0)
    for _ in range(200):
        if not online.compaction_debt:
            break
        sch.tick()
    assert online.compaction_debt == 0
    for r in res:
        assert not r.shed and not set(dead.tolist()).intersection(r.ids[r.ids >= 0].tolist())
    ref.delete(dead)
    ref.compact()
    assert torch.equal(online.adj, ref.online.adj)


def test_background_hook_never_preempts_pending_work(setup):
    Q, _, _, tidx = setup
    calls = []
    sch = tsched.SlotScheduler(tidx.dist, tidx.scheduler().graph_fn, dim=DIM, slots=8, ef=EF,
                               k=K, frontier=4, background_fn=lambda: calls.append(sch.n_pending))
    sch.run_stream(Q, arrivals=np.arange(N_Q) * 0.5)
    assert calls and all(p == 0 for p in calls)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------


def _ladder_dicts(mod, src_of, changes, **kw):
    spec = mod.RetrievalSpec(**changes)
    return [s.to_dict() for s in mod.demotion_ladder(spec, src_of(spec), **kw)]


@pytest.mark.parametrize("case", ["synth", "synth_rerank", "floor", "frontier", "tuned"])
def test_demotion_ladder_equals_repro(case):
    kl = dict(distance="kl", k=10, ef_search=96)
    changes, kw, src_of = kl, {}, lambda spec: None
    if case == "synth_rerank":
        changes = dict(kl, build_policy="min", search_policy="min", k_c=30)
    elif case == "floor":
        kw = {"floor_ef": 40}
    elif case == "frontier":
        def src_of(spec):
            return {"frontier": [
                {"spec": spec.replace(ef_search=32).to_dict()},
                {"spec": spec.replace(ef_search=64).to_dict()},
                {"spec": spec.replace(ef_search=48, NN=5).to_dict()},  # another build
                {"spec": spec.replace(ef_search=96).to_dict()},  # not cheaper
                {"spec": {"distance": 3}}]}  # unreadable
    elif case == "tuned":
        import pathlib

        path = pathlib.Path(__file__).resolve().parents[1] / "TUNED_spec.json"
        tuned, _ = tspec.load_tuned_artifact(str(path))
        changes = tuned.to_dict()

        def src_of(spec):
            return str(path)
    got = _ladder_dicts(tspec, src_of, changes, **kw)
    assert got == _ladder_dicts(jspec, src_of, changes, **kw)
    want = {"synth": [96, 48, 24], "synth_rerank": [96, 48], "floor": [96, 48],
            "frontier": [96, 64, 32]}.get(case)
    if want is not None:
        assert [d["ef_search"] for d in got] == want
    lad = tspec.demotion_ladder(tspec.RetrievalSpec(**kl))
    assert tspec.class_spec(lad, 0) is lad[0] and tspec.class_spec(lad, 1) is lad[1]
    assert tspec.class_spec(lad, 99) is lad[-1] and tspec.class_spec(lad, -3) is lad[0]


def test_scheduler_ladder_validation(setup):
    _, _, _, tidx = setup
    spec, g = tidx.spec, tidx.scheduler().graph_fn
    kl = tget_distance("kl")
    with pytest.raises(ValueError, match="rung 0"):
        tsched.SlotScheduler(kl, g, dim=DIM, slots=4, ef=EF, k=K, ladder=[tsched.Rung(ef=24)])
    with pytest.raises(ValueError, match="non-increasing"):
        tsched.SlotScheduler(kl, g, dim=DIM, slots=4, ef=EF, k=K, ladder=[
            tsched.Rung(ef=EF), tsched.Rung(ef=24), tsched.Rung(ef=32)])
    with pytest.raises(ValueError, match="outside"):
        tsched.SlotScheduler(kl, g, dim=DIM, slots=4, ef=EF, k=K,
                             ladder=[tsched.Rung(ef=EF), tsched.Rung(ef=4)])
    with pytest.raises(ValueError, match="k"):
        tidx.scheduler(spec=spec, ladder=[spec, spec.replace(k=5, ef_search=24)])
    with pytest.raises(ValueError, match="weight"):
        tidx.scheduler(spec=spec, tenant_weights={0: 0.0})
    with pytest.raises(ValueError, match="mutable"):
        tidx.scheduler(spec=spec, background=True)


# ---------------------------------------------------------------------------
# beam_step's ef_active
# ---------------------------------------------------------------------------


def test_beam_step_ef_active_equals_repro(setup):
    """Both packages' beam_step from the same seeded state, each query at its
    own effective width and frontier: the state equal after every step."""
    Q, db, jidx, _ = setup
    dist, tdist = get_distance("kl"), tget_distance("kl")
    nbrs, entries, S, T = jidx.neighbors, jidx.entries, N_Q, 4
    C = jbb.frontier_compact_width(T, nbrs.shape[1], 32)
    ef_act = np.random.default_rng(0).integers(K, EF + 1, size=S).astype(np.int32)
    ef_act[:3] = (K, EF, 24)
    t_act = np.random.default_rng(1).integers(1, T + 1, size=S).astype(np.int32)
    jscore = _jax_scores(dist, db, Q)
    consts, qc = prepped(tdist.prep_scan(_t(db))), prepped(tdist.prep_queries(_t(Q)))

    def tscore(ids):
        return gathered_scores(tdist, ids, qc, consts)

    jst = jbb.seed_beams(jscore, entries, S, EF, N_DB)
    tst = tbb.seed_beams(tscore, _t(entries), S, EF, N_DB)
    jstep = jax.jit(lambda st: jbb.beam_step(st, nbrs, jscore, EF, T, C, N_DB,
                                             t_active=jnp.asarray(t_act),
                                             ef_active=jnp.asarray(ef_act)))
    for step in range(12):
        jst = jstep(jst)
        tst = tbb.beam_step(tst, _t(nbrs), tscore, EF, T, C, N_DB, t_active=_t(t_act),
                            ef_active=_t(ef_act))
        for name in ("beam_i", "expanded", "n_evals", "hops", "done"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)), err_msg=(step, name))
        np.testing.assert_array_equal(tst.visited.numpy().view(np.uint32),
                                      np.asarray(jst.visited))
        np.testing.assert_allclose(tst.beam_d.numpy(), np.asarray(jst.beam_d), **D_TOL)
    # the beam tail past each query's width is void
    off = np.arange(EF)[None, :] >= ef_act[:, None]
    assert (tst.beam_i.numpy()[off] == -1).all() and tst.expanded.numpy()[off].all()


def _jax_scores(dist, db, Q):
    consts, qc = dist.prep_scan(jnp.asarray(db)), jax.vmap(dist.prep_query)(jnp.asarray(Q))

    def score(ids):
        rows = jax.tree.map(lambda a: a[ids], consts)
        return jax.vmap(dist.score)(rows, qc)

    return score


# ---------------------------------------------------------------------------
# serve: the continuous and QoS paths
# ---------------------------------------------------------------------------

# repro's keys (repro/launch/serve.py, build_and_serve's continuous and qos blocks)
CONT_KEYS = {"offered_qps", "slots", "frontier", "adaptive_frontier", "recall@k",
             "eval_reduction", "p50_ms", "p95_ms", "p99_ms", "static_p99_ms", "dynamic_p99_ms",
             "dynamic_recall@k", "p99_speedup_vs_static", "p99_speedup_vs_dynamic"}
QOS_KEYS = {"slo_ms", "tenants", "ladder", "n", "in_slo", "goodput_qps", "shed_frac",
            "in_slo_by_class", "in_slo_by_tenant", "demoted", "shed", "fifo_in_slo",
            "fifo_goodput_qps"}


def test_arrival_draws_and_summaries_equal_repro():
    np.testing.assert_array_equal(
        tserve.poisson_arrivals(50, 120.0, np.random.default_rng(1)),
        jserve.poisson_arrivals(50, 120.0, np.random.default_rng(1)))
    for tenants, weights in ((2, None), (3, [3.0, 1.0, 1.0])):
        got = tserve.multi_tenant_arrivals(53, 90.0, tenants, np.random.default_rng(7), weights)
        want = jserve.multi_tenant_arrivals(53, 90.0, tenants, np.random.default_rng(7),
                                            weights)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(4)
    res = [tsched.SlotResult(rid=i, dists=np.zeros(1), ids=np.zeros(1), n_evals=1, hops=1,
                             t_arrival=float(a), t_done=float(a + rng.exponential(0.02)),
                             tenant=i % 2, priority=i % 3, shed=bool(i % 7 == 0))
           for i, a in enumerate(np.sort(rng.uniform(0, 1, 40)))]
    got = tserve.qos_summary(res, 0.02, n_classes=3, n_tenants=2)
    want = jserve.qos_summary(res, 0.02, n_classes=3, n_tenants=2)
    assert got.keys() == want.keys()
    for key, w in want.items():  # repro rounds its numbers, the port does not
        if isinstance(w, dict):
            assert got[key] == pytest.approx(w, abs=1e-4)
        else:
            assert got[key] == pytest.approx(w, abs=0.05 if key == "goodput_qps" else 1e-4)
    lat = rng.exponential(0.01, 100)
    assert tserve.latency_stats(lat) == pytest.approx(jserve.latency_stats(lat), abs=1e-3)


def test_serve_continuous_and_qos_on_cpu():
    stats = tserve.main(["--device", "cpu", "--n-db", "600", "--queries", "64", "--batch", "16",
                         "--ef", "64", "--continuous", "--slots", "16", "--slo-ms", "30",
                         "--tenants", "2", "--priority", "0.6,0.4", "--seed", "1"])
    cont, qos = stats["continuous"], stats["qos"]
    assert set(cont) == CONT_KEYS and set(qos) == QOS_KEYS
    assert abs(cont["recall@k"] - stats["recall@k"]) <= 0.005
    assert cont["slots"] == 16 and cont["frontier"] == 12
    assert qos["n"] == 64 and qos["ladder"] == ["ef64", "ef32", "ef16"]
    assert set(qos["in_slo_by_tenant"]) == {0, 1} and set(qos["in_slo_by_class"]) <= {0, 1}
    assert stats["spec"]["slots"] == 16 and stats["spec"]["sched_frontier"] == 12
    assert all(n == 0 for phase in ("continuous", "qos")
               for n in stats["kernel_launches"][phase].values())
    for bad in (["--slo-ms", "30"], ["--continuous", "--tenants", "2"],
                ["--continuous", "--slo-ms", "30", "--priority", "a,b"],
                ["--continuous", "--slo-ms", "30", "--priority", "0.5,0"]):
        with pytest.raises(SystemExit):
            tserve.main(["--device", "cpu", "--n-db", "100", *bad])
