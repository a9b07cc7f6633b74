"""Port parity for the online mutable index (``repro_torch.core.online``).

One churn episode runs through both packages on the same numpy arrays: a
``repro`` SW-graph wave build with a capacity, carried across by
``index_from_jax``, then the same insert, delete, ``compact``, delete and
drained ``compact_slice`` in each.  After every stage the adjacency,
``alive``, the free list, ``killed_epoch``, the entries and ``n_total`` are
equal, slot distances agree within rtol = atol = 5e-7 (float32 summation
order), and the alive-masked search returns the same ids, evals and hops.
The contracts of ``tests/test_online_index.py`` are then held on the port's
own builds at the same sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_invariants import check_adjacency_invariants
from repro.core import ANNIndex, get_distance
from repro.data.synthetic import lda_like_histograms, split_queries
from repro_torch.convert import index_from_jax, online_from_jax
from repro_torch.core import online as tonline
from repro_torch.core.index import ANNIndex as TIndex
from repro_torch.core.online import OnlineIndex
from repro_torch.core.spec import RetrievalSpec

N_DB, N_NEW, N_Q, DIM, K = 420, 105, 16, 16, 10
NN, EF_C, EF_S = 10, 60, 96
BUILD = dict(builder="swgraph", build_engine="wave", wave=32, NN=NN, ef_construction=EF_C)
D_TOL = dict(rtol=5e-7, atol=5e-7)
STAGES = ("from_graph", "insert", "delete", "compact", "compact_slice")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the port's lock-step loops launch many tiny ops,
    and a thread pool per test worker oversubscribes the cores (~10x slower
    under parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(**changes):
    return RetrievalSpec(**{**BUILD, **changes})


@pytest.fixture(scope="module")
def data():
    X = lda_like_histograms(jax.random.PRNGKey(0), N_DB + N_NEW + N_Q, DIM)
    Q, rest = split_queries(X, N_Q, jax.random.PRNGKey(1))
    return np.asarray(Q), np.asarray(rest[:N_DB]), np.asarray(rest[N_DB:])


def _state(o):
    """The state both packages must agree on, as numpy copies (the port
    updates its tensors in place)."""
    return {"adj": np.array(o.adj), "adj_d": np.array(o.adj_d),
            "alive": np.array(o.alive), "free": list(o._free),
            "killed_epoch": np.array(o.killed_epoch), "entries": np.array(o.entries),
            "n_total": o.n_total, "mutation_epoch": o.mutation_epoch,
            "repair_pending": list(o._repair_pending), "compact_dirty": o._compact_dirty}


def _searched(idx, Q):
    return [np.asarray(a) for a in idx.search(Q, k=K, ef_search=EF_S)]


@pytest.fixture(scope="module")
def episode(data):
    """The churn episode in both packages: ``stages[stage]`` = (repro state,
    port state, repro search, port search), what each mutation returned,
    and the repro state mid-churn (after the deletes, before ``compact``)."""
    Q, db, X_new = data
    jidx = ANNIndex.build(jnp.asarray(db), get_distance("kl"), capacity=2 * N_DB,
                          key=jax.random.PRNGKey(2), **BUILD)
    arrays = {a: np.asarray(getattr(jidx, a)) for a in ("X", "neighbors", "entries")}
    tidx = index_from_jax(arrays, jidx.spec.to_dict(), device="cpu")
    out = {"stages": {}, "spec": jidx.spec.to_dict()}

    def record(stage):
        out["stages"][stage] = (_state(jidx.online), _state(tidx.online),
                                _searched(jidx, jnp.asarray(Q)), _searched(tidx, _t(Q)))

    record("from_graph")
    out["ids"] = (jidx.insert(jnp.asarray(X_new)), tidx.insert(_t(X_new)))
    record("insert")
    dead = np.random.RandomState(7).choice(N_DB, size=N_DB // 5, replace=False)
    out["deleted"] = (jidx.delete(dead), tidx.delete(dead))
    record("delete")
    mid = jidx.online
    out["mid_churn"] = dict(_state(mid), X=np.asarray(mid.X),
                            rng_state=mid._rng.bit_generator.state)
    out["compacted"] = (jidx.compact(), tidx.compact())
    record("compact")
    more = np.random.RandomState(8).choice(np.flatnonzero(np.asarray(jidx.online.alive)),
                                           size=60, replace=False)
    jidx.delete(more)
    tidx.delete(more)
    slices = []
    while True:
        slices.append((jidx.online.compact_slice(), tidx.online.compact_slice()))
        if slices[-1][0]["repaired"] == 0 and slices[-1][0]["remaining"] == 0:
            break
    out["slices"] = slices
    record("compact_slice")
    out["port"], out["dead"] = tidx, np.concatenate([dead, more])
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_state_equals_repro(stage, episode):
    want, got, _, _ = episode["stages"][stage]
    for key in ("adj", "alive", "killed_epoch", "entries"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("free", "n_total", "mutation_epoch", "repair_pending", "compact_dirty"):
        assert got[key] == want[key], key
    assert np.array_equal(np.isinf(got["adj_d"]), np.isinf(want["adj_d"]))
    fin = np.isfinite(want["adj_d"])
    np.testing.assert_allclose(got["adj_d"][fin], want["adj_d"][fin], **D_TOL)


@pytest.mark.parametrize("stage", STAGES)
def test_search_equals_repro(stage, episode):
    _, _, want, got = episode["stages"][stage]
    for name, g, w in zip(("ids", "evals", "hops"), got[1:], want[1:]):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_mutations_report_what_repro_reports(episode):
    j_ids, t_ids = episode["ids"]
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    assert episode["deleted"][0] == episode["deleted"][1] == N_DB // 5
    assert episode["compacted"][0] == episode["compacted"][1]
    assert len(episode["slices"]) > 2  # the drop pass, repair waves, the empty slice
    for want, got in episode["slices"]:
        assert got == want


def test_online_from_jax_round_trips_mid_churn(episode, data):
    """A repro index converted mid-churn (tombstones not yet compacted)
    compacts and then searches as repro's did from the same state."""
    Q, _, _ = data
    arrays = episode["mid_churn"]
    o = online_from_jax(arrays, episode["spec"], device="cpu")
    assert o.free_slots == o.capacity - arrays["n_total"] + len(arrays["free"])
    np.testing.assert_array_equal(o.killed_epoch, arrays["killed_epoch"])
    assert o.compact() == episode["compacted"][0]
    want, _, want_search, _ = episode["stages"]["compact"]
    np.testing.assert_array_equal(o.adj.numpy(), want["adj"])
    np.testing.assert_array_equal(o.alive.numpy(), want["alive"])
    got = o.searcher(K, EF_S, frontier=RetrievalSpec.from_dict(episode["spec"]).frontier)(_t(Q))
    for name, g, w in zip(("ids", "evals", "hops"), got[1:], want_search[1:]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_compact_slice_drained_equals_compact(data):
    """Draining ``compact_slice`` at ``max_nodes = wave`` leaves the adjacency
    of one ``compact()`` on a copy of the same state."""
    _, db, X_new = data
    a = TIndex.build(_t(db[:200]), spec=_spec(capacity=400))
    a.insert(_t(X_new[:40]))
    a.delete(np.arange(0, 200, 7))
    o = a.online
    b = online_from_jax(dict(_state(o), X=o.X.numpy(), rng_state=o._rng.bit_generator.state),
                        a.spec.to_dict(), device="cpu")
    assert b.compact_slice(max_nodes=b.wave)["dead_edges_dropped"] > 0
    while b.compact_slice(max_nodes=b.wave)["remaining"]:
        pass
    b.compact_slice(max_nodes=b.wave)
    assert b.compaction_debt == 0
    assert o.compact()["repaired"] > 0
    assert torch.equal(b.adj, o.adj) and torch.equal(b.adj_d, o.adj_d)


# ---------------------------------------------------------------------------
# the contracts of tests/test_online_index.py, on the port
# ---------------------------------------------------------------------------


def test_deleted_ids_never_returned_and_inserted_ids_found(episode, data):
    Q, _, _ = data
    idx, dead = episode["port"], episode["dead"]
    _, ids, _, _ = idx.search(_t(Q), k=K, ef_search=EF_S)
    assert not np.isin(ids.numpy(), dead).any()
    o = idx.online
    probe = np.setdiff1d(episode["ids"][1], dead)[-8:]  # inserted, never deleted
    assert bool(o.alive[_t(probe)].all())
    d, got, _, _ = idx.search(o.X[_t(probe)], k=1, ef_search=EF_S)
    np.testing.assert_array_equal(got[:, 0].numpy(), probe)
    np.testing.assert_allclose(d[:, 0].numpy(), 0.0, atol=1e-4)


def test_structural_invariants_through_churn(episode):
    o = episode["port"].online
    check_adjacency_invariants(o.adj[:o.n_total].numpy(), o.n_total, o.M_max,
                               forbidden=episode["dead"], adj_d=o.adj_d[:o.n_total].numpy())
    assert int(o.adj[o.n_total:].max()) == -1  # the capacity suffix was never touched
    assert not bool(o.alive[o.n_total:].any())


def test_insert_to_capacity_then_overflow_raises(data):
    _, db, X_new = data
    idx = TIndex.build(_t(db[:120]), spec=_spec(capacity=130))
    ids = idx.insert(_t(X_new[:10]))  # exactly fills the capacity
    assert idx.online.free_slots == 0
    with pytest.raises(ValueError, match="capacity"):
        idx.insert(_t(X_new[10:11]))
    _, got, _, _ = idx.search(idx.online.X[_t(ids)], k=1, ef_search=48)
    np.testing.assert_array_equal(got[:, 0].numpy(), ids)


def test_delete_all_then_query_returns_padded(data):
    Q, db, X_new = data
    idx = TIndex.build(_t(db[:100]), spec=_spec(capacity=200))
    assert idx.delete(np.arange(100)) == 100
    d, ids, n_evals, _ = idx.search(_t(Q), k=K, ef_search=48)
    assert bool((ids == -1).all()) and bool(torch.isinf(d).all())
    assert bool((n_evals == 0).all())
    back = idx.insert(_t(X_new[:40]))  # the wiped index serves fresh inserts again
    _, ids2, _, _ = idx.search(idx.online.X[_t(back[:4])], k=1, ef_search=48)
    np.testing.assert_array_equal(ids2[:, 0].numpy(), back[:4])


def test_multiwave_insert_after_wipe_stays_connected(data):
    """During a multi-wave insert into a fully tombstoned index the entry
    refresh sees the earlier waves' points, so the waves do not form islands."""
    _, db, X_new = data
    idx = TIndex.build(_t(db[:100]), spec=_spec(capacity=300, wave=16))
    idx.delete(np.arange(100))
    back = idx.insert(_t(X_new[:80]))  # 5 waves of 16
    adj = idx.online.adj.numpy()
    wave1 = set(back[:16].tolist())
    assert sum(1 for u in back for t in adj[u]
               if t >= 0 and ((u in wave1) != (int(t) in wave1))) > 0
    _, ids, _, _ = idx.search(idx.online.X[_t(back)], k=1, ef_search=48)
    np.testing.assert_array_equal(ids[:, 0].numpy(), back)


def test_insert_hoists_entry_liveness_check(data, monkeypatch):
    """A steady-state multi-wave insert reads entry liveness once; into a
    wiped index it re-checks until a live entry is adopted (3 reads)."""
    _, db, X_new = data
    idx = TIndex.build(_t(db[:100]), spec=_spec(capacity=300, wave=16))
    calls = {"n": 0}
    orig = OnlineIndex._entries_alive

    def counting(self):
        calls["n"] += 1
        return orig(self)

    monkeypatch.setattr(OnlineIndex, "_entries_alive", counting)
    first = idx.insert(_t(X_new[:64]))  # 4 waves of 16, entries alive throughout
    assert calls["n"] == 1
    idx.delete(np.concatenate([np.arange(100), first]))
    calls["n"] = 0
    back = idx.insert(_t(X_new[64:]))  # 41 points: 3 waves into a wiped index
    assert calls["n"] == 3
    _, ids, _, _ = idx.search(idx.online.X[_t(back)], k=1, ef_search=48)
    np.testing.assert_array_equal(ids[:, 0].numpy(), back)


def test_sustained_churn_at_constant_capacity(data):
    """+N/-N churn with no capacity slack: tombstoned slots are recycled, and
    a reused slot carries no stale incoming edge."""
    _, db, X_new = data
    n0, per_round, rounds = 200, 40, 6
    idx = TIndex.build(_t(db[:n0]), spec=_spec(capacity=n0))
    o = idx.online
    pool = np.concatenate([X_new, db[n0:]])
    rng = np.random.default_rng(3)
    for r in range(rounds):
        victims = rng.choice(np.flatnonzero(o.alive.numpy()), size=per_round, replace=False)
        assert idx.delete(victims) == per_round
        lo = (r * per_round) % (pool.shape[0] - per_round)
        ids = idx.insert(_t(pool[lo:lo + per_round]))
        assert bool(o.alive[_t(ids)].all())
    assert rounds * per_round > o.capacity - n0
    assert o.n_total == n0 and o.n_alive == n0 and o.free_slots == 0
    check_adjacency_invariants(o.adj.numpy(), o.n_total, o.M_max, adj_d=o.adj_d.numpy())
    d, got, _, _ = idx.search(o.X[_t(ids[:8])], k=1, ef_search=64)
    np.testing.assert_array_equal(got[:, 0].numpy(), ids[:8])
    np.testing.assert_allclose(d[:, 0].numpy(), 0.0, atol=1e-4)
    fresh = tonline._edge_distances(o.build_dist, o.adj, o.consts, o.qc_all)
    occ = o.adj >= 0
    torch.testing.assert_close(o.adj_d[occ], fresh[occ], rtol=1e-5, atol=1e-5)


def test_lazy_online_conversion_and_engine_guard(data):
    _, db, X_new = data
    idx = TIndex.build(_t(db[:150]), spec=RetrievalSpec(NN=8, nnd_iters=4))
    assert idx.online is None
    idx.insert(_t(X_new[:10]))
    # 2n by default, and an NN-descent index inserts in waves of 32, as in repro
    assert idx.online.capacity == 300 and idx.online.wave == 32
    assert idx.X.shape[0] == 160  # mirrored high-water state
    with pytest.raises(ValueError, match="online"):
        idx.searcher(K, 48, engine="reference")


def test_online_full_symmetrization_rerank_path(data):
    """search policy min over a mutable index: the beam under min, the rerank
    under KL, deletes respected, distances the original distance's."""
    Q, db, _ = data
    idx = TIndex.build(_t(db[:200]), spec=_spec(build_policy="min", search_policy="min",
                                                 capacity=400))
    dead = np.arange(0, 200, 5)
    idx.delete(dead)
    d, ids, _, _ = idx.search(_t(Q), k=K, ef_search=64, k_c=40)
    assert not np.isin(ids.numpy(), dead).any()
    want = idx.dist.query_matrix(_t(Q[:1]), idx.online.X[ids[0].long()])
    torch.testing.assert_close(d[0], want[0], rtol=1e-4, atol=1e-5)


def test_from_graph_capacity_validation(data):
    _, db, _ = data
    X = _t(db[:64])
    adj = TIndex.build(X, spec=_spec(NN=6, ef_construction=24, wave=16)).neighbors
    kl = RetrievalSpec().base_distance()
    with pytest.raises(ValueError, match="capacity"):
        OnlineIndex.from_graph(X, adj, kl, capacity=32)
    o = OnlineIndex.from_graph(X, adj, kl, capacity=64)  # frozen-full
    with pytest.raises(ValueError, match="capacity"):
        o.insert(_t(db[64:65]))


def test_serve_churn_on_cpu():
    """The churn endpoint through ``main``: slots are recycled, recall holds
    after compaction, every phase is timed and counted (no kernel on the CPU)."""
    from repro_torch.launch import serve as tserve

    stats = tserve.main(["--device", "cpu", "--n-db", "600", "--queries", "64", "--batch", "32",
                         "--ef", "64", "--entries", "2", "--churn-rounds", "2",
                         "--churn-insert", "64", "--churn-delete", "50", "--seed", "1"])
    churn = stats["churn"]
    assert stats["spec"]["capacity"] == 600 + 2 * 64 and stats["spec"]["n_entries"] == 2
    assert churn["inserted"] == 128 and churn["deleted"] == 100
    assert churn["n_alive"] == 600 + 128 - 100
    assert churn["capacity_used"] < 600 + churn["inserted"]  # tombstoned slots recycled
    assert churn["compact_repaired"] > 0
    assert churn["recall@k_after_churn"] >= 0.9
    assert set(churn["kernel_launches"]) == {"insert", "delete", "search", "compact", "audit"}
    assert all(n == 0 for phase in churn["kernel_launches"].values() for n in phase.values())
    with pytest.raises(ValueError, match="engine batched"):
        tserve.build_and_serve(n_db=200, n_queries=8, batch=8, engine="reference",
                               capacity=300, device="cpu", verbose=False)
    with pytest.raises(SystemExit):
        tserve.main(["--device", "cpu", "--spec", RetrievalSpec().to_json(),
                     "--capacity", "100"])
