"""The port's spans and counters (``repro_torch.core.trace``) on the CPU.

Off, a span site is a flag read: no record, no ``record_function``.  Under
``trace.capture()`` or ``torch.profiler``, the search's, the scheduler's and
NN-descent's spans count what the code did (lock-steps through a counting
wrapper of ``beam_step``, ticks through one of ``tick``, results through one
of ``_retire``), nest under their parents, and change no answer.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import batched_beam, nndescent, scheduler, trace
from repro_torch.core.distances import get_distance
from repro_torch.core.index import ANNIndex
from repro_torch.core.spec import RetrievalSpec

N, NQ, DIM = 400, 24, 16
SPEC = RetrievalSpec(distance="kl", builder="nndescent", NN=8, nnd_iters=3, ef_search=32,
                     k=10, slots=8, sched_frontier=4)


@pytest.fixture(scope="module")
def data():
    X = np.random.default_rng(7).dirichlet(np.full(DIM, 0.3), N + NQ).astype(np.float32)
    X = torch.from_numpy(np.maximum(X, 1e-6))
    idx = ANNIndex.build(X[:N].contiguous(), spec=SPEC,
                         generator=torch.Generator().manual_seed(0))
    return idx, X[N:].contiguous()


def _counting(monkeypatch, owner, name):
    """Replace ``owner.name`` by a wrapper that counts its calls and results."""
    fn = getattr(owner, name)
    calls = []

    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(owner, name, counted)
    return calls


def test_off_records_nothing_and_enters_no_record_function(data, monkeypatch):
    idx, Q = data

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with trace.capture() as rec:  # an empty stretch: the record starts empty
        pass
    assert rec["spans"] == {} and not trace._on
    a, b = trace.span("search.step", device=True), trace.span("other")
    assert a is b is trace._OFF
    with a:
        pass
    idx.searcher()(Q)
    assert trace.snapshot()["spans"] == {}


def test_search_spans_count_lock_steps(data, monkeypatch):
    idx, Q = data
    steps = _counting(monkeypatch, batched_beam, "beam_step")
    search = idx.searcher()
    with trace.capture() as rec:
        search(Q)
    sp = rec["spans"]
    assert sp["search.batch"]["count"] == 1
    assert sp["search.step"]["count"] == len(steps) > 0
    assert sp["search.sync"]["count"] == len(steps) + 1
    assert sp["search.seed"]["count"] == 1
    for child in ("search.step", "search.sync", "search.seed"):
        assert sp[child]["parent"] == "search.batch"
    children = sum(v["host_s"] for v in sp.values() if v["parent"] == "search.batch")
    batch = sp["search.batch"]
    assert batch["self_s"] == pytest.approx(batch["host_s"] - children, abs=1e-9)
    assert 0 <= batch["self_s"] <= batch["host_s"]
    # on the CPU a device span's device time is its host time
    assert batch["device_s"] == pytest.approx(batch["host_s"], rel=0.05, abs=1e-4)


def test_stream_spans_count_ticks_and_results(data, monkeypatch):
    idx, Q = data
    sched = idx.scheduler()
    Qn = Q.numpy()
    arrivals = np.linspace(0.0, 0.02, Qn.shape[0])
    sched.warmup(Qn[0])
    ticks = _counting(monkeypatch, scheduler.SlotScheduler, "tick")
    retired = _counting(monkeypatch, scheduler.SlotScheduler, "_retire")
    with trace.capture() as rec:
        res = sched.run_stream(Qn, arrivals, warm=False, tick_cost=1e-3)
    sp = rec["spans"]
    assert sp["sched.tick"]["count"] == len(ticks) > 0
    assert sp["sched.retire"]["count"] == len(retired)
    assert sorted(r.rid for out in retired for r in out) == list(range(Qn.shape[0]))
    assert len(res) == Qn.shape[0]
    for child in ("sched.admit", "sched.step", "sched.sync", "sched.retire"):
        assert sp[child]["parent"] == "sched.tick"
    assert sp["sched.step"]["count"] == sp["sched.sync"]["count"] <= sp["sched.tick"]["count"]
    assert sp["sched.submit"]["parent"] is None and sp["sched.collect"]["count"] == len(ticks)


def test_profiler_holds_the_spans_and_each_segment_its_own(data):
    idx, Q = data
    search = idx.searcher()
    X = idx.X
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        search(Q)
    names = {e.name for e in prof.events()}
    assert {"search.batch", "search.step", "search.sync"} <= names
    # operator ranges, not user annotations: the profiler copies no span onto the device
    assert not any(e.is_user_annotation for e in prof.events() if e.name.startswith("search."))
    assert "search.batch" in trace.snapshot()["spans"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        nndescent.build_nndescent(get_distance("kl"), X, torch.Generator().manual_seed(1),
                                  K=6, iters=2)
    assert {"build.nndescent", "build.round", "build.dedup"} <= {e.name for e in prof.events()}
    sp = trace.snapshot()["spans"]
    assert "search.batch" not in sp
    assert sp["build.round"]["count"] == 2 and sp["build.round"]["parent"] == "build.nndescent"
    assert sp["build.join"]["parent"] == sp["build.dedup"]["parent"] == "build.round"
    assert sp["build.init"]["count"] == sp["build.reverse"]["count"] == 1


def test_answers_equal_with_tracing_on_and_off(data):
    idx, Q = data
    search = idx.searcher()
    X = idx.X

    def build():
        return nndescent.build_nndescent(get_distance("kl"), X,
                                         torch.Generator().manual_seed(3), K=6, iters=2)

    off = search(Q), build()
    with trace.capture() as rec:
        on = search(Q), build()
    assert rec["spans"]["search.batch"]["count"] == 1
    assert rec["spans"]["build.nndescent"]["count"] == 1
    for a, b in zip(off[0] + off[1], on[0] + on[1]):
        assert torch.equal(a, b)


def test_counters_hold_launches_marks_and_times():
    from repro_torch.kernels import ops

    assert set(ops.launch_counts()) == {"frontier_scores", "two_hop_scores", "gather_scores",
                                        "distance_matrix"}
    trace.count("launches.gather_scores", 3)
    assert ops.launch_counts()["gather_scores"] >= 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
    trace.high("x.max", 5)
    trace.high("x.max", 2)
    with trace.timed("x.seconds"):
        pass
    got = trace.counters("x.")
    assert got["max"] == 5 and got["seconds"] >= 0.0
    trace.reset("x.")
    assert trace.counters("x.") == {}


@pytest.mark.gpu
def test_device_span_times_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = torch.randn(2048, 2048, device="cuda")
    torch.cuda.synchronize()
    with trace.capture() as rec:
        with trace.span("matmuls", device=True):
            for _ in range(20):
                a = a @ a / 2048
    sp = rec["spans"]["matmuls"]
    assert sp["count"] == 1 and sp["device_s"] > 0
