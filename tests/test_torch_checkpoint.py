"""The port's checkpoints, data pipeline and LM resume (``repro_torch.train.checkpoint``,
``repro_torch.data.pipeline``, ``repro_torch.launch.train``).

The cases of ``tests/test_train_substrate.py``'s checkpoint section, for the
port's own format (raw numpy chunks and a manifest; no msgpack): a round
trip with bf16 leaves and an optimizer state, row chunking, a corrupted
chunk detected, the manager's keep/restart semantics, a crash during a save
leaving the previous step intact, and any shape.  Then ``DataPipeline``'s
resume and error surfacing, ``lm_batch_fn``'s replay and its u * u skew, and ``train_lm`` killed at step k and resumed to 2k from its
checkpoint directory equal to an uninterrupted run bit for bit (SMOKE, f32).
"""

import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import adafactor, adamw, warmup_cosine


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn((64, 32), generator=g),
                   "h": torch.randn((5, 7), generator=g).bfloat16(),
                   "layers": [torch.ones((4,)), torch.zeros((2, 2), dtype=torch.int32)]},
        "opt": {"step": 7, "lr": 0.5, "mu": {"w": torch.full((64, 32), 0.5)}},
    }


def _assert_tree_equal(a, b):
    fa, fb = ckpt._flatten(a), ckpt._flatten(b)
    assert list(fa) == list(fb)
    for name in fa:
        x, y = fa[name], fb[name]
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, name
            assert torch.equal(x, y), name
        else:
            assert type(x) is type(y) and x == y, name


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 100, tree, chunk_mb=1)
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 100
    _assert_tree_equal(tree, restored)
    manifest = json.loads((tmp_path / "step_100" / "manifest.json").read_text())
    assert manifest["entries"]["params/h"]["dtype"] == "bfloat16"
    assert manifest["entries"]["params/h"]["storage"] == "uint16"
    assert manifest["entries"]["opt/step"]["dtype"] == "py_int"


def test_checkpoint_roundtrip_of_an_lm_and_its_optimizer_states(tmp_path):
    """A bf16 LM's params with AdamW's and Adafactor's states, as train_lm saves them."""
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("gemma3-12b"), dtype="bfloat16")
    params = dict(tt.init_params(cfg, torch.Generator().manual_seed(1),
                                 device="cpu").named_parameters())
    for opt in (adamw(warmup_cosine(1e-3, 1, 2)), adafactor(warmup_cosine(1e-3, 1, 2),
                                                            min_dim_factored=32)):
        state = opt.init(params)
        grads = {k: torch.randn_like(p) for k, p in params.items()}
        _, state = opt.update(grads, state, params)
        tree = {"params": params, "opt": state}
        ckpt.save(str(tmp_path), state["step"], tree, chunk_mb=0)
        restored, step = ckpt.restore(str(tmp_path), tree)
        assert step == 1 and restored["opt"]["step"] == 1
        _assert_tree_equal(tree, restored)
        assert restored["params"]["layers.wq"].dtype == torch.bfloat16


def test_checkpoint_chunking_roundtrip(tmp_path):
    tree = {"big": torch.arange(200_000, dtype=torch.float32).reshape(1000, 200)}
    path = ckpt.save(str(tmp_path), 1, tree, chunk_mb=0)  # force row chunking
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert len(manifest["entries"]["big"]["chunks"]) == 1000
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(tree["big"], restored["big"])
    tree = {"big": torch.arange(3 * 2 ** 18, dtype=torch.float32).reshape(3, 2 ** 18)}
    path = ckpt.save(str(tmp_path), 2, tree, chunk_mb=2)  # 1 MiB rows: two per chunk
    manifest = json.loads(open(os.path.join(path, "manifest.json")).read())
    assert [c["shape"][0] for c in manifest["entries"]["big"]["chunks"]] == [2, 1]
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(tree["big"], restored["big"])


def test_checkpoint_corruption_detected(tmp_path):
    tree = _tree()
    path = ckpt.save(str(tmp_path), 5, tree)
    victim = sorted(f for f in os.listdir(path) if f.endswith(".bin"))[0]
    with open(os.path.join(path, victim), "r+b") as f:
        f.seek(0)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="corruption"):
        ckpt.restore(str(tmp_path), tree)


def test_checkpoint_rejects_a_template_of_another_shape(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree)
    other = _tree()
    other["params"]["w"] = torch.zeros((64, 31))
    with pytest.raises(ValueError, match="params/w"):
        ckpt.restore(str(tmp_path), other)


def test_checkpoint_manager_restart_semantics(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), keep=2, every=10)
    tree = _tree()
    assert mgr.maybe_save(5, tree) is None  # not on schedule
    for s in (10, 20, 30):
        assert mgr.maybe_save(s, tree) is not None
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_20", "step_30"]  # keep=2
    restored, last = mgr.resume(tree)
    assert last == 30
    _assert_tree_equal(tree, restored)
    _, last2 = ckpt.CheckpointManager(str(tmp_path / "fresh")).resume(tree)
    assert last2 == -1  # cold start


def test_checkpoint_crash_during_save_leaves_previous_intact(tmp_path):
    """A torn save (a .tmp dir with some chunks and no manifest) does not
    shadow the last good step, and the next save of that step replaces it."""
    tree = _tree()
    ckpt.save(str(tmp_path), 10, tree)
    torn = tmp_path / "step_20.tmp"
    os.makedirs(torn)
    (torn / "0000_0.bin").write_bytes(b"partial")
    restored, step = ckpt.restore(str(tmp_path), tree)
    assert step == 10
    _assert_tree_equal(tree, restored)
    ckpt.CheckpointManager(str(tmp_path), keep=2, every=10)._gc()
    assert (tmp_path / "step_10").is_dir()
    ckpt.save(str(tmp_path), 20, _tree(1))
    assert not torn.exists() and ckpt.latest_step(str(tmp_path)) == 20


@settings(max_examples=10, deadline=None)
@given(rows=st.integers(1, 300), cols=st.integers(1, 20), seed=st.integers(0, 99),
       bf16=st.booleans())
def test_property_checkpoint_any_shape(tmp_path_factory, rows, cols, seed, bf16):
    tmp = tmp_path_factory.mktemp("ck")
    arr = torch.randn((rows, cols), generator=torch.Generator().manual_seed(seed))
    tree = {"x": arr.bfloat16() if bf16 else arr}
    ckpt.save(str(tmp), 0, tree, chunk_mb=0)
    restored, _ = ckpt.restore(str(tmp), tree)
    assert torch.equal(tree["x"], restored["x"])


def test_pipeline_resumes_from_any_step_and_surfaces_errors():
    made = lambda step: {"x": np.full((2,), step)}
    pipe = iter(DataPipeline(made, start_step=0, prefetch=2))
    first = [next(pipe) for _ in range(6)]
    pipe.close()
    assert [s for s, _ in first] == list(range(6)) and pipe.step == 6
    resumed = iter(DataPipeline(made, start_step=4))
    for want in first[4:]:
        s, b = next(resumed)
        assert s == want[0] and np.array_equal(b["x"], want[1]["x"])
    resumed.close()

    def failing(step):
        if step == 2:
            raise ValueError("bad batch 2")
        return step

    pipe = iter(DataPipeline(failing))
    assert [next(pipe)[0] for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="bad batch 2"):
        next(pipe)
    pipe.close()


def test_lm_batches_are_replayable_and_shaped_as_repro():
    cfg = get_smoke_config("llama3.2-1b")
    make = ttrain.lm_batch_fn(cfg, 4, 16)
    a, b = make(3), make(3)
    assert torch.equal(a["tokens"], b["tokens"]) and not torch.equal(a["tokens"],
                                                                      make(4)["tokens"])
    assert tuple(a["tokens"].shape) == tuple(a["labels"].shape) == (4, 16)
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    big = ttrain.lm_batch_fn(cfg, 64, 256)(0)["tokens"]
    assert 0 <= int(big.min()) and int(big.max()) < cfg.vocab_size - 1
    # u * u skews toward small ids: P(id < V / 4) = 1 / 2
    assert abs(float((big < (cfg.vocab_size - 1) / 4).float().mean()) - 0.5) < 0.02


def test_lm_batch_fn_seed_and_token_batches():
    """``lm_batch_fn(seed=)`` draws from ``default_rng((seed, step))``;
    ``token_batches`` and ``lm_batch_fn`` share ``tokens_from_uniforms``, whose
    step from uniforms to tokens equals ``repro``'s on ``repro``'s uniforms."""
    import jax

    from repro.data.synthetic import token_batches as jax_token_batches
    from repro_torch.data.synthetic import token_batches, tokens_from_uniforms

    cfg = get_smoke_config("llama3.2-1b")
    a, b = ttrain.lm_batch_fn(cfg, 4, 16)(2), ttrain.lm_batch_fn(cfg, 4, 16, seed=7)(2)
    assert not torch.equal(a["tokens"], b["tokens"])
    u = np.random.default_rng((7, 2)).random((4, 17), dtype=np.float32)
    for key, t in tokens_from_uniforms(u, cfg.vocab_size).items():
        assert torch.equal(b[key], t), key
    key = jax.random.PRNGKey(3)
    want = list(jax_token_batches(key, 1000, 3, 8, 2))
    for i, w in enumerate(want):  # repro's uniforms for batch i, then the port's step
        uj = np.asarray(jax.random.uniform(jax.random.fold_in(key, i), (3, 9)))
        got = tokens_from_uniforms(uj, 1000)
        for name in ("tokens", "labels"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(w[name]))
    rng, again = np.random.default_rng(5), np.random.default_rng(5)
    batches = list(token_batches(rng, 1000, 3, 8, 2, device="cpu"))
    assert len(batches) == 2
    for got in batches:
        want = tokens_from_uniforms(again.random((3, 9), dtype=np.float32), 1000)
        assert got["tokens"].dtype == torch.int64 and tuple(got["tokens"].shape) == (3, 8)
        assert all(torch.equal(got[k], want[k]) for k in ("tokens", "labels"))


class Crash(Exception):
    pass


def test_train_lm_killed_and_resumed_equals_an_uninterrupted_run(tmp_path, monkeypatch):
    cfg = get_smoke_config("llama3.2-1b")
    kw = dict(steps=8, batch=4, seq=16, log_every=1, block=8, device="cpu")
    model, history = ttrain.train_lm(cfg, **kw)
    d = str(tmp_path / "ck")
    batches = ttrain.lm_batch_fn

    def dies_at_step_4(*args, **kwargs):
        make = batches(*args, **kwargs)

        def made(step):
            if step == 4:
                raise Crash("killed before step 4")
            return make(step)

        return made

    monkeypatch.setattr(ttrain, "lm_batch_fn", dies_at_step_4)
    with pytest.raises(Crash):
        ttrain.train_lm(cfg, ckpt_dir=d, ckpt_every=3, **kw)
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 3  # steps 0-3 ran, checkpoints at 0 and 3
    resumed_model, resumed = ttrain.train_lm(cfg, ckpt_dir=d, ckpt_every=3, **kw)
    assert [h["step"] for h in resumed] == list(range(4, 8))
    assert [h["loss"] for h in resumed] == [h["loss"] for h in history[4:]]
    for (name, a), (_, b) in zip(model.named_parameters(), resumed_model.named_parameters()):
        assert torch.equal(a, b), name
    assert sorted(os.listdir(d)) == ["LATEST", "step_3", "step_6"]  # keep=2


def test_main_trains_the_lm_on_the_cpu():
    history = ttrain.main(["--device", "cpu", "--smoke", "--steps", "3", "--batch", "2",
                           "--seq", "16"])
    assert [h["step"] for h in history] == [0, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
