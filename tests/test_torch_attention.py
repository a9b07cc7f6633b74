"""Port parity for the LM layers (``repro_torch.models.layers``).

The same numpy inputs go through ``repro.models.layers`` and the port:
``rms_norm``, ``apply_rope`` and ``swiglu`` within 1e-6; ``blockwise_attention``'s
forward on ``tests/test_attention.py``'s grid of (T, block_q, block_kv) and
windows, with GQA groups 1, 2 and 4 and a ``q_offset``, within rtol = atol =
2e-5 (``repro``'s own tolerance against its naive attention); (dq, dk, dv) of
the port's ``autograd.Function`` against ``jax.grad`` through ``repro``'s custom
VJP within 1e-5; both again with ``causal=False``; ``decode_attention_local`` and ``lse_combine`` with a window,
a ``pos_offset`` and a two-part combine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: a thread pool in each of the parallel test workers
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, B, T, Hq, Hkv, dh, Tk=None):
    rng = np.random.default_rng(seed)
    Tk = Tk or T
    return (rng.standard_normal((B, T, Hq, dh)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, Tk, Hkv, dh)).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def test_rms_norm_rope_swiglu_match_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    gamma = rng.standard_normal((16,)).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(torch.tensor(x), torch.tensor(gamma), 1e-5).numpy(),
                               np.asarray(jl.rms_norm(x, gamma, 1e-5)), **TOL)
    pos = np.broadcast_to(np.arange(7, 12), (2, 5)).astype(np.int32)
    for theta in (10_000.0, 500_000.0):
        np.testing.assert_allclose(
            tl.apply_rope(torch.tensor(x), torch.tensor(pos), theta).numpy(),
            np.asarray(jl.apply_rope(x, pos, theta)), **TOL)
    np.testing.assert_allclose(tl.rope_freqs(16, 500_000.0).numpy(),
                               np.asarray(jl.rope_freqs(16, 500_000.0)), **TOL)
    h = rng.standard_normal((4, 16)).astype(np.float32)
    wg, wu = (rng.standard_normal((16, 24)).astype(np.float32) * 0.25 for _ in range(2))
    wd = rng.standard_normal((24, 16)).astype(np.float32) * 0.2
    np.testing.assert_allclose(tl.swiglu(*_t(h, wg, wu, wd)).numpy(),
                               np.asarray(jl.swiglu(h, wg, wu, wd)), **TOL)


def test_rms_norm_casts_before_gamma_in_bf16():
    """bf16: normalised in float32, cast to bf16, THEN scaled by gamma (bf16)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    got = tl.rms_norm(torch.tensor(x).bfloat16(), torch.tensor(gamma).bfloat16())
    want = jl.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.mark.parametrize("T,bq,bk", [(32, 8, 8), (33, 8, 16), (64, 64, 64)])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_blockwise_forward_matches_repro(T, bq, bk, window, g):
    q, k, v = _qkv(T + g, 2, T, 2 * g, 2, 16)
    for q_offset in (0, 5):
        want = jl.blockwise_attention(q, k, v, causal=True, window=window, block_q=bq,
                                      block_kv=bk, q_offset=q_offset)
        got = tl.blockwise_attention(*_t(q, k, v), window=window, block_q=bq, block_kv=bk, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


def test_blockwise_gqa_uses_kv_head_h_mod_hkv():
    """q head h attends with kv head h % Hkv: with one kv head set to zero
    values, exactly the q heads h with h % Hkv == that head output zero."""
    q, k, v = _qkv(3, 1, 12, 8, 2, 8)
    v[:, :, 1] = 0.0
    out = tl.blockwise_attention(*_t(q, k, v), block_q=4, block_kv=4).numpy()
    for h in range(8):
        assert (np.abs(out[:, :, h]).max() == 0.0) == (h % 2 == 1), h


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("g,T,bq,bk,q_offset", [(2, 24, 8, 8, 0), (1, 21, 8, 16, 3),
                                                (4, 17, 16, 4, 0)])
def test_blockwise_gradients_match_repro_custom_vjp(window, g, T, bq, bk, q_offset):
    q, k, v = _qkv(10 + T, 2, T, 2 * g, 2, 8)

    def f(q, k, v):
        o = jl.blockwise_attention(q, k, v, causal=True, window=window, block_q=bq,
                                   block_kv=bk, q_offset=q_offset)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tl.blockwise_attention(tq, tk, tv, window=window, block_q=bq, block_kv=bk, q_offset=q_offset)
    got = torch.autograd.grad(torch.sum(torch.sin(out)), (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("T,bq,bk", [(32, 8, 8), (33, 8, 16), (64, 64, 64)])
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_blockwise_noncausal_forward_matches_repro(T, bq, bk, window, g):
    q, k, v = _qkv(T + g, 2, T, 2 * g, 2, 16)
    for q_offset in (0, 5):
        want = jl.blockwise_attention(q, k, v, causal=False, window=window, block_q=bq,
                                      block_kv=bk, q_offset=q_offset)
        got = tl.blockwise_attention(*_t(q, k, v), causal=False, window=window, block_q=bq,
                                     block_kv=bk, q_offset=q_offset)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("g,T,bq,bk,q_offset", [(2, 24, 8, 8, 0), (1, 21, 8, 16, 3),
                                                (4, 17, 16, 4, 0)])
def test_blockwise_noncausal_gradients_match_repro_custom_vjp(window, g, T, bq, bk, q_offset):
    q, k, v = _qkv(10 + T, 2, T, 2 * g, 2, 8)

    def f(q, k, v):
        o = jl.blockwise_attention(q, k, v, causal=False, window=window, block_q=bq,
                                   block_kv=bk, q_offset=q_offset)
        return jnp.sum(jnp.sin(o))

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = _t(q, k, v, grad=True)
    out = tl.blockwise_attention(tq, tk, tv, causal=False, window=window, block_q=bq,
                                 block_kv=bk, q_offset=q_offset)
    got = torch.autograd.grad(torch.sum(torch.sin(out)), (tq, tk, tv))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL, err_msg=f"d{name}")


def test_blockwise_noncausal_sees_later_keys():
    """Without the causal mask the first query's output moves when the last
    key's value does; with it, it does not."""
    q, k, v = _qkv(5, 1, 16, 2, 2, 8)
    v2 = v.copy()
    v2[:, -1] += 1.0
    for causal in (True, False):
        a = tl.blockwise_attention(*_t(q, k, v), causal=causal, block_q=4, block_kv=4)
        b = tl.blockwise_attention(*_t(q, k, v2), causal=causal, block_q=4, block_kv=4)
        assert torch.equal(a[:, 0], b[:, 0]) == causal


def test_blockwise_saves_q_k_v_lse_only():
    q, k, v = _t(*_qkv(4, 1, 16, 4, 2, 8), grad=True)
    out = tl.blockwise_attention(q, k, v, block_q=8, block_kv=8)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 4 and saved[0] is q and saved[1] is k and saved[2] is v
    assert tuple(saved[3].shape) == (1, 2, 2, 2, 8)  # lse (B, nq, g, Hkv, bq)


@pytest.mark.parametrize("window,pos_offset", [(0, 0), (6, 0), (0, 9), (5, 9)])
def test_decode_attention_and_combine_match_repro(window, pos_offset):
    rng = np.random.default_rng(window + pos_offset)
    B, S, Hkv, dh, g = 3, 20, 2, 8, 2
    q = rng.standard_normal((B, g * Hkv, dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    total = np.array([pos_offset + 4, pos_offset + 13, pos_offset + 20], np.int32)
    want = jl.decode_attention_local(q, kc, vc, total, window=window, pos_offset=pos_offset)
    got = tl.decode_attention_local(*_t(q, kc, vc), torch.tensor(total), window=window,
                                    pos_offset=pos_offset)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tl.lse_combine([got]).numpy(),
                               np.asarray(jl.lse_combine([want])), **TOL)
    # two chunks of the cache, each at its absolute offset, combine exactly
    cut = 11
    parts_j = [jl.decode_attention_local(q, kc[:, :cut], vc[:, :cut], total, window=window,
                                         pos_offset=pos_offset),
               jl.decode_attention_local(q, kc[:, cut:], vc[:, cut:], total, window=window,
                                         pos_offset=pos_offset + cut)]
    parts_t = [tl.decode_attention_local(*_t(q, kc[:, :cut], vc[:, :cut]), torch.tensor(total),
                                         window=window, pos_offset=pos_offset),
               tl.decode_attention_local(*_t(q, kc[:, cut:], vc[:, cut:]), torch.tensor(total),
                                         window=window, pos_offset=pos_offset + cut)]
    np.testing.assert_allclose(tl.lse_combine(parts_t).numpy(),
                               np.asarray(jl.lse_combine(parts_j)), **TOL)
    np.testing.assert_allclose(tl.lse_combine(parts_t).numpy(), tl.lse_combine([got]).numpy(),
                               **TOL)


def test_decode_attention_bf16_cache_accumulates_in_f32():
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.standard_normal((2, 4, 16)), jnp.bfloat16)
    kc = jnp.asarray(rng.standard_normal((2, 64, 2, 16)), jnp.bfloat16)
    vc = jnp.asarray(rng.standard_normal((2, 64, 2, 16)), jnp.bfloat16)
    want = jl.decode_attention_local(q, kc, vc, jnp.int32(50), window=16)
    bf = lambda a: torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)
    got = tl.decode_attention_local(bf(q), bf(kc), bf(vc), 50, window=16)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
