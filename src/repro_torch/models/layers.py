"""Shared layers (PyTorch port of ``repro.models.layers``).

``dense_init``, the norm and rotary embedding, blockwise (flash-schedule)
attention with its own backward, one-token decode attention with the
log-sum-exp combine, and the SwiGLU MLP.  Attention is the port's own code:
no library attention (``scaled_dot_product_attention``, cuDNN) and no
``torch.compile`` stands in for it.

Blockwise attention computes in float32 tiles of (block_q x block_kv) with
a running max and denominator, so (T, T) scores never materialise.  The
Python loop runs over kv blocks; each step scores every q block at once,
which is ``repro``'s per-q-block scan with the q blocks batched.  The
backward recomputes the probability tiles from the saved log-sum-exp (a
delta sweep, then kv-block-outer recomputation) and saves ``q, k, v, lse``:
neither the output nor the probabilities.

GQA grouping: q is viewed as (B, T, g, Hkv, dh), so q head h uses kv head
``h % Hkv`` (not ``h // g``: no ``repeat_interleave``).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def dense_init(generator, d_in: int, d_out: int, scale: Optional[float] = None,
               device="cpu", dtype=torch.float32) -> torch.Tensor:
    """(d_in, d_out) weights, N(0, 1) x ``scale`` (default d_in^-1/2) drawn in
    float32, then cast to ``dtype``."""
    scale = scale if scale is not None else d_in ** -0.5
    return (torch.randn((d_in, d_out), generator=generator, device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# norms / rope
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float = 1e-5):
    """In float32, cast back to ``x.dtype``, THEN scaled by ``gamma`` (bf16
    parity with ``repro`` depends on that order)."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * gamma


def rope_freqs(d_head: int, theta: float, device="cpu"):
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32, device=device)
                            / d_head))


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, d_head); positions: (..., T) integer.  Half-split
    rotation (not interleaved), in float32, cast back to ``x.dtype``."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., :, None, None].float() * freqs  # (..., T, 1, dh/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise attention (training / prefill)
# ---------------------------------------------------------------------------


def _tile_mask(q_pos, kv_pos, causal: bool, window: int):
    """(..., bq, bk) bool mask of q positions ``q_pos`` (..., bq) against kv
    positions ``kv_pos`` (bk,): no later key when ``causal``, and no key
    ``window`` or more behind (``window`` <= 0: no limit)."""
    diff = q_pos[..., :, None] - kv_pos
    m = (window <= 0) | (diff < window)
    return m & (diff >= 0) if causal else m


def _pad_blocks(q, k, v, block_q: int, block_kv: int):
    Tq, Tk = q.shape[1], k.shape[1]
    block_q = min(block_q, Tq)
    block_kv = min(block_kv, Tk)
    pq = (-Tq) % block_q
    pk = (-Tk) % block_kv
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
    return q, k, v, block_q, block_kv


def _blocks(q, k, v, block_q, block_kv, q_offset):
    """Padded q as (B, nq, bq, g, Hkv, dh) float32, the padded k and v, and
    the positions: q (nq, bq), kv (nk, bk), and kv validity (nk, bk)."""
    B, Tq, Hq, dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    qp, kp, vp, bq, bk = _pad_blocks(q, k, v, block_q, block_kv)
    nq, nk = qp.shape[1] // bq, kp.shape[1] // bk
    qb = qp.reshape(B, nq, bq, Hq // Hkv, Hkv, dh).float()
    q_pos = q_offset + torch.arange(nq * bq, device=q.device).reshape(nq, bq)
    kv_pos = torch.arange(nk * bk, device=q.device).reshape(nk, bk)
    return qb, kp, vp, bk, q_pos, kv_pos, kv_pos < Tk


def _tile_probs(qb, k_blk, q_pos, kv_pos, valid, causal, window, scale, lse=None):
    """Scores of every q block against one kv block, (B, nq, g, Hkv, bq, bk)
    float32, masked to NEG_INF; with ``lse``, the probabilities (0 where
    masked)."""
    s = torch.einsum("bnqghd,bkhd->bnghqk", qb, k_blk) * scale
    mask = (_tile_mask(q_pos, kv_pos, causal, window) & valid)[None, :, None, None]
    if lse is None:
        return torch.where(mask, s, NEG_INF)
    return torch.where(mask, torch.exp(s - lse[..., None]), 0.0)


def _flash_fwd(q, k, v, causal, window, block_q, block_kv, q_offset):
    """Tiled forward: (out (B, Tq, Hq, dh) in q's dtype, lse (B, nq, g, Hkv, bq) f32)."""
    B, Tq, Hq, dh = q.shape
    scale = dh ** -0.5
    qb, kp, vp, bk, q_pos, kv_pos, kv_valid = _blocks(q, k, v, block_q, block_kv, q_offset)
    nq, bq, g, Hkv = qb.shape[1], qb.shape[2], qb.shape[3], qb.shape[4]
    m = torch.full((B, nq, g, Hkv, bq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nq, g, Hkv, bq, dh), dtype=torch.float32, device=q.device)
    for j in range(kv_pos.shape[0]):
        k_blk = kp[:, j * bk:(j + 1) * bk].float()
        v_blk = vp[:, j * bk:(j + 1) * bk].float()
        s = _tile_probs(qb, k_blk, q_pos, kv_pos[j], kv_valid[j], causal, window, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bnghqk,bkhd->bnghqd", p, v_blk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))  # rows with no key stay ~NEG_INF
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, nq * bq, Hq, dh)
    return out[:, :Tq].to(q.dtype), lse


def _flash_bwd(q, k, v, lse, dout, causal, window, block_q, block_kv, q_offset):
    """Flash backward: recompute the tiles from ``lse``, never store (T, T) probs."""
    B, Tq, Hq, dh = q.shape
    Tk = k.shape[1]
    scale = dh ** -0.5
    qb, kp, vp, bk, q_pos, kv_pos, kv_valid = _blocks(q, k, v, block_q, block_kv, q_offset)
    nq, bq = qb.shape[1], qb.shape[2]
    dob = F.pad(dout, (0, 0, 0, 0, 0, nq * bq - Tq)).reshape(qb.shape).float()
    nk = kv_pos.shape[0]
    kv = [(kp[:, j * bk:(j + 1) * bk].float(), vp[:, j * bk:(j + 1) * bk].float())
          for j in range(nk)]

    # delta_i = sum_k p_ik (dout_i . v_k): recomputed in a first sweep, so the
    # output need not be saved
    delta = torch.zeros_like(lse)
    for j, (k_blk, v_blk) in enumerate(kv):
        p = _tile_probs(qb, k_blk, q_pos, kv_pos[j], kv_valid[j], causal, window, scale,
                        lse)
        dov = torch.einsum("bnqghd,bkhd->bnghqk", dob, v_blk)
        delta = delta + torch.sum(p * dov, dim=-1)

    dq = torch.zeros_like(qb)
    dks, dvs = [], []
    for j, (k_blk, v_blk) in enumerate(kv):
        p = _tile_probs(qb, k_blk, q_pos, kv_pos[j], kv_valid[j], causal, window, scale,
                        lse)
        dvs.append(torch.einsum("bnghqk,bnqghd->bkhd", p, dob))
        dp = torch.einsum("bnqghd,bkhd->bnghqk", dob, v_blk)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bnghqk,bkhd->bnqghd", ds, k_blk)
        dks.append(torch.einsum("bnghqk,bnqghd->bkhd", ds, qb))
    dq = dq.reshape(B, nq * bq, Hq, dh)[:, :Tq]
    dk = torch.cat(dks, dim=1)[:, :Tk]
    dv = torch.cat(dvs, dim=1)[:, :Tk]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """``repro``'s ``jax.custom_vjp`` of the flash schedule."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, block_q, block_kv, q_offset):
        out, lse = _flash_fwd(q, k, v, causal, window, block_q, block_kv, q_offset)
        ctx.save_for_backward(q, k, v, lse)
        ctx.args = (causal, window, block_q, block_kv, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        block_q: int = 512, block_kv: int = 512, q_offset: int = 0):
    """Flash attention with its own backward. q: (B, Tq, Hq, dh); k, v: (B,
    Tk, Hkv, dh).

    ``causal=False`` lets every query see every key (an encoder);
    ``window`` > 0 = sliding window (a plain int per layer); ``q_offset`` =
    the absolute position of q's first row.  T need not be a multiple of
    the blocks (padded rows and keys are masked).
    """
    return _FlashAttention.apply(q, k, v, bool(causal), int(window), int(block_q),
                                 int(block_kv), int(q_offset))


# ---------------------------------------------------------------------------
# decode attention (one new token against the KV cache) + LSE combine
# ---------------------------------------------------------------------------


def decode_attention_local(q, k_cache, v_cache, cache_len, *, window: int = 0,
                           pos_offset: int = 0):
    """One-token attention against a KV chunk.

    q: (B, Hq, dh); k/v_cache: (B, S, Hkv, dh); cache_len: () or (B,) TOTAL
    valid length in absolute positions; ``pos_offset`` is the absolute
    position of this chunk's first slot.  Returns (out_unnorm (B, Hq, dh)
    f32, m (B, Hq), l (B, Hq)), combinable across chunks with ``lse_combine``.
    """
    B, S, Hkv, dh = k_cache.shape
    Hq = q.shape[1]
    if Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    scale = dh ** -0.5
    qg = q.reshape(B, Hq // Hkv, Hkv, dh)
    # repro multiplies in the cache's storage dtype with f32 accumulation; a bf16
    # torch.einsum would return (and accumulate in) bf16, so the operands are
    # upcast first: an f32 copy of one layer's cache (2x its bytes) per step
    s = torch.einsum("bghd,bshd->bghs", qg.float(), k_cache.float()) * scale
    pos = pos_offset + torch.arange(S, device=k_cache.device)
    total = torch.as_tensor(cache_len, device=k_cache.device).reshape(-1, 1)
    valid = pos[None, :] < total
    valid &= (window <= 0) | (pos[None, :] >= total - window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bghs,bshd->bghd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(B, Hq, dh), m.reshape(B, Hq), l.reshape(B, Hq)


def lse_combine(parts):
    """Combine flash-decoding partials [(out, m, l), ...] exactly."""
    outs, ms, ls = zip(*parts)
    m_g = functools.reduce(torch.maximum, ms)
    num = sum(o * torch.exp(m - m_g)[..., None] for o, m in zip(outs, ms))
    den = sum(l * torch.exp(m - m_g) for l, m in zip(ls, ms))
    return num / torch.clamp(den[..., None], min=1e-30)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down
