"""Attention (port of ``repro.models.attention``): the blockwise
online-softmax path with its flash backward, the dense reference, one-token
decode against a float cache, and decode against a posit-coded cache.

``blockwise_attention`` carries the reference's online-softmax loop as it
is (outer loop over query blocks, inner loop over KV blocks, (m, l, acc)
in f32), so CPU parity with the JAX package holds; it is plain tensor code,
not a kernel.  Its gradient is the reference's flash backward
(``_Flash``, a ``torch.autograd.Function``): the forward saves only the
output and the per-row logsumexp, the backward recomputes each score tile
once.  ``vjp="naive"`` differentiates the forward loop instead.  A
``window`` makes the attention local (the hybrid family's): query q sees
key k where ``q - k < window``, in the forward and the backward alike.
"""
from __future__ import annotations

import torch

from ..kernels import kv_cache as kv_kernels
from ..launch.op_cost import custom_call
from .common import _einsum

NEG_INF = -1e30


def _bias_block(qpos, kpos, causal: bool, window, skv):
    """(qb, kvb) additive mask for one (q_block, kv_block) tile."""
    b = torch.zeros((qpos.shape[0], kpos.shape[0]), dtype=torch.float32,
                    device=qpos.device)
    if causal:
        b = torch.where(qpos[:, None] >= kpos[None, :], b, NEG_INF)
    if window is not None:
        b = torch.where(qpos[:, None] - kpos[None, :] < window, b, NEG_INF)
    if skv is not None:
        b = torch.where(kpos[None, :] < skv, b, NEG_INF)
    return b


def dense_attention(q, k, v, *, causal=True, window=None, positions=None):
    """Reference attention.  q: (B, S, nh, hd), k/v: (B, S, nkv, hd)."""
    b, sq, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(b, sq, nkv, nh // nkv, hd) * (hd ** -0.5)
    scores = _einsum("bqkgh,bskh->bkgqs", qg, k)
    qpos = (positions if positions is not None
            else torch.arange(sq, device=q.device))
    kpos = torch.arange(k.shape[1], device=q.device)
    scores = scores + _bias_block(qpos, kpos, causal, window, None)
    p = torch.softmax(scores.to(torch.float32), dim=-1).to(q.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(b, sq, nh, hd)


def _rep(x, grp):
    return x.repeat_interleave(grp, dim=2) if grp > 1 else x


def _flash_fwd(q, k, v, causal, window, q_block, kv_block, skv):
    """q pre-scaled (B, Sp, nh, hd); k/v (B, Skp, nkv, hd); Sp/Skp padded.
    Returns (out (B, Sp, nh, hd) in q's dtype, lse (B, nh, Sp) f32)."""
    b, sp, nh, hd = q.shape
    skp, nkv = k.shape[1], k.shape[2]
    grp = nh // nkv
    dev = q.device
    outs, lses = [], []
    for q0 in range(0, sp, q_block):
        qblk = q[:, q0:q0 + q_block]                  # (B, qb, nh, hd)
        qpos = q0 + torch.arange(q_block, device=dev)
        m = torch.full((b, nh, q_block), NEG_INF, device=dev)
        l = torch.zeros((b, nh, q_block), device=dev)
        acc = torch.zeros((b, nh, q_block, hd), device=dev)
        for k0 in range(0, skp, kv_block):
            kblk = _rep(k[:, k0:k0 + kv_block], grp)
            vblk = _rep(v[:, k0:k0 + kv_block], grp)
            kpos = k0 + torch.arange(kv_block, device=dev)
            s_blk = torch.einsum("bqhd,bshd->bhqs", qblk, kblk).to(
                torch.float32)
            s_blk = s_blk + _bias_block(qpos, kpos, causal, window, skv)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(q.dtype), vblk).to(torch.float32)
            m = m_new
        l = l.clamp(min=1e-30)
        outs.append(acc / l[..., None])
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=2)                      # (B, nh, Sp, hd)
    return out.transpose(1, 2).to(q.dtype), torch.cat(lses, dim=2)


class _Flash(torch.autograd.Function):
    """Flash attention with the reference's single-pass backward:

        dS = P * (dP - D),  dP = dO V^T,  D = rowsum(dO * O)
        dQ = dS K,  dK = dS^T Q,  dV = P^T dO

    every (q block, kv block) tile is recomputed once; dK/dV accumulate per
    KV block, dQ in a full f32 buffer; the repeated GQA heads fold back onto
    the KV heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block, skv):
        out, lse = _flash_fwd(q, k, v, causal, window, q_block, kv_block,
                              skv)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, window, q_block, kv_block, skv)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_block, kv_block, skv = ctx.cfg
        b, sp, nh, hd = q.shape
        skp, nkv = k.shape[1], k.shape[2]
        grp = nh // nkv
        dev = q.device
        f32 = torch.float32
        g = g.to(q.dtype)
        d_rows = torch.einsum("bshd,bshd->bhs", g.to(f32), out.to(f32))
        dq = torch.zeros((b, sp, nh, hd), dtype=f32, device=dev)
        dks, dvs = [], []
        for k0 in range(0, skp, kv_block):
            kblk = _rep(k[:, k0:k0 + kv_block], grp)
            vblk = _rep(v[:, k0:k0 + kv_block], grp)
            kpos = k0 + torch.arange(kv_block, device=dev)
            dk = torch.zeros((b, kv_block, nh, hd), dtype=f32, device=dev)
            dv = torch.zeros_like(dk)
            for q0 in range(0, sp, q_block):
                qblk, gblk = q[:, q0:q0 + q_block], g[:, q0:q0 + q_block]
                qpos = q0 + torch.arange(q_block, device=dev)
                s_blk = torch.einsum("bqhd,bshd->bhqs", qblk, kblk).to(f32)
                s_blk = s_blk + _bias_block(qpos, kpos, causal, window,
                                            skv)
                p = torch.exp(s_blk - lse[:, :, q0:q0 + q_block, None])
                dp = torch.einsum("bqhd,bshd->bhqs", gblk, vblk).to(f32)
                ds = p * (dp - d_rows[:, :, q0:q0 + q_block, None])
                dv = dv + torch.einsum("bhqs,bqhd->bshd", p.to(q.dtype),
                                       gblk).to(f32)
                dk = dk + torch.einsum("bhqs,bqhd->bshd", ds.to(q.dtype),
                                       qblk).to(f32)
                dq[:, q0:q0 + q_block] += torch.einsum(
                    "bhqs,bshd->bqhd", ds.to(q.dtype), kblk).to(f32)
            if grp > 1:
                dk = dk.reshape(b, kv_block, nkv, grp, hd).sum(3)
                dv = dv.reshape(b, kv_block, nkv, grp, hd).sum(3)
            dks.append(dk)
            dvs.append(dv)
        return (dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype),
                torch.cat(dvs, 1).to(v.dtype), None, None, None, None, None)


def blockwise_attention(q, k, v, *, causal=True, window=None, q_block=512,
                        kv_block=1024, vjp="flash"):
    """Flash-style online-softmax attention.

    q: (B, S, nh, hd); k/v: (B, S, nkv, hd).  GQA repeats the KV heads per
    block inside the loop, as the reference does.  ``vjp="flash"`` (the
    default) differentiates through ``_Flash``'s backward; ``"naive"``
    through the forward loop (autograd saves every probability tile)."""
    if vjp not in ("flash", "naive"):
        raise ValueError(f"vjp must be 'flash' or 'naive', got {vjp!r}")
    b, s, nh, hd = q.shape
    skv = k.shape[1]
    q_block = min(q_block, s)
    kv_block = min(kv_block, skv)
    pq, pk = -s % q_block, -skv % kv_block
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    qs = (q * (hd ** -0.5)).to(q.dtype)
    skv_mask = skv if pk else None
    if vjp == "naive":
        out = _flash_fwd(qs, k, v, causal, window, q_block, kv_block,
                         skv_mask)[0]
    else:
        out = _Flash.apply(qs, k, v, causal, window, q_block, kv_block,
                           skv_mask)
    return out[:, :s]


def decode_attention(q, k_cache, v_cache, cache_len):
    """One-token attention against a float cache; the T=1 case of
    ``chunk_decode_attention``.  q: (B, 1, nh, hd); k/v_cache:
    (B, W, nkv, hd); cache_len scalar or (B,).  Returns (B, 1, nh, hd)."""
    b = q.shape[0]
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    return chunk_decode_attention(q, k_cache, v_cache, cl[:, None] - 1)


def chunk_decode_attention(q, k_cache, v_cache, qpos):
    """T-token causal attention against a cache.  q: (B, T, nh, hd);
    qpos: (B, T) absolute position of each query token (its K/V row is
    already in the cache).  Returns (B, T, nh, hd)."""
    b, w, nkv, hd = k_cache.shape
    t, nh = q.shape[1], q.shape[2]
    grp = nh // nkv
    qg = q.reshape(b, t, nkv, grp, hd) * (hd ** -0.5)
    scores = _einsum("bqkgh,bskh->bkgqs", qg, k_cache).to(torch.float32)
    valid = (torch.arange(w, device=q.device)[None, None, :]
             < (qpos + 1)[:, :, None])
    scores = torch.where(valid[:, None, None, :, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = _einsum("bkgqs,bskh->bqkgh", p, v_cache)
    return out.reshape(b, t, nh, hd)


def decode_attention_packed(q, k_codes, v_codes, cache_len, *, k_scale,
                            v_scale, spec):
    """One-token attention against a posit-coded cache (decode-on-read).

    k/v_codes: (B, W, nkv, Dc); k/v_scale: (B, W, nkv) f32; ``spec`` a
    ``core.transprecision.KVStorage``.  CUDA tensors go to the fused K4
    kernel (output in q's dtype); CPU tensors decode the ring to f32 and
    run ``decode_attention``, as the reference's CPU path does (a meta
    trace counts that as K4's one launch: ``op_cost.custom_call``)."""
    if q.is_cuda:
        return kv_kernels.decode_attention(
            q, k_codes, k_scale, v_codes, v_scale, cache_len, spec.fmt,
            packed=spec.packed)
    return custom_call(_decode_attention_packed_plain, q, k_codes, v_codes,
                       cache_len, k_scale, v_scale, spec,
                       reads=[q, k_codes, k_scale, v_codes, v_scale,
                              cache_len])


def _decode_attention_packed_plain(q, k_codes, v_codes, cache_len, k_scale,
                                   v_scale, spec):
    k = kv_kernels.decode_kv_rows(k_codes, k_scale[..., None], spec.fmt,
                                  spec.packed)
    v = kv_kernels.decode_kv_rows(v_codes, v_scale[..., None], spec.fmt,
                                  spec.packed)
    return decode_attention(q, k, v, cache_len)
