"""Attention (port of ``repro.models.attention``, forward only): the
blockwise online-softmax prefill path, one-token decode against a float
cache, and decode against a posit-coded cache.

``blockwise_attention`` carries the reference's online-softmax loop as it
is (outer loop over query blocks, inner loop over KV blocks, (m, l, acc)
in f32), so CPU parity with the JAX package holds; it is plain tensor code,
not a kernel.
"""
from __future__ import annotations

import torch

from ..kernels import kv_cache as kv_kernels
from .common import _einsum

NEG_INF = -1e30


def _bias_block(qpos, kpos, causal: bool, skv):
    """(qb, kvb) additive mask for one (q_block, kv_block) tile."""
    b = torch.zeros((qpos.shape[0], kpos.shape[0]), dtype=torch.float32,
                    device=qpos.device)
    if causal:
        b = torch.where(qpos[:, None] >= kpos[None, :], b, NEG_INF)
    if skv is not None:
        b = torch.where(kpos[None, :] < skv, b, NEG_INF)
    return b


def _flash_fwd(q, k, v, causal, q_block, kv_block, skv):
    """q pre-scaled (B, Sp, nh, hd); k/v (B, Skp, nkv, hd); Sp/Skp padded.
    Returns out (B, Sp, nh, hd) in q's dtype."""
    b, sp, nh, hd = q.shape
    skp, nkv = k.shape[1], k.shape[2]
    grp = nh // nkv
    dev = q.device
    outs = []
    for q0 in range(0, sp, q_block):
        qblk = q[:, q0:q0 + q_block]                  # (B, qb, nh, hd)
        qpos = q0 + torch.arange(q_block, device=dev)
        m = torch.full((b, nh, q_block), NEG_INF, device=dev)
        l = torch.zeros((b, nh, q_block), device=dev)
        acc = torch.zeros((b, nh, q_block, hd), device=dev)
        for k0 in range(0, skp, kv_block):
            kblk = k[:, k0:k0 + kv_block].repeat_interleave(grp, dim=2)
            vblk = v[:, k0:k0 + kv_block].repeat_interleave(grp, dim=2)
            kpos = k0 + torch.arange(kv_block, device=dev)
            s_blk = torch.einsum("bqhd,bshd->bhqs", qblk, kblk).to(
                torch.float32)
            s_blk = s_blk + _bias_block(qpos, kpos, causal, skv)
            m_new = torch.maximum(m, s_blk.amax(dim=-1))
            p = torch.exp(s_blk - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(q.dtype), vblk).to(torch.float32)
            m = m_new
        outs.append(acc / l.clamp(min=1e-30)[..., None])
    out = torch.cat(outs, dim=2)                      # (B, nh, Sp, hd)
    return out.transpose(1, 2).to(q.dtype)


def blockwise_attention(q, k, v, *, causal=True, q_block=512, kv_block=1024):
    """Flash-style online-softmax attention (forward).

    q: (B, S, nh, hd); k/v: (B, S, nkv, hd).  GQA repeats the KV heads per
    block inside the loop, as the reference does."""
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
    out = _flash_fwd(qs, k, v, causal, q_block, kv_block, skv if pk else None)
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
    run ``decode_attention``, as the reference's CPU path does."""
    if q.is_cuda:
        return kv_kernels.decode_attention(
            q, k_codes, k_scale, v_codes, v_scale, cache_len, spec.fmt,
            packed=spec.packed)
    k = kv_kernels.decode_kv_rows(k_codes, k_scale[..., None], spec.fmt,
                                  spec.packed)
    v = kv_kernels.decode_kv_rows(v_codes, v_scale[..., None], spec.fmt,
                                  spec.packed)
    return decode_attention(q, k, v, cache_len)
