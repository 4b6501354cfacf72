"""Posit-packed KV cache for serving decode: K3 and K4, CUDA kernels +
plain versions (port of ``repro.kernels.kv_cache``).

The attention K/V rings hold posit codes with a per-row (token x head)
power-of-two scale:

  write path  K3 ``kv_append_rows`` — T tokens' K/V rows per slot are
      scaled, RNE-encoded (subnormals flushed) and written IN PLACE at
      ring rows (pos[b] + t) mod W; no other row moves.
  read path   K4 ``decode_attention`` — one-token GQA: codes are decoded
      to f32 on-chip inside the online-softmax loop; full-precision K/V
      never reach device memory.

P(4, 1) codes are nibble-packed two per byte along the head dim
(split-half: byte j holds elements j and j + hd/2).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``kv_append_rows_ref`` / ``decode_attention_ref``) for CPU
tensors.  The plain versions run on any device.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from . import _build
from .posit_decode import decode_tile
from .posit_encode import encode_tile

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Shared codec helpers (plain torch)
# ---------------------------------------------------------------------------

def row_pow2_scale(x):
    """Per-row power-of-two scale over the last axis: 2**floor(log2(mean|x|))
    by exponent-bit extraction (exact).  Shape ``x.shape[:-1] + (1,)``
    float32, >= 2^-100."""
    mean = x.to(torch.float32).abs().mean(dim=-1, keepdim=True)
    mean = torch.maximum(mean, torch.tensor(1e-30, device=mean.device))
    e = (mean.view(torch.int32) >> 23) & 0xFF
    return (e << 23).view(torch.float32)


def pack_nibbles(codes):
    """(..., D) 4-bit codes (uint8, < 16) -> (..., D//2) split-half packed:
    byte j = codes[j] | codes[j + D/2] << 4."""
    d = codes.shape[-1]
    return codes[..., : d // 2] | (codes[..., d // 2:] << 4)


def unpack_nibbles(packed):
    """(..., D//2) packed bytes -> (..., D) 4-bit codes."""
    return torch.cat([packed & 0xF, packed >> 4], dim=-1)


def encode_kv_rows(x, fmt: PositFormat, packed: bool = False):
    """Float rows (..., hd) -> (codes, scale (..., 1) f32)."""
    scale = row_pow2_scale(x)
    codes = encode_tile(x.to(torch.float32) / scale, fmt)
    if packed:
        codes = pack_nibbles(codes)
    return codes, scale


def decode_kv_rows(codes, scale, fmt: PositFormat, packed: bool = False,
                   out_dtype=torch.float32):
    """Inverse of ``encode_kv_rows``; scale broadcastable over the rows."""
    if packed:
        codes = unpack_nibbles(codes)
    return (decode_tile(codes, fmt) * scale).to(out_dtype)


def code_channels(hd: int, fmt: PositFormat, packed: bool = False) -> int:
    """Last-axis size of the code buffer for hd float channels."""
    if packed:
        if hd % 2:
            raise ValueError("nibble packing needs an even head dim")
        return hd // 2
    return hd


def _ring_rows(pos, b: int, t: int, w: int, device):
    """(B, T) ring rows (pos[b] + t) mod W; pos scalar or (B,)."""
    pos = torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1)
    return (pos.expand(b)[:, None]
            + torch.arange(t, device=device)[None, :]) % w


# ---------------------------------------------------------------------------
# K3: encode-on-write ring append of T rows per slot
# ---------------------------------------------------------------------------

def kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
                       fmt: PositFormat, packed: bool = False):
    """Plain version of K3.  k/v_codes (B, W, H, Dc), k/v_scale (B, W, H)
    are updated IN PLACE at ring rows (pos[b] + t) mod W from k/v_new
    (B, T, H, hd); ``pos`` scalar or (B,).  Returns the four buffers."""
    b, w = k_codes.shape[:2]
    idx = _ring_rows(pos, b, k_new.shape[1], w, k_codes.device)
    rows = torch.arange(b, device=k_codes.device)[:, None]
    for codes, scale, new in ((k_codes, k_scale, k_new),
                              (v_codes, v_scale, v_new)):
        c, s = encode_kv_rows(new, fmt, packed)
        codes[rows, idx] = c.to(codes.dtype)
        scale[rows, idx] = s[..., 0]
    return k_codes, k_scale, v_codes, v_scale


def kv_append_rows(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
                   fmt: PositFormat, *, packed: bool = False):
    """K3: encode-on-write ring append, in place (see ``kv_append_rows_ref``
    for the contract).  One warp per (b, t, head) row on the card."""
    if not k_codes.is_cuda:
        return kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale, k_new,
                                  v_new, pos, fmt, packed)
    _build.check_kv("kv_append_rows", fmt, packed, (k_codes, v_codes),
                    (k_scale, v_scale))
    b, w, h, dc = k_codes.shape
    t, hd = k_new.shape[1], k_new.shape[-1]
    if (k_new.shape != (b, t, h, hd) or v_new.shape != k_new.shape
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (b, w, h) or v_scale.shape != (b, w, h)
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError("kv_append_rows: inconsistent shapes")
    if hd > 256 or hd % 2:
        raise ValueError("kv_append_rows: head dim must be even and <= 256")
    k_new = k_new.to(torch.float32).contiguous()
    v_new = v_new.to(torch.float32).contiguous()
    pos = torch.as_tensor(pos, device=k_codes.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    _build.check_cuda("kv_append_rows", k_codes, k_scale, v_codes, v_scale,
                      k_new, v_new, pos)
    _build.launch("kv_cache", "kv_append_rows", k_codes.device,
                  k_new.data_ptr(), v_new.data_ptr(), k_codes.data_ptr(),
                  k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
                  pos.data_ptr(), b, t, h, hd, w, fmt.bits, fmt.es, fmt.bias)
    return k_codes, k_scale, v_codes, v_scale


# ---------------------------------------------------------------------------
# K4: fused decode-on-read one-token attention
# ---------------------------------------------------------------------------

def decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale, cache_len,
                         fmt: PositFormat, packed: bool = False):
    """Plain version of K4: decode the whole ring, dense masked softmax.
    q (B, 1, nh, hd); ``cache_len`` scalar or (B,).  Returns (B, 1, nh, hd)
    in q's dtype."""
    b, w, nkv, _ = k_codes.shape
    nh, hd = q.shape[2], q.shape[3]
    grp = nh // nkv
    k = decode_kv_rows(k_codes, k_scale[..., None], fmt, packed)
    v = decode_kv_rows(v_codes, v_scale[..., None], fmt, packed)
    qg = q.reshape(b, 1, nkv, grp, hd).to(torch.float32) * (hd ** -0.5)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    live = torch.arange(w, device=q.device)[None, :] < cl[:, None]
    s = torch.where(live[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v)
    return out.reshape(b, 1, nh, hd).to(q.dtype)


def decode_attention(q, k_codes, k_scale, v_codes, v_scale, cache_len,
                     fmt: PositFormat, *, packed: bool = False):
    """K4: fused one-token GQA attention over a posit ring (contract of
    ``decode_attention_ref``).  q is pre-scaled by hd^-0.5 in q's dtype, as
    in the reference kernel; one CTA per (slot, kv-head) row on the card,
    walking the ring only up to ``cache_len[b]`` (the whole ring, every row
    masked and so weighed equally, where ``cache_len[b] <= 0``)."""
    if not q.is_cuda:
        return decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                                    cache_len, fmt, packed)
    _build.check_kv("decode_attention", fmt, packed, (k_codes, v_codes),
                    (k_scale, v_scale))
    b, w, nkv, dc = k_codes.shape
    nh, hd = q.shape[2], q.shape[3]
    if (q.shape != (b, 1, nh, hd) or nh % nkv
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (b, w, nkv) or v_scale.shape != (b, w, nkv)
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError("decode_attention: inconsistent shapes")
    if hd > 256:
        raise ValueError("decode_attention: head dim must be <= 256")
    grp = nh // nkv
    qg = (q.reshape(b, nkv, grp, hd) * (hd ** -0.5)).to(
        torch.float32).contiguous()
    cl = torch.as_tensor(cache_len, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    out = torch.empty((b, nkv, grp, hd), dtype=torch.float32, device=q.device)
    _build.check_cuda("decode_attention", qg, k_codes, k_scale, v_codes,
                      v_scale, cl, out)
    _build.launch("kv_cache", "decode_attention", q.device,
                  qg.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
                  v_codes.data_ptr(), v_scale.data_ptr(), cl.data_ptr(),
                  out.data_ptr(), b, nkv, grp, hd, w, fmt.bits, fmt.es,
                  fmt.bias)
    return out.reshape(b, 1, nh, hd).to(q.dtype)
