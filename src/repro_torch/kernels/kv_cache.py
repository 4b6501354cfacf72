"""Posit-packed KV cache for serving decode: K3 and K4, CUDA kernels +
plain versions (port of ``repro.kernels.kv_cache``).

The attention K/V rings hold posit codes with a per-row (token x head)
power-of-two scale:

  write path  K3 ``kv_append_rows`` — T tokens' K/V rows per slot, f32
      or bf16 as the model made them, are scaled, RNE-encoded (subnormals
      flushed) and written IN PLACE at ring rows (pos[b] + t) mod W; no
      other row moves.  The paged K5 runs the same kernel with other
      destinations, and both take their geometry from
      ``append_geometry``.
  read path   K4 ``decode_attention`` — one-token GQA that walks each
      slot's ring rows in splits of ``SPLIT_ROWS`` rows across CTAs,
      decoding codes to f32 on-chip, then merges the splits' softmax
      partials (flash-decoding); full-precision K/V never reach device
      memory.  The paged K6 runs the same split walk through its page
      table, and both take their geometry from ``split_geometry``.

P(4, 1) codes are nibble-packed two per byte along the head dim
(split-half: byte j holds elements j and j + hd/2).

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``kv_append_rows_ref`` / ``decode_attention_ref``) for CPU
tensors.  The plain versions run on any device.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..launch.op_cost import custom_call
from . import _build
from .posit_decode import decode_tile, posit_decode
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
    mean = mean.clamp_min(1e-30)
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


def decode_kv_rows_device(codes, scale, fmt: PositFormat,
                          packed: bool = False):
    """``decode_kv_rows`` to f32 through K1: the codes (nibbles unpacked
    first) go through ``posit_decode`` and are then multiplied by the row
    scale (on CPU tensors K1's plain version, the same ops and bits as
    ``decode_kv_rows``).  The speculative verify reads the whole cache this
    way; ``decode_kv_rows`` stays plain, the oracle of
    ``decode_attention_ref``."""
    if packed:
        codes = unpack_nibbles(codes)
    return posit_decode(codes, fmt) * scale


def code_channels(hd: int, fmt: PositFormat, packed: bool = False) -> int:
    """Last-axis size of the code buffer for hd float channels."""
    if packed:
        if hd % 2:
            raise ValueError("nibble packing needs an even head dim")
        return hd // 2
    return hd


def written_rows(k_codes, k_scale, k_new):
    """What an append of k/v_new (B, T, H, hd) writes: the (B, T, H) rows
    of codes and of scales, K and V, as ``op_cost.custom_call`` extents."""
    n = k_new.shape[0] * k_new.shape[1] * k_new.shape[2]
    return [(k_codes.dtype, n * k_codes.shape[-1]), (k_scale.dtype, n)] * 2


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


def append_geometry(name: str, hd: int, x_dtype):
    """The contract and geometry of K3's and K5's lane groups, checked
    before any launch: a row of hd elements of ``x_dtype`` is read by (row
    bytes) / 16 lanes, at most 32, each with one 16-byte load (two at f32
    hd = 256).  Returns (lanes per row, loads per lane).  Raises
    ``TypeError`` unless the rows are float32 or bfloat16, ``ValueError``
    unless hd <= 256 and a row is 32 * 2^i bytes (f32: hd 8 to 256, bf16:
    16 to 256, powers of two)."""
    if x_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: K/V rows must be float32 or bfloat16")
    row_bytes = hd * (4 if x_dtype == torch.float32 else 2)
    if hd > 256 or row_bytes < 32 or row_bytes & (row_bytes - 1):
        raise ValueError(f"{name}: head dim must be <= 256 and give rows of "
                         f"32 * 2^i bytes in the input's dtype (got hd {hd},"
                         f" {row_bytes} B)")
    lanes = min(row_bytes // 16, 32)
    return lanes, row_bytes // 16 // lanes


def _row_strides(name: str, x):
    """Element strides of (B, T, H, hd) rows along b, t, head (0 along an
    axis of size 1); each row must be contiguous and start 16-byte
    aligned (the kernel's loads)."""
    strides = tuple(0 if n == 1 else st
                    for n, st in zip(x.shape[:3], x.stride()[:3]))
    align = 16 // x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(st % align for st in strides)):
        raise ValueError(f"{name}: K/V rows must be contiguous and 16-byte "
                         f"aligned")
    return strides


def launch_append(name: str, library: str, bufs, k_new, v_new, index,
                  extent: int, fmt: PositFormat):
    """The launch shared by K3 and K5 (``kv_rows.cuh`` ``launch_append``),
    after the caller has checked its buffers' shapes: ``bufs`` are
    (k_codes, k_scale, v_codes, v_scale), ``index`` the int32 destination
    (K3: pos (B,); K5: dst (B, T)) and ``extent`` W or R.  k/v_new (B, T,
    H, hd) go to the kernel as they are, float32 or bfloat16 at their own
    strides (``append_geometry``, ``_row_strides``)."""
    k_codes = bufs[0]
    if v_new.dtype != k_new.dtype:
        raise TypeError(f"{name}: k_new and v_new must share a dtype")
    b, t, h, hd = k_new.shape
    append_geometry(name, hd, k_new.dtype)
    strides = _row_strides(name, k_new) + _row_strides(name, v_new)
    _build.check_cuda(name, *bufs, index)
    for x in (k_new, v_new):
        if x.device != k_codes.device:
            raise ValueError(f"{name}: all tensors must be on "
                             f"{k_codes.device}, got {x.device}")
    _build.launch(library, name, k_codes.device,
                  k_new.data_ptr(), v_new.data_ptr(),
                  *(x.data_ptr() for x in bufs), index.data_ptr(), *strides,
                  b, t, h, hd, extent, fmt.bits, fmt.es, fmt.bias,
                  int(k_new.dtype == torch.bfloat16))


def kv_append_rows(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
                   fmt: PositFormat, *, packed: bool = False):
    """K3: encode-on-write ring append, in place (see ``kv_append_rows_ref``
    for the contract).  On the card k/v_new are read as they are, float32
    or bfloat16 (bf16 -> f32 is exact, so the codes are those of the f32
    rows), at any strides that keep each row contiguous and 16-byte
    aligned (``append_geometry`` has the limits): one launch of K5's lane
    groups, with ring rows (pos[b] + t) mod W as destinations."""
    if not k_codes.is_cuda:
        return custom_call(kv_append_rows_ref, k_codes, k_scale, v_codes,
                           v_scale, k_new, v_new, pos, fmt, packed,
                           reads=[k_new, v_new, pos],
                           writes=written_rows(k_codes, k_scale, k_new))
    name = "kv_append_rows"
    _build.check_kv(name, fmt, packed, (k_codes, v_codes), (k_scale, v_scale))
    b, w, h, dc = k_codes.shape
    t, hd = k_new.shape[1], k_new.shape[-1]
    if (k_new.shape != (b, t, h, hd) or v_new.shape != k_new.shape
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (b, w, h) or v_scale.shape != (b, w, h)
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError(f"{name}: inconsistent shapes")
    pos = torch.as_tensor(pos, device=k_codes.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    launch_append(name, "kv_cache", (k_codes, k_scale, v_codes, v_scale),
                  k_new, v_new, pos, w, fmt)
    return k_codes, k_scale, v_codes, v_scale


def kv_append(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
              fmt: PositFormat, *, packed: bool = False):
    """The T = 1 case of K3: k/v_new (B, 1, H, hd), ``pos`` scalar or (B,)
    (mod W applied here).  One kernel to maintain, the same codec by
    construction."""
    return kv_append_rows(k_codes, k_scale, v_codes, v_scale, k_new, v_new,
                          pos, fmt, packed=packed)


def kv_append_ref(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
                  fmt: PositFormat, packed: bool = False):
    """Plain version of ``kv_append`` (the T = 1 case of
    ``kv_append_rows_ref``)."""
    return kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale, k_new,
                              v_new, pos, fmt, packed)


# ---------------------------------------------------------------------------
# K4: fused decode-on-read one-token attention
# ---------------------------------------------------------------------------

# Logical rows per CTA of K4's and K6's split walk (a multiple of 64).
SPLIT_ROWS = 128


def split_geometry(name: str, hd: int, row_bytes: int, grp: int, q_dtype,
                   listed_rows: int):
    """The contract and geometry of the split walk (K4 and K6), checked
    before any launch.  ``row_bytes``: bytes of one row of codes (one
    token, one kv-head, ``hd`` channels); ``grp``: query heads per
    kv-head; ``listed_rows``: logical rows per slot (the ring's width, or
    Pmax * page size).
    Returns (S, lanes per row): the splits per (slot, kv-head), each of
    ``SPLIT_ROWS`` rows, and the lanes that share a row, each loading 16
    bytes of it (4 where the row is 4 or 8 bytes).  Raises ``ValueError``
    unless hd <= 256 and a row of codes is 4 * 2^i bytes, at most 512
    (hd = 64: 64, 128 and 32 B for posit8, posit16 and packed posit4), and
    unless 1 <= grp <= 128; ``TypeError`` unless q is float32 or
    bfloat16."""
    if (hd > 256 or row_bytes < 4 or row_bytes > 512
            or row_bytes & (row_bytes - 1)):
        raise ValueError(f"{name}: head dim must be <= 256 and give rows of "
                         f"codes of 4 * 2^i bytes, at most 512 (got hd {hd}, "
                         f"{row_bytes} B)")
    if not 1 <= grp <= 128:
        raise ValueError(f"{name}: 1 to 128 query heads per KV head "
                         f"(got {grp})")
    if q_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: q must be float32 or bfloat16")
    lanes = row_bytes // 16 if row_bytes >= 16 else row_bytes // 4
    return -(-listed_rows // SPLIT_ROWS), lanes


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
    ``decode_attention_ref``; output in q's dtype, float32 or bfloat16 on
    the card).  q is scaled by hd^-0.5 in q's dtype, as in the reference
    kernel.  On the card the slot's ring rows up to ``cache_len[b]`` (all
    W, every row masked and so weighed equally, where ``cache_len[b] <=
    0``) are walked in splits of ``SPLIT_ROWS`` rows, one CTA each, and a
    second kernel merges the splits; the q scaling and the output cast
    happen inside the kernels (``split_geometry`` has the limits)."""
    if not q.is_cuda:
        return custom_call(decode_attention_ref, q, k_codes, k_scale,
                           v_codes, v_scale, cache_len, fmt, packed,
                           reads=[q, k_codes, k_scale, v_codes, v_scale,
                                  cache_len])
    name = "decode_attention"
    _build.check_kv(name, fmt, packed, (k_codes, v_codes), (k_scale, v_scale))
    b, w, nkv, dc = k_codes.shape
    nh, hd = q.shape[2], q.shape[3]
    if (q.shape != (b, 1, nh, hd) or nh % nkv
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (b, w, nkv) or v_scale.shape != (b, w, nkv)
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError(f"{name}: inconsistent shapes")
    grp = nh // nkv
    splits, _ = split_geometry(name, hd, dc * k_codes.element_size(), grp,
                               q.dtype, w)
    q = q.contiguous()
    cl = torch.as_tensor(cache_len, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    part = torch.empty((b * nkv, splits, grp, hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, 1, nh, hd), dtype=q.dtype, device=q.device)
    _build.check_cuda(name, q, k_codes, k_scale, v_codes, v_scale, cl, out,
                      part)
    _build.launch("kv_cache", name, q.device,
                  q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
                  v_codes.data_ptr(), v_scale.data_ptr(), cl.data_ptr(),
                  out.data_ptr(), part.data_ptr(), b, nkv, grp, hd, w,
                  fmt.bits, fmt.es, fmt.bias, int(q.dtype == torch.bfloat16),
                  SPLIT_ROWS, hd ** -0.5)
    return out
