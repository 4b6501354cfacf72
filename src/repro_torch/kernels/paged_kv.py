"""Paged posit KV cache for serving decode: K5 and K6, CUDA kernels + plain
versions (port of ``repro.kernels.paged_kv``).

The per-slot rings of ``kernels/kv_cache.py`` are replaced by a shared
page pool plus per-sequence page tables; storage stays posit codes with a
per-row pow2 scale, decoded on read.

Layout (per attention layer; no batch axis — pages are shared):

  pool codes   (R, nkv, Dc)   R = num_pages * page_size flat rows;
                              page p owns rows [p*ps, (p+1)*ps)
  pool scales  (R, nkv) f32   per-(token x head) pow2 scale
  page_table   (B, Pmax) i32  logical page -> physical page per slot;
                              unallocated entries point at page 0, which
                              the allocator reserves as a trash page
  seq_lens     (B,) i32       valid tokens per slot (masks trash reads)

  write path  K5 ``paged_kv_append_rows`` — T tokens' K/V rows per slot,
      f32 or bf16 as the model made them, are scaled, RNE-encoded and
      written IN PLACE at the flat pool rows of the (B, T) ``dst`` matrix
      (``flat_dst_rows_chunk``); no other row moves.  ``paged_kv_append``
      is its T=1 case.
  read path   K6 ``paged_decode_attention`` — one-token GQA that walks
      each slot's page list in splits of ``SPLIT_ROWS`` rows across CTAs,
      decoding codes to f32 on-chip, then merges the splits' softmax
      partials (flash-decoding).

Idle slots point every logical page at trash page 0, so several rows of
one append may land on the same trash row, in no set order: trash rows
are never compared bit for bit.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version (``*_ref``) for CPU tensors.  The plain versions run on any
device; the plain K6 goes through ``models.attention.decode_attention``
so ring and paged CPU streams share one reduction.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..models.attention import decode_attention
from . import _build
from .kv_cache import (SPLIT_ROWS, code_channels, decode_kv_rows,
                       decode_kv_rows_device, encode_kv_rows, launch_append,
                       split_geometry)


def flat_dst_rows(page_table, pos, page_size: int):
    """(B,) flat pool row for writing the token at ``pos`` per slot: the
    T=1 case of ``flat_dst_rows_chunk``."""
    return flat_dst_rows_chunk(page_table, pos, 1, page_size)[:, 0]


def flat_dst_rows_chunk(page_table, pos, t: int, page_size: int):
    """(B, T) int32 flat pool rows for a T-token chunk starting at ``pos``
    (scalar or (B,)).  Row [b, i] addresses position pos[b] + i.  Logical
    page indices are clamped to [0, Pmax), so idle slots (all-trash
    tables) whose pos runs past Pmax * ps still write into page 0."""
    b, pmax = page_table.shape
    dev = page_table.device
    pos = torch.as_tensor(pos, device=dev).to(torch.int64).reshape(-1)
    pos = pos.expand(b)[:, None] + torch.arange(t, device=dev)[None, :]
    lpi = torch.clamp(pos // page_size, 0, pmax - 1)
    phys = torch.take_along_dim(page_table.to(torch.int64), lpi, dim=1)
    return (phys * page_size + pos % page_size).to(torch.int32)


# ---------------------------------------------------------------------------
# K5: encode-on-write append into table-addressed pool rows
# ---------------------------------------------------------------------------

def paged_kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale, k_new,
                             v_new, dst, fmt: PositFormat,
                             packed: bool = False):
    """Plain version of K5.  k/v_codes (R, nkv, Dc), k/v_scale (R, nkv) are
    updated IN PLACE at the flat rows ``dst`` (B, T) from k/v_new
    (B, T, nkv, hd); a ``dst`` row outside [0, R) is skipped, as the
    kernel skips it.  Returns the four buffers."""
    b, t = k_new.shape[:2]
    rows = torch.as_tensor(dst, device=k_codes.device).to(
        torch.int64).reshape(b * t)
    rows, keep = _rows_in_pool(rows, k_codes.shape[0])
    for codes, scale, new in ((k_codes, k_scale, k_new),
                              (v_codes, v_scale, v_new)):
        c, s = encode_kv_rows(new, fmt, packed)        # (B, T, nkv, Dc)
        codes[rows] = c.reshape((b * t,) + c.shape[2:])[keep].to(codes.dtype)
        scale[rows] = s[..., 0].reshape(b * t, -1)[keep]
    return k_codes, k_scale, v_codes, v_scale


def _rows_in_pool(rows, r: int):
    """``rows`` (N,) cut to the entries in [0, r), and the selector of
    those entries: ``slice(None)`` (no op) where all lie inside.  The rows
    are read on the host, outside any dispatch, so an op-counting trace
    (``launch/op_cost.py``) sees the same ops as before the cut existed; a
    meta tensor (a trace of shapes) has no rows to read and keeps all."""
    if rows.is_meta:
        return rows, slice(None)
    host = (rows if rows.device.type == "cpu" else rows.cpu()).numpy()
    inside = (host >= 0) & (host < r)
    if inside.all():
        return rows, slice(None)
    keep = torch.from_numpy(inside).to(rows.device)
    return rows[keep], keep


def paged_kv_append_ref(k_codes, k_scale, v_codes, v_scale, k_new, v_new,
                        dst, fmt: PositFormat, packed: bool = False):
    """Plain version of ``paged_kv_append`` (the T=1 case: dst (B,))."""
    dst = torch.as_tensor(dst).reshape(k_new.shape[0], 1)
    return paged_kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale,
                                    k_new, v_new, dst, fmt, packed)


def paged_kv_append_rows(k_codes, k_scale, v_codes, v_scale, k_new, v_new,
                         dst, fmt: PositFormat, *, packed: bool = False):
    """K5: encode-on-write append of a T-token chunk into the paged pool,
    in place (contract of ``paged_kv_append_rows_ref``: a ``dst`` row
    outside [0, R) is skipped, which lets a rank of the distributed decode
    pass -1 for rows another rank owns).  On the card k/v_new are read as
    they are, float32 or bfloat16 (bf16 -> f32 is exact, so the codes are
    those of the f32 rows), at any strides that keep each row contiguous and 16-byte
    aligned (``append_geometry`` has the limits): one launch, a group of
    (row bytes) / 16 lanes per (b, t, head) row."""
    if not k_codes.is_cuda:
        return paged_kv_append_rows_ref(k_codes, k_scale, v_codes, v_scale,
                                        k_new, v_new, dst, fmt, packed)
    name = "paged_kv_append_rows"
    _build.check_kv(name, fmt, packed, (k_codes, v_codes), (k_scale, v_scale))
    r, h, dc = k_codes.shape
    b, t, hd = k_new.shape[0], k_new.shape[1], k_new.shape[-1]
    if (k_new.shape != (b, t, h, hd) or v_new.shape != k_new.shape
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (r, h) or v_scale.shape != (r, h)
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError(f"{name}: inconsistent shapes")
    dst = torch.as_tensor(dst, device=k_codes.device).to(
        torch.int32).reshape(b, t).contiguous()
    launch_append(name, "paged_kv", (k_codes, k_scale, v_codes, v_scale),
                  k_new, v_new, dst, r, fmt)
    return k_codes, k_scale, v_codes, v_scale


def paged_kv_append(k_codes, k_scale, v_codes, v_scale, k_new, v_new, dst,
                    fmt: PositFormat, *, packed: bool = False):
    """The T=1 case of K5: k/v_new (B, 1, nkv, hd), dst (B,) flat rows
    (``flat_dst_rows``)."""
    dst = torch.as_tensor(dst).reshape(k_new.shape[0], 1)
    return paged_kv_append_rows(k_codes, k_scale, v_codes, v_scale, k_new,
                                v_new, dst, fmt, packed=packed)


# ---------------------------------------------------------------------------
# K6: page-walking fused decode-on-read one-token attention
# ---------------------------------------------------------------------------

def gather_pages(pool, page_table, page_size: int):
    """Slot-logical view of a flat pool: (R, ...) rows, (B, Pmax) table ->
    (B, Pmax * page_size, ...) in logical token order, trash rows included
    (callers mask by seq_lens).  Table entries are clipped to the pool."""
    num_pages = pool.shape[0] // page_size
    tbl = torch.clamp(page_table.to(torch.int64), 0, num_pages - 1)
    rows = (tbl[:, :, None] * page_size
            + torch.arange(page_size, device=pool.device)[None, None, :])
    b, npg = tbl.shape
    return pool[rows.reshape(b, npg * page_size)]


def gather_decode_pages(codes, scales, page_table, page_size: int,
                        fmt: PositFormat, packed: bool = False):
    """Gather a slot-logical view of a posit pool and decode it:
    (R, nkv, Dc) codes + (R, nkv) scales -> (B, Pmax*ps, nkv, hd) f32."""
    return decode_kv_rows(
        gather_pages(codes, page_table, page_size),
        gather_pages(scales, page_table, page_size)[..., None], fmt, packed)


def gather_decode_pages_device(codes, scales, page_table, page_size: int,
                               fmt: PositFormat, packed: bool = False):
    """``gather_decode_pages`` with the decode through K1
    (``decode_kv_rows_device``): the codes and scales are gathered through
    the table first, then decoded, so f32 is written once per row read."""
    return decode_kv_rows_device(
        gather_pages(codes, page_table, page_size),
        gather_pages(scales, page_table, page_size)[..., None], fmt, packed)


def paged_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                               page_table, seq_lens, fmt: PositFormat, *,
                               page_size: int, packed: bool = False):
    """Plain version of K6: gather the page list, decode, dense masked
    softmax through ``attention.decode_attention`` (the ring path's own
    reduction).  q (B, 1, nh, hd); returns (B, 1, nh, hd)."""
    k = gather_decode_pages(k_codes, k_scale, page_table, page_size, fmt,
                            packed)
    v = gather_decode_pages(v_codes, v_scale, page_table, page_size, fmt,
                            packed)
    return decode_attention(q, k, v, seq_lens)


def paged_decode_attention(q, k_codes, k_scale, v_codes, v_scale,
                           page_table, seq_lens, fmt: PositFormat, *,
                           page_size: int, packed: bool = False):
    """K6: fused one-token GQA attention over a paged posit pool (contract
    of ``paged_decode_attention_ref``; output in q's dtype, float32 or
    bfloat16 on the card).  q is scaled by hd^-0.5 in q's dtype, as in the
    reference kernel.  On the card the slot's rows up to ``seq_lens[b]``
    (all Pmax pages, every row masked and so weighed equally, where
    ``seq_lens[b] <= 0``) are walked in splits of ``SPLIT_ROWS`` rows, one
    CTA each, and a second kernel merges the splits; the q scaling and the
    output cast happen inside the kernels.  Table entries are clipped to
    [0, num_pages).  The limits are ``split_geometry``'s, shared with the
    ring's K4."""
    if not q.is_cuda:
        return paged_decode_attention_ref(
            q, k_codes, k_scale, v_codes, v_scale, page_table, seq_lens,
            fmt, page_size=page_size, packed=packed)
    name = "paged_decode_attention"
    _build.check_kv(name, fmt, packed, (k_codes, v_codes), (k_scale, v_scale))
    r, nkv, dc = k_codes.shape
    b, _, nh, hd = q.shape
    pmax = page_table.shape[-1]
    if (q.shape != (b, 1, nh, hd) or nh % nkv
            or v_codes.shape != k_codes.shape
            or k_scale.shape != (r, nkv) or v_scale.shape != (r, nkv)
            or page_table.shape != (b, pmax) or r % page_size
            or dc != code_channels(hd, fmt, packed)):
        raise ValueError(f"{name}: inconsistent shapes")
    grp = nh // nkv
    splits, _ = split_geometry(name, hd, dc * k_codes.element_size(), grp,
                               q.dtype, pmax * page_size)
    q = q.contiguous()
    tbl = page_table.to(torch.int32).contiguous()
    lens = torch.as_tensor(seq_lens, device=q.device).to(
        torch.int32).reshape(-1).expand(b).contiguous()
    part = torch.empty((b * nkv, splits, grp, hd + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((b, 1, nh, hd), dtype=q.dtype, device=q.device)
    _build.check_cuda(name, q, k_codes, k_scale, v_codes, v_scale, tbl,
                      lens, out, part)
    _build.launch("paged_kv", name, q.device,
                  q.data_ptr(), k_codes.data_ptr(), k_scale.data_ptr(),
                  v_codes.data_ptr(), v_scale.data_ptr(), tbl.data_ptr(),
                  lens.data_ptr(), out.data_ptr(), part.data_ptr(), b, nkv,
                  grp, hd, page_size, pmax, r // page_size, fmt.bits, fmt.es,
                  fmt.bias, int(q.dtype == torch.bfloat16), SPLIT_ROWS,
                  hd ** -0.5)
    return out
