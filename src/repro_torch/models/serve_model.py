"""Serving path of the attention stack (dense and MoE FFNs), of the
Mamba-2 stack and of the hybrid (Griffin) stack: cache init, bucketed
prefill and single-token decode (port of ``repro.models.serve_model``,
ring and paged layouts).

Caches keep the reference's layout: ``{"pos", "blocks": ({...},)}`` where a
posit cache block holds ``k``/``v`` codes (P, B, W, nkv, Dc) and
``k_scale``/``v_scale`` f32 (P, B, W, nkv), and a float cache block holds
``k``/``v`` (P, B, W, nkv, hd).  ``pos`` is a scalar or a (B,) per-slot
vector.  Ring writes land at row pos mod W.

With ``policy.kv_layout == "paged"`` the per-slot rings become one flat
page pool per layer, (P, R, nkv, Dc|hd) with R = num_pages * page_size
rows and no batch axis, plus a top-level ``page_table`` (B, Pmax) int32
and a (B,) ``pos`` (``kernels/paged_kv.py`` has the layout).

An SSM stack (``cfg.family == "ssm"``) holds no K/V: its cache block is
``{"state": (P, B, nh, hd, ds) f32, "conv": (P, B, K-1, conv_ch)}`` in the
model's dtype, the recurrent state each step rewrites whole.  Its decode
step writes the new states into fresh buffers and rebinds them on the
dict (as ``pos``), so the tensors given are the pre-step state still;
its prefill runs at the prompt's exact length (``ssd_chunked``'s chunk
rule: S <= ``ssm_chunk`` or a multiple of it) and keeps the last K-1 rows
of the raw ``xBC`` stream and the final SSD state.

A hybrid stack (``cfg.family == "hybrid"``) lays its cache out as its
params: ``blocks`` holds one dict per pattern position stacked over the
periods, ``tail`` one unstacked dict per tail layer.  Its attention
rings are W = min(window, max_len) rows wide (``_attn_w``), so decode
memory stays O(window) at any context length: row pos mod W is written,
``min(pos + 1, W)`` rows are read.  A recurrent cache block is ``{"h":
(P, B, d) f32, "conv": (P, B, K-1, d)}`` in the model's dtype; its
decode step writes new tensors and rebinds ``blocks`` and ``tail``, as
the SSM step does, while the K/V rows are written in place.  Its prefill
runs at the prompt's exact length with the window mask and fills each
ring from ``max(S - W, 0)``.  The paged layout with a window is refused
(the reference's ``ValueError``).

A vlm stack (Qwen2-VL) is the attention stack with M-RoPE: a scalar
``pos`` becomes a (B, 1) position per slot.  Its prefill and decode step
take the stub frontend's patch embeddings (``batch["embeds"]``, (B, S, d);
``embeds=`` (B, 1, d)) in place of tokens.

An audio stack (Whisper) adds, per decoder layer, cross K/V over the
encoder's output: ``xk``/``xv`` (P, B, enc_seq, nkv, hd) in the model's
dtype (never posit codes), in ring and paged caches alike, and a
top-level ``memory`` (B, enc_seq, d).  Its prefill runs the encoder once
on ``batch["frames"]`` (B, enc_seq, d), keeps its output in ``memory`` and
each layer's cross K/V in ``xk``/``xv``; its decode step attends over them
with the plain ``attention.decode_attention`` at ``cache_len = enc_seq``,
as the reference does (it has no kernel there).  The reference's
failures are the port's refusals: a prefill without ``frames``, a
bucketed prefill, and packed (``QuantizedTensor``) encoder or cross
weights.

A plugged decode attention (``decode_step(..., attn_impl=)``, the
reference's hook) speaks one of three protocols by its attributes: a
``paged_kv`` plug takes the pool's codes, scales and the page table; a
``packed_kv`` plug the ring's codes and scales; any other plug decoded
rows (K1 on the card: ``decode_kv_rows_device`` /
``gather_decode_pages_device``; the plain decode on the CPU).  A plug
with a ``shard`` (``serve/distributed.py``) reads a rank-local cache
(``init_cache(..., kv_shard=)``): the rank's slice of every ring's rows
or of the pool's pages, along each leaf's "kv_seq" dim (``rank_split``),
with ``pos`` and the page table whole.  Its decode append maps each
slot's global row to the rank's own, or to -1 where another rank owns
it, and writes through K5 (``paged_kv_append_rows`` skips -1) on a flat
view, ring and paged alike; a float cache takes a masked scatter.  A
hybrid stack's local-attention rings (W = min(window, max_len) rows,
``blocks`` and ``tail`` alike) split the same way.  The recurrent state
splits on "model" (``rank_split``): a Mamba-2 layer's ``state`` by heads
and ``conv`` by channels, an RG-LRU layer's ``h`` and ``conv`` by width;
the step runs the rank's own heads or columns and all-gathers the conv's
output and y through the plug's shard (``serve/distributed.py``).  An
audio stack's ``xk`` / ``xv`` and ``memory`` stay whole on every rank
(the cross-attention reads them through the plain
``attention.decode_attention``, as the reference's does).

In place: ``prefill``, ``decode_step`` and ``verify_step`` (the T-token
chunk pass of speculative decoding) write K/V rows into the cache tensors
they are given (per-layer views of the stacked buffers) and return the
same dict with a new ``pos``; the reference returns new arrays.  On CUDA
tensors the posit writes are the K3 (ring) / K5 (paged) kernels, the
decode step's posit reads K4 / K6 and the verify's whole-cache read K1;
on CPU tensors their plain versions.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core.quant import QuantizedTensor, maybe_dequant
from ..core.transprecision import BF16, KVStorage, TCPolicy, kv_storage
from ..kernels import kv_cache as kv_kernels
from ..kernels import paged_kv as paged_kernels
from . import attention
from .common import _einsum, apply_rope, map_with_path, rank_split, rms_norm
from .lm import (ModelCfg, _mlp, _qkv, _qw, _rope_cs, cross_attend,
                 cross_kv, embed_rows, encode_audio, ffn, layer_block,
                 lm_head, rec_mix, seq_positions)
from .rglru import rglru_step
from .ssm import _split_streams, in_proj, init_mamba2_state, mamba2_layer


def _ffn(p, x, cfg: ModelCfg, policy):
    """The FFN after attention.  MoE routes every row of ``x`` together
    under ``cfg.capacity_factor``, as the reference's serving paths do: in
    decode that is every slot of the batch, live or idle, so a live slot's
    routing depends on what the others hold."""
    return ffn(p, rms_norm(x, p["ln2"]), cfg, policy)[0]


def check_layout(policy: TCPolicy) -> bool:
    """True for the paged KV layout, False for the ring; raises on any
    other."""
    if policy.kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {policy.kv_layout!r}; known: "
                         "ring|paged")
    return policy.kv_layout == "paged"


def _attn_w(cfg: ModelCfg, max_len: int) -> int:
    """Rows of an attention ring: the window where one is set, else
    max_len."""
    return min(cfg.window, max_len) if cfg.window else max_len


def init_cache(cfg: ModelCfg, batch: int, max_len: int, dtype=None,
               policy: TCPolicy = BF16, *, num_pages: Optional[int] = None,
               device="cuda", kv_shard=None) -> Dict[str, Any]:
    """Empty decode state for ``batch`` sequences up to ``max_len`` tokens.

    A posit ``kv_format`` stores codes (zeros) plus per-row f32 pow2 scales
    (ones); otherwise K/V are floats in the format's (or model's) dtype.
    Paged: ``num_pages=None`` reserves the full pool (1 trash page + batch
    * Pmax) with the identity table (slot i owns pages 1 + i*Pmax ..), so
    standalone prefill/decode needs no allocator; an explicit
    ``num_pages`` gives a zero (all-trash) table that the caller owns.
    An audio stack's attention blocks add cross K/V ``xk``/``xv`` (B,
    enc_seq, nkv, hd) in the model's dtype (per slot in either layout),
    and the cache a zero ``memory`` (B, enc_seq, d): in the model's dtype
    under a posit KV format, else in the KV format's (the reference's
    dtypes).  With a ``kv_shard`` (``serve.distributed.KVShard``) the
    cache is that rank's: every dim ``launch.mesh.cache_specs`` splits
    (``rank_split``: the "kv_seq" dims and the recurrent "model" dims)
    holds its 1/world slice (``check_kv_shard``'s refusals)."""
    if kv_shard is not None:
        device = resolve_device(device)
        full = init_cache(cfg, batch, max_len, dtype, policy,
                          num_pages=num_pages, device="meta")
        check_kv_shard(full, cfg, policy, kv_shard)
        top = _cache((), batch, max_len, policy, "page_table" in full,
                     num_pages, device)
        return _rank_local(full, lambda name, t, dim: (
            torch.full([n // kv_shard.world if d == dim else n
                        for d, n in enumerate(t.shape)],
                       1.0 if name.endswith("_scale") else 0,
                       dtype=t.dtype, device=device)),
            other=lambda path, t: top[path] if path in top else torch.zeros(
                t.shape, dtype=t.dtype, device=device))
    paged = check_layout(policy)
    if paged and cfg.window:
        raise ValueError("paged KV layout does not support sliding-window "
                         "attention; use kv_layout='ring'")
    device = resolve_device(device)
    spec = kv_storage(policy)
    hd, nkv, P = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    if cfg.family == "ssm":
        conv, state = init_mamba2_state(cfg, (P, batch), cfg.dtype, device)
        return _cache(({"state": state, "conv": conv},), batch, max_len,
                      policy, paged, num_pages, device)
    if paged:
        ps = policy.kv_page_size
        pmax = -(-max_len // ps)            # logical pages per slot
        pool = (1 + batch * pmax            # page 0 is the trash page
                if num_pages is None else num_pages)
        rows = (pool * ps, nkv)
    else:
        rows = (batch, _attn_w(cfg, max_len), nkv)

    def block(btype, lead):
        if btype == "rec":
            return {"h": torch.zeros(lead + (batch, cfg.d_model),
                                     dtype=torch.float32, device=device),
                    "conv": torch.zeros(lead + (batch, cfg.conv_kernel - 1,
                                                cfg.d_model),
                                        dtype=cfg.dtype, device=device)}
        r = lead + rows
        if spec is not None and spec.is_posit:
            dc = kv_kernels.code_channels(hd, spec.fmt, spec.packed)
            code = dict(dtype=spec.fmt.storage_dtype, device=device)
            return {"k": torch.zeros(r + (dc,), **code),
                    "v": torch.zeros(r + (dc,), **code),
                    "k_scale": torch.ones(r, device=device),
                    "v_scale": torch.ones(r, device=device)}
        dt = dtype or (spec.dtype if spec is not None else cfg.dtype)
        return {"k": torch.zeros(r + (hd,), dtype=dt, device=device),
                "v": torch.zeros(r + (hd,), dtype=dt, device=device)}

    def attn_block(btype, lead):
        blk = block(btype, lead)
        if cfg.family == "audio":
            x_shape = lead + (batch, cfg.enc_seq, nkv, hd)
            blk["xk"] = torch.zeros(x_shape, dtype=cfg.dtype, device=device)
            blk["xv"] = torch.zeros(x_shape, dtype=cfg.dtype, device=device)
        return blk

    cache = _cache(tuple(attn_block(t, (cfg.n_periods,))
                         for t in cfg.period),
                   batch, max_len, policy, paged, num_pages, device)
    if cfg.n_tail:
        cache["tail"] = tuple(block(t, ()) for t in cfg.tail_types)
    if cfg.family == "audio":
        mem_dt = dtype or (spec.dtype if spec is not None
                           and not spec.is_posit else cfg.dtype)
        cache["memory"] = torch.zeros((batch, cfg.enc_seq, cfg.d_model),
                                      dtype=mem_dt, device=device)
    return cache


def _cache(blocks, batch: int, max_len: int, policy: TCPolicy, paged: bool,
           num_pages: Optional[int], device) -> Dict[str, Any]:
    """The cache dict around the stacked blocks: ``pos`` and, paged, the
    page table (the identity table of a full pool where ``num_pages`` is
    None, else all-trash)."""
    cache = {"pos": torch.zeros((batch,) if paged else (), dtype=torch.int32,
                                device=device),
             "blocks": blocks}
    if paged:
        pmax = -(-max_len // policy.kv_page_size)
        table = (1 + torch.arange(batch * pmax, device=device).reshape(
            batch, pmax) if num_pages is None
            else torch.zeros((batch, pmax), device=device))
        cache["page_table"] = table.to(torch.int32)
    return cache


def check_kv_shard(cache, cfg: ModelCfg, policy: TCPolicy, shard) -> None:
    """The refusals of a rank-local copy of ``cache`` (whole, or on the
    meta device): an extent of a split dim (``rank_split``) that the world
    size does not divide raises ``ValueError`` naming it: a ring width (a
    local attention ring's W = min(window, max_len) too) or page count
    first, then the SSD heads, conv channels or RG-LRU channels."""
    paged = "page_table" in cache
    splits = []

    def note(path, t):
        split = rank_split(path, paged)
        if split is not None:
            n = t.shape[split[0]]
            if split[2] == "pool pages":
                n //= policy.kv_page_size
            splits.append((split[1] != "kv_seq", n, split[2]))

    map_with_path(note, cache)
    for _, n, what in sorted(splits, key=lambda e: e[0]):
        shard.local_range(n, what)


def _rank_local(cache, leaf_fn, other=None):
    """``cache`` with each leaf that a rank splits (``rank_split``)
    replaced by ``leaf_fn(name, leaf, dim)``, the rank's share of it; every
    other leaf (``pos``, the page table, cross K/V and ``memory``: whole
    on every rank) kept, or ``other(path, leaf)``."""
    paged = "page_table" in cache

    def leaf(path, t):
        split = rank_split(path, paged)
        if split is not None:
            return leaf_fn(path.split("/")[-1], t, split[0])
        return t if other is None else other(path, t)

    return map_with_path(leaf, cache)


def shard_cache(cache, cfg: ModelCfg, policy: TCPolicy, shard):
    """Rank ``shard.rank``'s copy of a whole cache (a prefill's, say): each
    split dim (``rank_split``) cut to the rank's range, ``pos`` and the
    page table shared."""
    check_kv_shard(cache, cfg, policy, shard)

    def cut(name, t, dim):
        lo, hi = shard.local_range(t.shape[dim])
        return t.narrow(dim, lo, hi - lo).contiguous()

    return _rank_local(cache, cut)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _ring_write(buf, val, pos):
    """buf: (B, W, ...); val: (B, 1, ...); write at pos mod W, in place.
    ``pos`` scalar (shared) or (B,) per-slot."""
    b, w = buf.shape[:2]
    buf[torch.arange(b, device=buf.device), pos.long().expand(b) % w] = \
        val[:, 0].to(buf.dtype)


def _local_rows(rows, lo: int, n: int):
    """Global flat rows (B,) -> this rank's own rows [lo, lo + n) as local
    indices, -1 where another rank owns the row."""
    loc = rows.to(torch.int64) - lo
    return torch.where((loc >= 0) & (loc < n), loc, -1)


def _append_local(c, kp, vp, rows, spec: Optional[KVStorage]):
    """A rank's decode append: the step's K/V rows (B, 1, nkv, hd) at the
    rank's flat rows ``rows`` (B,) of the layer's cache viewed flat (ring
    (B, Wl, ...) as (B * Wl, ...)), skipping -1.  Posit: K5, whose
    destinations skip rows outside [0, R) on the card and in the plain
    version; float: a scatter with no host sync, in which a slot whose row
    another rank owns writes the first owned slot's row and value again
    (or, where no slot owns one, row 0's own value): duplicate writes of
    one value."""
    k, v = (c[n].view((-1,) + c[n].shape[-2:]) for n in ("k", "v"))
    if spec is not None and spec.is_posit:
        ks, vs = (c[n].view(-1, c[n].shape[-1])
                  for n in ("k_scale", "v_scale"))
        paged_kernels.paged_kv_append_rows(
            k, ks, v, vs, kp, vp, rows[:, None], spec.fmt,
            packed=spec.packed)
        return
    keep = rows >= 0
    first = torch.argmax(keep.to(torch.int32)).reshape(1)
    some = keep.any()
    dst = torch.where(keep, rows,
                      torch.where(some, rows.index_select(0, first), 0))
    for buf, new in ((k, kp), (v, vp)):
        new = new[:, 0].to(buf.dtype)
        other = torch.where(some, new.index_select(0, first), buf[0])
        buf[dst] = torch.where(keep[:, None, None], new, other)


def _attn_decode_paged(c, qp, kp, vp, paged, spec: Optional[KVStorage],
                       attn_impl=None):
    """Paged-pool K/V append + page-walking attention for one layer.
    ``paged`` is (dst (B,) flat rows, seq_lens (B,), page table (B, Pmax),
    page size), shared by every layer of the step.  A plug with a ``shard``
    holds its rank's pages only: the append keeps the rows it owns."""
    dst, seq_lens, table, ps = paged
    posit_kv = spec is not None and spec.is_posit
    shard = getattr(attn_impl, "shard", None)
    if shard is not None:
        rl = c["k"].shape[0]
        _append_local(c, kp, vp, _local_rows(dst, shard.rank * rl, rl), spec)
    elif posit_kv:
        paged_kernels.paged_kv_append(   # K5 reads the model's dtype
            c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, dst,
            spec.fmt, packed=spec.packed)
    else:
        # float formats: plain scatter + gather, as the reference (no kernel)
        rows = dst.long()
        c["k"][rows] = kp[:, 0].to(c["k"].dtype)
        c["v"][rows] = vp[:, 0].to(c["v"].dtype)
    if getattr(attn_impl, "paged_kv", False):
        # paged protocol: the pool (codes + scales, or float rows) and the
        # page table cross the plug's boundary
        return attn_impl(qp, c["k"], c["v"], seq_lens,
                         k_scale=c.get("k_scale"), v_scale=c.get("v_scale"),
                         kv_spec=spec, page_table=table, page_size=ps)
    if attn_impl is None and posit_kv:
        return paged_kernels.paged_decode_attention(
            qp, c["k"], c["k_scale"], c["v"], c["v_scale"], table, seq_lens,
            spec.fmt, page_size=ps, packed=spec.packed)
    if posit_kv:                # a plain plug reads decoded rows (K1)
        k_read, v_read = (paged_kernels.gather_decode_pages_device(
            c[n], c[n + "_scale"], table, ps, spec.fmt, spec.packed)
            for n in ("k", "v"))
    else:
        k_read = paged_kernels.gather_pages(c["k"], table, ps)
        v_read = paged_kernels.gather_pages(c["v"], table, ps)
    return (attn_impl or attention.decode_attention)(qp, k_read, v_read,
                                                     seq_lens)


def _attn_decode_ring(c, qp, kp, vp, pos, spec: Optional[KVStorage],
                      attn_impl=None):
    """Ring K/V append at row pos mod W + attention over min(pos + 1, W)
    rows for one layer.  A plug with a ``shard`` holds its rank's rows
    [r * W/n, (r + 1) * W/n) of every slot's ring: the append keeps the
    rows it owns (K5 on the ring viewed flat)."""
    posit_kv = spec is not None and spec.is_posit
    shard = getattr(attn_impl, "shard", None)
    b, w = qp.shape[0], c["k"].shape[1]
    if shard is not None:
        wl, w = w, w * shard.world
        r = pos.to(torch.int64).expand(b) % w
        own = _local_rows(r, shard.rank * wl, wl)
        slots = torch.arange(b, device=r.device) * wl
        _append_local(c, kp, vp, torch.where(own >= 0, slots + own, -1),
                      spec)
    elif posit_kv:
        kv_kernels.kv_append_rows(     # K3 reads the model's dtype
            c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, pos,
            spec.fmt, packed=spec.packed)
    else:
        _ring_write(c["k"], kp, pos)
        _ring_write(c["v"], vp, pos)
    cl = torch.clamp(pos + 1, max=w)
    if posit_kv and getattr(attn_impl, "packed_kv", False):
        # packed protocol: codes + scales cross the plug's boundary
        return attn_impl(qp, c["k"], c["v"], cl, k_scale=c["k_scale"],
                         v_scale=c["v_scale"], kv_spec=spec)
    if attn_impl is None and posit_kv:
        return attention.decode_attention_packed(
            qp, c["k"], c["v"], cl, k_scale=c["k_scale"],
            v_scale=c["v_scale"], spec=spec)
    if posit_kv:                # a plain plug reads decoded rows (K1)
        k_read, v_read = (kv_kernels.decode_kv_rows_device(
            c[n], c[n + "_scale"][..., None], spec.fmt, spec.packed)
            for n in ("k", "v"))
    else:
        k_read, v_read = c["k"], c["v"]
    return (attn_impl or attention.decode_attention)(qp, k_read, v_read, cl)


def _attn_decode(p, c, x, cfg: ModelCfg, policy, pos,
                 spec: Optional[KVStorage], paged=None, attn_impl=None):
    b = x.shape[0]
    h = rms_norm(x, p["ln"])
    qp, kp, vp = _qkv(p, h, cfg, policy)
    if pos.ndim:
        posv = pos[:, None]
    else:           # M-RoPE takes a (B, 1) position, 1-D RoPE a (1,) one
        posv = pos.expand(b)[:, None] if cfg.mrope else pos[None]
    cos, sin = _rope_cs(cfg, posv)
    qp = apply_rope(qp, cos, sin)
    kp = apply_rope(kp, cos, sin)
    if paged is not None:
        ao = _attn_decode_paged(c, qp, kp, vp, paged, spec, attn_impl)
    else:
        ao = _attn_decode_ring(c, qp, kp, vp, pos, spec, attn_impl)
    # attention may run at higher precision than the stream (f32-decoded
    # K/V); the residual stream keeps the model dtype
    x = x + _einsum("bsk,kd->bsd", ao.reshape(b, 1, -1),
                    _qw(policy, "attn_weights")(p["wo"])).to(x.dtype)
    if "xk" in c:       # audio: cross-attention over the encoder's K/V
        qx = _einsum("bsd,dk->bsk", rms_norm(x, p["ln_x"]),
                     maybe_dequant(p["wq_x"])).reshape(
            b, 1, cfg.n_heads, cfg.head_dim)
        xo = attention.decode_attention(qx, c["xk"], c["xv"],
                                        c["xk"].shape[1])
        x = x + _einsum("bsk,kd->bsd", xo.reshape(b, 1, -1),
                        maybe_dequant(p["wo_x"]))
    return x + _ffn(p, x, cfg, policy)


def _rec_decode(p, c, x, cfg: ModelCfg, policy, out, shard=None):
    """One recurrent layer's step: separate ``wy`` / ``wx`` products (the
    reference's decode does not fuse them), the K-tap conv over the
    layer's ``c["conv"]`` rows and the new one, the RG-LRU update from
    ``c["h"]``, ``w_out`` and the MLP.  The new state lands in ``out`` (a
    dict of buffers that do not alias ``c``); ``c`` is only read.  With a
    ``shard`` (``serve.distributed.KVShard``) ``c`` holds the rank's
    width columns: the conv runs over them and its output is all-gathered,
    the update runs the rank's columns of ``w_a`` / ``w_x`` and its y is
    all-gathered; the products around them run whole."""
    h = rms_norm(x, p["ln"])
    gate = torch.nn.functional.gelu(
        _einsum("bsd,dk->bsk", h, maybe_dequant(p["wy"])),
        approximate="tanh")
    u = _einsum("bsd,dk->bsk", h, maybe_dequant(p["wx"]))
    cols = (slice(None) if shard is None
            else shard.own(u.shape[-1], "RG-LRU channels"))
    window = torch.cat([c["conv"], u[..., cols].to(c["conv"].dtype)], dim=1)
    u = sum(window[:, i:i + 1] * p["conv_w"][i, cols]
            for i in range(cfg.conv_kernel))
    if shard is not None:
        u = shard.all_gather(u)
    y, h_new = rglru_step(p["rglru"], u, c["h"], cols)
    if shard is not None:
        y = shard.all_gather(y)
    out["h"].copy_(h_new)
    out["conv"].copy_(window[:, 1:])
    x = x + _einsum("bsk,kd->bsd", y * gate, maybe_dequant(p["w_out"]))
    return x + _mlp(p, rms_norm(x, p["ln2"]), cfg, policy)


def fresh_rec_state(cache, cfg: ModelCfg, like=torch.empty_like):
    """The cache's ``blocks`` and ``tail`` with every recurrent block's
    leaves (an SSM stack's whole block, a hybrid stack's ``rec`` blocks)
    replaced by new tensors of their shapes, made by ``like``; attention
    blocks stay the same dicts (their K/V rows are written in place).
    None for a stack without recurrent layers.  ``decode_step`` writes a
    step's new recurrent state into such a set (``rec_out``)."""
    if cfg.family == "ssm":
        return {"blocks": tuple({k: like(v) for k, v in blk.items()}
                                for blk in cache["blocks"])}
    if "rec" not in cfg.block_types:
        return None

    def fresh(btype, blk):
        return {k: like(v) for k, v in blk.items()} if btype == "rec" \
            else blk

    new = {"blocks": tuple(fresh(t, b) for t, b in zip(cfg.period,
                                                       cache["blocks"]))}
    if cfg.n_tail:
        new["tail"] = tuple(fresh(t, b) for t, b in zip(cfg.tail_types,
                                                        cache["tail"]))
    return new


def _ssm_decode(p, c, x, cfg: ModelCfg, policy, out, shard=None):
    """One Mamba-2 layer's step: reads the layer's ``c["conv"]`` /
    ``c["state"]`` (the rank's channels and heads under a ``shard``) and
    writes the new ones into ``out`` (a (conv, state) pair of buffers)."""
    h = rms_norm(x, p["ln"])
    y, _ = mamba2_layer(p, h, cfg, conv_state=c["conv"],
                        ssm_state=c["state"],
                        quantize_w=_qw(policy, "mlp_weights"), out=out,
                        shard=shard)
    return x + y


def decode_step(params, cache, tokens, cfg: ModelCfg,
                policy: TCPolicy = BF16, embeds=None, attn_impl=None, *,
                rec_out=None):
    """One serving step. tokens: (B, 1) int, or ``embeds`` (B, 1, d) in
    their place (a vlm stack's patch embeddings).  Returns (logits (B,
    vocab_pad), cache) with K/V rows written in place and ``pos`` + 1.
    Paged caches (``cache["page_table"]``) take per-slot positions; a
    scalar ``pos`` is broadcast to every slot.  An SSM stack's new states
    land in new buffers, rebound on the dict as ``cache["blocks"]``; so do
    a hybrid stack's recurrent states (``blocks`` and ``tail``).  With
    ``rec_out`` (a set of ``fresh_rec_state``'s shape that does not alias
    the cache's) they land in its buffers instead: the engine's donated
    step alternates between two fixed sets.  ``attn_impl`` plugs a decode
    attention into every attention layer (the module docstring has its
    protocols); None keeps the built-in one.  A plug's ``shard`` also
    splits the recurrent layers' state."""
    check_layout(policy)
    spec = kv_storage(policy)
    pos = cache["pos"]
    shard = getattr(attn_impl, "shard", None)
    x = (embeds.to(cfg.dtype) if embeds is not None else
         embed_rows(params["embed"], tokens, policy).to(cfg.dtype))
    new = fresh_rec_state(cache, cfg) if rec_out is None else rec_out
    if cfg.family == "ssm":
        out = new["blocks"][0]
        for i in range(cfg.n_layers):
            x = _ssm_decode(layer_block(params, cfg, i)[1],
                            layer_block(cache, cfg, i)[1], x, cfg, policy,
                            (out["conv"][i], out["state"][i]), shard)
        cache.update(new)
        return _readout(params, cache, x, cfg, pos)
    table, paged, pos_l = cache.get("page_table"), None, pos
    if table is not None:
        pos_l = pos.expand(x.shape[0]) if pos.ndim == 0 else pos
        ps = policy.kv_page_size
        paged = (paged_kernels.flat_dst_rows(table, pos_l, ps), pos_l + 1,
                 table, ps)
    for i in range(cfg.n_layers):
        btype, p = layer_block(params, cfg, i)
        c = layer_block(cache, cfg, i)[1]     # views of the stacked rows
        if btype == "rec":
            x = _rec_decode(p, c, x, cfg, policy,
                            layer_block(new, cfg, i)[1], shard)
        else:
            x = _attn_decode(p, c, x, cfg, policy, pos_l, spec, paged,
                             attn_impl)
    if new is not None:
        cache.update(new)
    return _readout(params, cache, x, cfg, pos)


def _readout(params, cache, x, cfg: ModelCfg, pos):
    """The decode step's head: final norm, logits (B, vocab_pad), pos + 1."""
    x = rms_norm(x, params["final_norm"])
    logits = _einsum("bsd,dv->bsv", x, lm_head(params, cfg))[:, 0]
    cache["pos"] = pos + 1
    return logits, cache


# ---------------------------------------------------------------------------
# verify_step: multi-token chunk decode (speculative verify)
# ---------------------------------------------------------------------------

def _ring_write_rows(buf, val, pos):
    """buf: (B, W, ...); val: (B, T, ...); row t of slot b lands at
    (pos[b] + t) mod W, in place."""
    b, w = buf.shape[:2]
    idx = (pos.long()[:, None]
           + torch.arange(val.shape[1], device=buf.device)[None, :]) % w
    buf[torch.arange(b, device=buf.device)[:, None], idx] = val.to(buf.dtype)


def _attn_verify(p, c, x, cfg: ModelCfg, policy, pos,
                 spec: Optional[KVStorage], paged=None):
    """One attention layer of the T-token verify pass: append the chunk's
    T K/V rows (positions pos..pos+T-1 per slot) in place, then causal
    chunk attention against the whole cache.  Posit caches are written
    by K3 / K5 at T rows and read by decoding every row through K1
    (``decode_kv_rows_device`` / ``gather_decode_pages_device``); on CPU
    tensors the plain versions, which give the logits and rows of T
    sequential ``decode_step`` calls.  On the card, decode reads through
    K4 / K6 instead: another summation order.  ``paged`` is (dst (B, T)
    flat rows, page table, page size), shared by every layer."""
    b, t = x.shape[:2]
    posit_kv = spec is not None and spec.is_posit
    h = rms_norm(x, p["ln"])
    qp, kp, vp = _qkv(p, h, cfg, policy)
    posv = pos[:, None] + torch.arange(t, dtype=pos.dtype,
                                       device=pos.device)[None, :]
    cos, sin = _rope_cs(cfg, posv)
    qp = apply_rope(qp, cos, sin)
    kp = apply_rope(kp, cos, sin)
    if paged is not None:
        dst, table, ps = paged
        if posit_kv:
            paged_kernels.paged_kv_append_rows(   # K5 at T rows
                c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, dst,
                spec.fmt, packed=spec.packed)
            k_read, v_read = (paged_kernels.gather_decode_pages_device(
                c[n], c[n + "_scale"], table, ps, spec.fmt, spec.packed)
                for n in ("k", "v"))
        else:
            rows = dst.long().reshape(-1)
            c["k"][rows] = kp.reshape((b * t,) + kp.shape[2:]).to(
                c["k"].dtype)
            c["v"][rows] = vp.reshape((b * t,) + vp.shape[2:]).to(
                c["v"].dtype)
            k_read = paged_kernels.gather_pages(c["k"], table, ps)
            v_read = paged_kernels.gather_pages(c["v"], table, ps)
    elif posit_kv:
        kv_kernels.kv_append_rows(                # K3 at T rows
            c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, pos,
            spec.fmt, packed=spec.packed)
        k_read, v_read = (kv_kernels.decode_kv_rows_device(
            c[n], c[n + "_scale"][..., None], spec.fmt, spec.packed)
            for n in ("k", "v"))
    else:
        _ring_write_rows(c["k"], kp, pos)
        _ring_write_rows(c["v"], vp, pos)
        k_read, v_read = c["k"], c["v"]
    ao = attention.chunk_decode_attention(qp, k_read, v_read, posv)
    x = x + _einsum("bsk,kd->bsd", ao.reshape(b, t, -1),
                    _qw(policy, "attn_weights")(p["wo"])).to(x.dtype)
    return x + _ffn(p, x, cfg, policy)


def check_verifiable(cfg) -> None:
    """The reference's refusals: a verify chunk needs every token to write
    exactly one cache row that rollback can rewind (attention-only, no
    MoE capacity routing, no cross-attention, no sliding window)."""
    blocks = set(getattr(cfg, "block_types", ("attn",)))
    if blocks != {"attn"}:
        raise ValueError("verify_step supports attention-only stacks; "
                         f"{cfg.name} has blocks {blocks}")
    if cfg.family == "moe":
        raise ValueError("verify_step does not support MoE stacks (chunked "
                         "dispatch changes capacity routing vs per-token)")
    if cfg.family == "audio":
        raise ValueError("verify_step does not support encoder-decoder "
                         "stacks (no cross-attention in the chunk path)")
    if getattr(cfg, "window", None):
        raise ValueError("verify_step does not support sliding-window "
                         "attention (rollback assumes no ring wraparound)")


def verify_step(params, cache, tokens, cfg: ModelCfg,
                policy: TCPolicy = BF16, *, pos_out=None):
    """Multi-token verify pass of self-speculative decoding: score a (B, T)
    token chunk in one model call.  Token t of slot b is scored and its
    K/V row written, in place, at position ``pos[b] + t``.  Returns
    (logits (B, T, vocab_pad), cache) with ``pos`` + T; the caller commits
    the accepted tokens and rolls the cache back past the first rejection
    (``serve/speculative.py``).  With ``pos_out`` ((B,) int32, the donating
    engine's fixed ``pos``) pos + T is written into it and bound as the
    cache's ``pos``."""
    check_verifiable(cfg)
    check_layout(policy)
    spec = kv_storage(policy)
    b, t = tokens.shape
    pos = cache["pos"]
    pos_l = (pos.expand(b) if pos.ndim == 0 else pos).to(torch.int32)
    x = embed_rows(params["embed"], tokens, policy).to(cfg.dtype)
    table, paged = cache.get("page_table"), None
    if table is not None:
        ps = policy.kv_page_size
        paged = (paged_kernels.flat_dst_rows_chunk(table, pos_l, t, ps),
                 table, ps)
    for i in range(cfg.n_layers):
        x = _attn_verify(layer_block(params, cfg, i)[1],
                         layer_block(cache, cfg, i)[1], x, cfg, policy, pos_l,
                         spec, paged)
    x = rms_norm(x, params["final_norm"])
    logits = _einsum("bsd,dv->bsv", x, lm_head(params, cfg))
    cache["pos"] = pos + t if pos_out is None else pos_out.copy_(pos + t)
    return logits, cache


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def prefill(params, batch, cfg: ModelCfg, max_len: int,
            policy: TCPolicy = BF16, true_len=None):
    """Run the prompt through the model, returning (last_logits, cache).

    ``true_len`` (scalar or (B,)) enables right-padded bucketed prefill:
    ``batch["tokens"]`` is padded to a shared width S and only the first
    ``true_len[b]`` tokens of each row are real.  Padding rows are causally
    masked out of every real row, logits come from position
    ``true_len - 1`` and ``cache["pos"]`` is the per-slot ``true_len``
    vector.  Bucketed prefill needs a stack whose rows do not see each
    other outside attention: MoE routing does, and is refused
    (``ValueError``, as the reference).  Ring: padding K/V rows hold
    cache-init values (codes 0,
    scale 1).  Paged (full pool, identity table; S <= max_len): prompt row
    t of slot b lands at ``page_table[b, t//ps]*ps + t%ps`` and padding
    rows land on trash row 0.

    Posit caches are written by the K3 path (``kv_append_rows`` from
    position ``max(S - W, 0)``) into the fresh ring, then the padding rows
    are reset: the same bits as the reference's bulk encode.  Paged posit
    pools are written by the K5 path at T = S with those flat rows.

    A hybrid stack prefills at the prompt's exact length: its attention
    layers are local (``cfg.window``) and fill W = min(window, max_len)
    ring rows from ``max(S - W, 0)``; each recurrent layer keeps the
    scan's last state and the last K-1 rows of its raw ``h @ wx`` stream.
    Packed (``QuantizedTensor``) recurrent weights raise ``TypeError``:
    the reference's prefill reads ``wx`` raw and fails on them.

    A vlm batch may carry ``embeds`` (B, S, d) in place of ``tokens``
    (exact length: no ``true_len``).  An audio batch carries ``tokens``
    (the decoder prompt) and ``frames`` (B, enc_seq, d): the encoder runs
    once, its output lands in ``cache["memory"]`` and each layer's cross
    K/V in ``xk``/``xv``."""
    paged = check_layout(policy)
    if cfg.family == "audio":
        _check_audio_prefill(params, batch)
    x = _prefill_input(params, batch, cfg, policy)
    dev = x.device
    b, s = x.shape[:2]
    if paged and s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len} "
                         "for the paged KV layout")
    valid = None
    if true_len is not None:
        if (set(cfg.block_types) != {"attn"} or cfg.window
                or cfg.family in ("moe", "audio")
                or (cfg.family == "vlm" and "embeds" in batch)):
            raise ValueError(
                "bucketed prefill (true_len) needs a decoder-only "
                "attention stack without MoE, sliding windows or "
                f"cross/vision inputs; {cfg.name} is not one")
        true_len = torch.as_tensor(true_len, device=dev).to(
            torch.int32).reshape(-1).expand(b)
        valid = torch.arange(s, device=dev)[None, :] < true_len[:, None]
    cache = init_cache(cfg, b, max_len, policy=policy, device=dev)
    if cfg.family == "ssm":
        x = _ssm_prefill(params, x, cache, cfg, policy)
        return _prefill_logits(params, cache, x, cfg, None, paged)
    spec = kv_storage(policy)
    posit_kv = spec is not None and spec.is_posit
    w = _attn_w(cfg, max_len)
    start, length = max(s - w, 0), min(s, w)
    ring_idx = (start + torch.arange(length, device=dev)) % w
    vm = None if valid is None else valid[:, start:start + length]
    positions = torch.arange(s, device=dev)
    cos, sin = _rope_cs(cfg, seq_positions(cfg, b, s, dev))
    memory = None
    if cfg.family == "audio":
        memory = cache["memory"] = encode_audio(params, batch["frames"],
                                                cfg, policy)
    if paged:
        ps = policy.kv_page_size
        rows2d = (cache["page_table"][:, positions // ps].long() * ps
                  + (positions % ps)[None, :])                   # (B, S)
        if valid is not None:
            rows2d = torch.where(valid, rows2d, 0)

    def fill(c, name, kv):
        if paged:
            c[name][rows2d.reshape(-1)] = kv.reshape(
                (b * s,) + kv.shape[2:]).to(c[name].dtype)
            return
        rows = kv[:, start:start + length]
        if vm is not None:      # padding rows hold cache-init zeros
            rows = torch.where(vm[:, :, None, None], rows, 0)
        c[name][:, ring_idx] = rows.to(c[name].dtype)

    def reset_padding(c):
        for name, init in (("k", 0), ("v", 0), ("k_scale", 1.0),
                           ("v_scale", 1.0)):
            buf = c[name]
            m = vm.reshape(vm.shape + (1,) * (buf.ndim - 2))
            buf[:, ring_idx] = torch.where(m, buf[:, ring_idx], init)

    for i in range(cfg.n_layers):
        btype, p = layer_block(params, cfg, i)
        c = layer_block(cache, cfg, i)[1]
        if btype == "rec":
            x = _rec_prefill(p, c, x, cfg, policy)
            continue
        h = rms_norm(x, p["ln"])
        qp, kp, vp = _qkv(p, h, cfg, policy)
        qp = apply_rope(qp, cos, sin)
        kp = apply_rope(kp, cos, sin)
        ao = attention.blockwise_attention(qp, kp, vp, causal=True,
                                           window=cfg.window,
                                           q_block=cfg.q_block,
                                           kv_block=cfg.kv_block)
        x = x + _einsum("bsk,kd->bsd", ao.reshape(b, s, -1),
                        _qw(policy, "attn_weights")(p["wo"]))
        if posit_kv and paged:
            paged_kernels.paged_kv_append_rows(
                c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, rows2d,
                spec.fmt, packed=spec.packed)
        elif posit_kv:
            kv_kernels.kv_append_rows(
                c["k"], c["k_scale"], c["v"], c["v_scale"],
                kp[:, start:start + length], vp[:, start:start + length],
                torch.full((b,), start, dtype=torch.int32, device=dev),
                spec.fmt, packed=spec.packed)
            if vm is not None:
                reset_padding(c)
        else:
            fill(c, "k", kp)
            fill(c, "v", vp)
        if memory is not None:
            kx, vx = cross_kv(p, memory, cfg)
            x = cross_attend(p, x, cfg, kx, vx)
            c["xk"].copy_(kx)
            c["xv"].copy_(vx)
        x = x + _ffn(p, x, cfg, policy)
    return _prefill_logits(params, cache, x, cfg, true_len, paged)


def _prefill_input(params, batch, cfg: ModelCfg, policy):
    """The prefill's stack input: a vlm batch's ``embeds`` or the
    embedding rows of ``tokens``, in the model's dtype."""
    if cfg.family == "vlm" and "embeds" in batch:
        return batch["embeds"].to(cfg.dtype)
    return embed_rows(params["embed"], batch["tokens"], policy).to(cfg.dtype)


def _check_audio_prefill(params, batch) -> None:
    """An audio prefill's refusals, beside the reference's failures: a
    batch without ``frames`` (the reference's ``KeyError``: its engine
    passes tokens alone), and packed encoder or cross weights (the
    reference's ``pack_params`` drops the encoder blocks' layer axis from
    their scales, so its layer scan fails, and its prefill reads the cross
    weights raw)."""
    if "frames" not in batch:
        raise ValueError(
            "an audio (encoder-decoder) prefill needs batch['frames'], the "
            "(B, enc_seq, d_model) frame embeddings, beside the decoder's "
            "tokens; a tokens-only prompt (the engine's admission) has no "
            "encoder input")
    packed = [name for blk in params["enc_blocks"] for name, v in blk.items()
              if isinstance(v, QuantizedTensor)]
    packed += [name for blk in params["blocks"] for name, v in blk.items()
               if name.endswith("_x") and isinstance(v, QuantizedTensor)]
    if packed:
        raise ValueError(
            "an audio prefill over packed (QuantizedTensor) encoder or "
            f"cross-attention weights ({sorted(set(packed))}) is refused: "
            "the reference's pack_params scales enc_blocks across their "
            "layers (it stacks only 'blocks') and its prefill fails on "
            "them; serve unpacked weights")


def _rec_prefill(p, c, x, cfg: ModelCfg, policy):
    """One recurrent layer of a prefill: the block (``rec_mix`` and the
    MLP) on the whole prompt, its scan's last state (f32) into ``c["h"]``
    and the last K-1 rows of its raw ``u = h @ wx``, zero-padded in front
    for a prompt shorter than that, into ``c["conv"]`` (``u`` from its own
    product, as the reference computes it, not a slice of the fused
    ``[wy | wx]`` one).  Returns the residual stream."""
    if isinstance(p["wx"], QuantizedTensor):
        raise TypeError(
            "prefill: a recurrent block's wx is a packed QuantizedTensor; "
            "the reference's prefill reads wx raw and fails on it (its "
            "einsum refuses a QuantizedTensor), so it is refused here too: "
            "serve unpacked recurrent weights")
    k = cfg.conv_kernel
    u = _einsum("bsd,dk->bsk", rms_norm(x, p["ln"]), p["wx"])
    x, h_last = rec_mix(p, x, cfg)
    c["h"].copy_(h_last)
    c["conv"].copy_(torch.nn.functional.pad(u, (0, 0, k - 1, 0))[:, -(k - 1):])
    return x + _mlp(p, rms_norm(x, p["ln2"]), cfg, policy)


def _ssm_prefill(params, x, cache, cfg: ModelCfg, policy):
    """The Mamba-2 layers of a prefill: each layer's final SSD state and
    the last K-1 rows of its raw (pre-conv) ``xBC`` stream, zero-padded
    in front for a prompt shorter than that, land in the cache.  Returns
    the residual stream."""
    blk = cache["blocks"][0]
    k = cfg.conv_kernel
    q = _qw(policy, "mlp_weights")
    for i in range(cfg.n_layers):
        p = layer_block(params, cfg, i)[1]
        h = rms_norm(x, p["ln"])
        zxbcdt = in_proj(p, h, q)
        _, xbc, _ = _split_streams(zxbcdt, cfg)
        y, (_, state) = mamba2_layer(p, h, cfg, quantize_w=q, zxbcdt=zxbcdt)
        x = x + y.to(x.dtype)
        blk["state"][i] = state
        blk["conv"][i] = torch.nn.functional.pad(
            xbc, (0, 0, k - 1, 0))[:, -(k - 1):]
    return x


def _prefill_logits(params, cache, x, cfg: ModelCfg, true_len, paged):
    """The prefill's head: logits (B, vocab_pad) at each row's last real
    position, and ``cache["pos"]``."""
    b, s = x.shape[:2]
    dev = x.device
    x = rms_norm(x, params["final_norm"])
    x_last = (x[:, -1] if true_len is None
              else x[torch.arange(b, device=dev), true_len.long() - 1])
    # the head one row at a time: a GEMM's reduction order may depend on
    # its row count, and a prompt's logits must not depend on how many
    # prompts share the prefill (the reference's do not)
    head = lm_head(params, cfg)
    logits = torch.cat([_einsum("bd,dv->bv", x_last[i:i + 1], head)
                        for i in range(b)])
    if true_len is not None:
        cache["pos"] = true_len
    else:
        cache["pos"] = (torch.full((b,), s, dtype=torch.int32, device=dev)
                        if paged else
                        torch.tensor(s, dtype=torch.int32, device=dev))
    return logits, cache
