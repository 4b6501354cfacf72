"""Serving path of the dense attention stack: cache init, bucketed prefill
and single-token decode (port of ``repro.models.serve_model``, ring and
paged layouts).

Caches keep the reference's layout: ``{"pos", "blocks": ({...},)}`` where a
posit cache block holds ``k``/``v`` codes (P, B, W, nkv, Dc) and
``k_scale``/``v_scale`` f32 (P, B, W, nkv), and a float cache block holds
``k``/``v`` (P, B, W, nkv, hd).  ``pos`` is a scalar or a (B,) per-slot
vector.  Ring writes land at row pos mod W.

With ``policy.kv_layout == "paged"`` the per-slot rings become one flat
page pool per layer, (P, R, nkv, Dc|hd) with R = num_pages * page_size
rows and no batch axis, plus a top-level ``page_table`` (B, Pmax) int32
and a (B,) ``pos`` (``kernels/paged_kv.py`` has the layout).

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
from ..core.transprecision import BF16, KVStorage, TCPolicy, kv_storage
from ..kernels import kv_cache as kv_kernels
from ..kernels import paged_kv as paged_kernels
from . import attention
from .common import _einsum, apply_rope, rms_norm
from .lm import ModelCfg, _mlp, _qkv, _qw, _rope_cs, layer_params, lm_head

def check_layout(policy: TCPolicy) -> bool:
    """True for the paged KV layout, False for the ring; raises on any
    other."""
    if policy.kv_layout not in ("ring", "paged"):
        raise ValueError(f"unknown kv_layout {policy.kv_layout!r}; known: "
                         "ring|paged")
    return policy.kv_layout == "paged"


def init_cache(cfg: ModelCfg, batch: int, max_len: int, dtype=None,
               policy: TCPolicy = BF16, *, num_pages: Optional[int] = None,
               device="cuda") -> Dict[str, Any]:
    """Empty decode state for ``batch`` sequences up to ``max_len`` tokens.

    A posit ``kv_format`` stores codes (zeros) plus per-row f32 pow2 scales
    (ones); otherwise K/V are floats in the format's (or model's) dtype.
    Paged: ``num_pages=None`` reserves the full pool (1 trash page + batch
    * Pmax) with the identity table (slot i owns pages 1 + i*Pmax ..), so
    standalone prefill/decode needs no allocator; an explicit
    ``num_pages`` gives a zero (all-trash) table that the caller owns."""
    paged = check_layout(policy)
    device = resolve_device(device)
    spec = kv_storage(policy)
    hd, nkv, P = cfg.head_dim, cfg.n_kv_heads, cfg.n_layers
    if paged:
        ps = policy.kv_page_size
        pmax = -(-max_len // ps)            # logical pages per slot
        full_pool = num_pages is None
        if full_pool:
            num_pages = 1 + batch * pmax    # page 0 is the trash page
        rows = (P, num_pages * ps, nkv)
    else:
        rows = (P, batch, max_len, nkv)
    if spec is not None and spec.is_posit:
        dc = kv_kernels.code_channels(hd, spec.fmt, spec.packed)
        blk = {"k": torch.zeros(rows + (dc,), dtype=spec.fmt.storage_dtype,
                                device=device),
               "v": torch.zeros(rows + (dc,), dtype=spec.fmt.storage_dtype,
                                device=device),
               "k_scale": torch.ones(rows, device=device),
               "v_scale": torch.ones(rows, device=device)}
    else:
        dt = dtype or (spec.dtype if spec is not None else cfg.dtype)
        blk = {"k": torch.zeros(rows + (hd,), dtype=dt, device=device),
               "v": torch.zeros(rows + (hd,), dtype=dt, device=device)}
    cache = {"pos": torch.zeros((batch,) if paged else (), dtype=torch.int32,
                                device=device),
             "blocks": (blk,)}
    if paged:
        table = (1 + torch.arange(batch * pmax, device=device).reshape(
            batch, pmax) if full_pool
            else torch.zeros((batch, pmax), device=device))
        cache["page_table"] = table.to(torch.int32)
    return cache


def _layer_cache(cache, i: int) -> Dict[str, torch.Tensor]:
    """Views of layer i's cache rows (writes land in the stacked buffers)."""
    return {k: v[i] for k, v in cache["blocks"][0].items()}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _ring_write(buf, val, pos):
    """buf: (B, W, ...); val: (B, 1, ...); write at pos mod W, in place.
    ``pos`` scalar (shared) or (B,) per-slot."""
    w = buf.shape[1]
    if pos.ndim:
        buf[torch.arange(buf.shape[0], device=buf.device), pos.long() % w] = \
            val[:, 0].to(buf.dtype)
    else:
        buf[:, int(pos) % w] = val[:, 0].to(buf.dtype)


def _attn_decode_paged(c, qp, kp, vp, paged, spec: Optional[KVStorage]):
    """Paged-pool K/V append + page-walking attention for one layer.
    ``paged`` is (dst (B,) flat rows, seq_lens (B,), page table (B, Pmax),
    page size), shared by every layer of the step."""
    dst, seq_lens, table, ps = paged
    if spec is not None and spec.is_posit:
        paged_kernels.paged_kv_append(   # K5 reads the model's dtype
            c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, dst,
            spec.fmt, packed=spec.packed)
        return paged_kernels.paged_decode_attention(
            qp, c["k"], c["k_scale"], c["v"], c["v_scale"], table, seq_lens,
            spec.fmt, page_size=ps, packed=spec.packed)
    # float formats: plain scatter + gather, as the reference (no kernel)
    rows = dst.long()
    c["k"][rows] = kp[:, 0].to(c["k"].dtype)
    c["v"][rows] = vp[:, 0].to(c["v"].dtype)
    return attention.decode_attention(
        qp, paged_kernels.gather_pages(c["k"], table, ps),
        paged_kernels.gather_pages(c["v"], table, ps), seq_lens)


def _attn_decode(p, c, x, cfg: ModelCfg, policy, pos,
                 spec: Optional[KVStorage], paged=None):
    b = x.shape[0]
    h = rms_norm(x, p["ln"])
    qp, kp, vp = _qkv(p, h, cfg, policy)
    posv = pos[:, None] if pos.ndim else pos[None]
    cos, sin = _rope_cs(cfg, posv)
    qp = apply_rope(qp, cos, sin)
    kp = apply_rope(kp, cos, sin)
    if paged is not None:
        ao = _attn_decode_paged(c, qp, kp, vp, paged, spec)
    else:
        cl = torch.clamp(pos + 1, max=c["k"].shape[1])
        if spec is not None and spec.is_posit:
            kv_kernels.kv_append_rows(     # K3 reads the model's dtype
                c["k"], c["k_scale"], c["v"], c["v_scale"], kp, vp, pos,
                spec.fmt, packed=spec.packed)
            ao = attention.decode_attention_packed(
                qp, c["k"], c["v"], cl, k_scale=c["k_scale"],
                v_scale=c["v_scale"], spec=spec)
        else:
            _ring_write(c["k"], kp, pos)
            _ring_write(c["v"], vp, pos)
            ao = attention.decode_attention(qp, c["k"], c["v"], cl)
    # attention may run at higher precision than the stream (f32-decoded
    # K/V); the residual stream keeps the model dtype
    x = x + _einsum("bsk,kd->bsd", ao.reshape(b, 1, -1),
                    _qw(policy, "attn_weights")(p["wo"])).to(x.dtype)
    return x + _mlp(p, rms_norm(x, p["ln2"]), cfg, policy)


def decode_step(params, cache, tokens, cfg: ModelCfg,
                policy: TCPolicy = BF16):
    """One serving step. tokens: (B, 1) int.  Returns (logits (B,
    vocab_pad), cache) with K/V rows written in place and ``pos`` + 1.
    Paged caches (``cache["page_table"]``) take per-slot positions; a
    scalar ``pos`` is broadcast to every slot."""
    check_layout(policy)
    spec = kv_storage(policy)
    pos = cache["pos"]
    emb = policy.quantize_weight(params["embed"], "embed_weights")
    x = emb[tokens].to(cfg.dtype)
    table, paged, pos_l = cache.get("page_table"), None, pos
    if table is not None:
        pos_l = pos.expand(x.shape[0]) if pos.ndim == 0 else pos
        ps = policy.kv_page_size
        paged = (paged_kernels.flat_dst_rows(table, pos_l, ps), pos_l + 1,
                 table, ps)
    for i in range(cfg.n_layers):
        x = _attn_decode(layer_params(params["blocks"][0], i),
                         _layer_cache(cache, i), x, cfg, policy, pos_l, spec,
                         paged)
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
    return x + _mlp(p, rms_norm(x, p["ln2"]), cfg, policy)


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
                policy: TCPolicy = BF16):
    """Multi-token verify pass of self-speculative decoding: score a (B, T)
    token chunk in one model call.  Token t of slot b is scored and its
    K/V row written, in place, at position ``pos[b] + t``.  Returns
    (logits (B, T, vocab_pad), cache) with ``pos`` + T; the caller commits
    the accepted tokens and rolls the cache back past the first rejection
    (``serve/speculative.py``)."""
    check_verifiable(cfg)
    check_layout(policy)
    spec = kv_storage(policy)
    b, t = tokens.shape
    pos = cache["pos"]
    pos_l = (pos.expand(b) if pos.ndim == 0 else pos).to(torch.int32)
    emb = policy.quantize_weight(params["embed"], "embed_weights")
    x = emb[tokens].to(cfg.dtype)
    table, paged = cache.get("page_table"), None
    if table is not None:
        ps = policy.kv_page_size
        paged = (paged_kernels.flat_dst_rows_chunk(table, pos_l, t, ps),
                 table, ps)
    for i in range(cfg.n_layers):
        x = _attn_verify(layer_params(params["blocks"][0], i),
                         _layer_cache(cache, i), x, cfg, policy, pos_l, spec,
                         paged)
    x = rms_norm(x, params["final_norm"])
    logits = _einsum("bsd,dv->bsv", x, lm_head(params, cfg))
    cache["pos"] = pos + t
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
    vector.  Ring: padding K/V rows hold cache-init values (codes 0,
    scale 1).  Paged (full pool, identity table; S <= max_len): prompt row
    t of slot b lands at ``page_table[b, t//ps]*ps + t%ps`` and padding
    rows land on trash row 0.

    Posit caches are written by the K3 path (``kv_append_rows`` from
    position ``max(S - W, 0)``) into the fresh ring, then the padding rows
    are reset: the same bits as the reference's bulk encode.  Paged posit
    pools are written by the K5 path at T = S with those flat rows."""
    paged = check_layout(policy)
    tokens = batch["tokens"]
    dev = tokens.device
    b, s = tokens.shape
    if paged and s > max_len:
        raise ValueError(f"prompt length {s} exceeds max_len {max_len} "
                         "for the paged KV layout")
    emb = policy.quantize_weight(params["embed"], "embed_weights")
    x = emb[tokens].to(cfg.dtype)
    valid = None
    if true_len is not None:
        true_len = torch.as_tensor(true_len, device=dev).to(
            torch.int32).reshape(-1).expand(b)
        valid = torch.arange(s, device=dev)[None, :] < true_len[:, None]
    cache = init_cache(cfg, b, max_len, policy=policy, device=dev)
    spec = kv_storage(policy)
    posit_kv = spec is not None and spec.is_posit
    w = max_len
    start, length = max(s - w, 0), min(s, w)
    ring_idx = (start + torch.arange(length, device=dev)) % w
    vm = None if valid is None else valid[:, start:start + length]
    positions = torch.arange(s, device=dev)
    cos, sin = _rope_cs(cfg, positions)
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
        p = layer_params(params["blocks"][0], i)
        c = _layer_cache(cache, i)
        h = rms_norm(x, p["ln"])
        qp, kp, vp = _qkv(p, h, cfg, policy)
        qp = apply_rope(qp, cos, sin)
        kp = apply_rope(kp, cos, sin)
        ao = attention.blockwise_attention(qp, kp, vp, causal=True,
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
        x = x + _mlp(p, rms_norm(x, p["ln2"]), cfg, policy)
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
