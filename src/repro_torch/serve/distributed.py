"""Distributed decode attention: KV-sequence sharding + log-sum-exp combine
over ``torch.distributed`` (port of ``repro.serve.distributed``).

Sharding the cache's sequence axis is the only serving layout whose KV
memory per device falls with the device count; a naive softmax over a
sharded axis would gather the WHOLE cache every token.  Each shard instead
reduces its local slice to

    (m_i = max_s, l_i = sum exp(s - m_i), o_i = sum exp(s - m_i) v)

and the combine is an O(B*nh*hd) all-reduce, whatever the context length:

    m = max_i m_i;  out = sum_i o_i e^{m_i - m} / sum_i l_i e^{m_i - m}

Where the reference runs one program over a global cache that
``shard_map`` splits, the port is SPMD: every rank is a process that runs
the same host loop, prefill and layers over replicated weights, and holds
only its slice of the KV sequence (``KVShard``; the rank-local caches are
``models.serve_model.init_cache(..., kv_shard=)``).  The only collectives
are the combine's, two a layer: ``all_reduce(m, MAX)`` and one SUM over
o and l packed into one buffer.  Tensor parallelism of the weights is not
part of it (the reference's ``make_distributed_engine`` shards only the
attention).

A rank owns global ring rows [r*W/n, (r+1)*W/n) of every slot, or physical
pages [r*N/n, (r+1)*N/n) of a paged pool; ``pos``, ``tok`` and the page
table are replicated.  Each layer's decode append takes the global flat
row and writes it where the rank owns it (K5 on the card, ring and paged,
with -1 for rows of other ranks), and the plug decodes the rank's codes
(K1 on the card) before its partial LSE.  W or the page count must be a
multiple of the world size (``ValueError``; the reference's paged body
misreads rows silently when pages straddle shards).  A hybrid stack's
local-attention rings split the same way (W = min(window, max_len) rows,
which the world must divide); its recurrent state, and an audio stack's
cross K/V and encoder memory, stay whole on every rank, where the
cross-attention reads them without the plug.  The SSM stack holds no KV
sequence and raises ``NotImplementedError``.

With no initialised process group the world is 1 and no collective runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.transprecision import get_policy, kv_storage
from ..kernels.kv_cache import decode_kv_rows_device
from ..kernels.paged_kv import gather_decode_pages_device, gather_pages
from ..models import serve_model
from ..models.attention import NEG_INF
from ..models.common import _einsum
from .engine_api import TransprecisionEngine


@dataclasses.dataclass(frozen=True)
class KVShard:
    """One rank's share of a KV-sequence-sharded decode: its ``rank`` of
    ``world`` in process ``group``; ``collective`` where a process group is
    initialised (the combine then all-reduces, at world 1 too)."""
    rank: int = 0
    world: int = 1
    group: Any = None
    collective: bool = False

    @classmethod
    def of(cls, group=None) -> "KVShard":
        """The calling process's shard in ``group`` (None: the default
        group); world 1 without an initialised process group."""
        if not (dist.is_available() and dist.is_initialized()):
            return cls()
        return cls(dist.get_rank(group), dist.get_world_size(group), group,
                   True)

    def local_range(self, n: int, what: str = "KV rows") -> Tuple[int, int]:
        """[lo, hi) of ``n`` sequence entries that this rank owns; raises
        ``ValueError`` unless ``world`` divides ``n``."""
        if n % self.world:
            raise ValueError(
                f"{n} {what} do not split over {self.world} ranks: the KV "
                "sequence shards only evenly (each rank owns one contiguous "
                "range; pages must never straddle ranks)")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k


def _lse(q, k, v, valid):
    """Partial attention of q (B, 1, nkv, grp, hd), already scaled, over
    rows k/v (B, L, nkv, hd) where ``valid`` (B, L).  Returns (o (B, nkv,
    grp, hd), l (B, nkv, grp), m (B, nkv, grp)) in f32."""
    scores = _einsum("bqkgh,bskh->bkgqs", q, k).to(torch.float32)[..., 0, :]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    m = scores.amax(-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(-1)
    o = _einsum("bkgs,bskh->bkgh", p.to(v.dtype), v).to(torch.float32)
    return o, l, m


def _local_lse(q, k, v, start, cache_len):
    """Partial attention over a local KV slice.

    q: (B, 1, nkv, grp, hd); k/v: (B, Wl, nkv, hd); start: global index of
    this slice; cache_len scalar (shared) or (B,) per-slot.  Returns
    (o (B,nkv,grp,hd), l (B,nkv,grp), m (B,nkv,grp))."""
    b, wl = k.shape[:2]
    idx = start + torch.arange(wl, device=k.device)
    cl = torch.as_tensor(cache_len, device=k.device).reshape(-1).expand(b)
    return _lse(q, k, v, idx[None, :] < cl[:, None])


def _combine(o, l, m, shard: KVShard, dtype):
    """The LSE combine across ranks: two all-reduces (MAX of m, one SUM of
    o and l rescaled to it), then num / max(den, 1e-30) in ``dtype``."""
    m_g = m
    if shard.collective:
        m_g = m.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=shard.group)
    corr = torch.exp(m - m_g)
    num, den = o * corr[..., None], l * corr
    if shard.collective:
        buf = torch.cat([num.reshape(-1), den.reshape(-1)])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=shard.group)
        num = buf[:num.numel()].view(num.shape)
        den = buf[num.numel():].view(den.shape)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(dtype)


def _scaled_groups(q, nkv: int):
    """q (B, 1, nh, hd) -> (B, 1, nkv, grp, hd) scaled by hd^-0.5 in q's
    dtype, as the reference scales it."""
    b, _, nh, hd = q.shape
    return q.reshape(b, 1, nkv, nh // nkv, hd) * (hd ** -0.5)


def distributed_decode_attention(group=None, *, kv_spec=None,
                                 paged: bool = False, page_size: int = 16):
    """Returns an ``attn_impl(q, k_cache, v_cache, cache_len)`` whose KV
    cache is this rank's slice of the sequence (the plug's ``shard``, a
    ``KVShard`` of ``group``).

    With a posit ``kv_spec`` (``core.transprecision.KVStorage``) the plug
    speaks the packed protocol (``attn.packed_kv``): it takes the rank's
    ring codes + per-row scales and decodes them itself (K1 on the card)
    right before the partial LSE reduction.

    With ``paged=True`` it speaks the paged protocol (``attn.paged_kv``):
    the rank's slice of the pool (a contiguous physical page range), the
    replicated page table and per-slot lengths; it gathers only the table
    entries that fall in its page range and masks the rest.  The port
    takes this protocol for float pools too (rows, no scales): a rank
    holds physical pages, not the slot-logical view a plain plug reads.

    Otherwise (a float ring) it takes the rank's float rows."""
    shard = KVShard.of(group)
    posit = kv_spec is not None and kv_spec.is_posit

    if paged:
        def attn_paged(q, k_codes, v_codes, seq_lens, *, k_scale=None,
                       v_scale=None, page_table, page_size=page_size, **_):
            b, nkv = q.shape[0], k_codes.shape[1]
            np_local = k_codes.shape[0] // page_size
            loc = page_table.to(torch.int64) - shard.rank * np_local
            own = (loc >= 0) & (loc < np_local)               # (B, Pmax)
            tbl = torch.clamp(loc, 0, np_local - 1)
            if posit:
                kf, vf = (gather_decode_pages_device(
                    c, s, tbl, page_size, kv_spec.fmt, kv_spec.packed)
                    for c, s in ((k_codes, k_scale), (v_codes, v_scale)))
            else:
                kf = gather_pages(k_codes, tbl, page_size)
                vf = gather_pages(v_codes, tbl, page_size)
            lens = torch.as_tensor(seq_lens, device=q.device).reshape(
                -1).expand(b)
            kpos = torch.arange(kf.shape[1], device=q.device)
            valid = (own.repeat_interleave(page_size, dim=1)
                     & (kpos[None, :] < lens[:, None]))
            out = _combine(*_lse(_scaled_groups(q, nkv), kf, vf, valid),
                           shard, q.dtype)
            return out.reshape(q.shape)

        attn_paged.paged_kv = True
        attn_paged.shard = shard
        return attn_paged

    if posit:
        def attn_packed(q, k_codes, v_codes, cache_len, *, k_scale, v_scale,
                        **_):
            kf = decode_kv_rows_device(k_codes, k_scale[..., None],
                                       kv_spec.fmt, kv_spec.packed)
            vf = decode_kv_rows_device(v_codes, v_scale[..., None],
                                       kv_spec.fmt, kv_spec.packed)
            return attn(q, kf, vf, cache_len)

    def attn(q, k_cache, v_cache, cache_len, **_):
        start = shard.rank * k_cache.shape[1]
        out = _combine(*_local_lse(_scaled_groups(q, k_cache.shape[2]),
                                   k_cache, v_cache, start, cache_len),
                       shard, q.dtype)
        return out.reshape(q.shape)

    if posit:
        attn_packed.packed_kv = True
        attn_packed.shard = shard
        return attn_packed
    attn.shard = shard
    return attn


def _plug_for(cfg, policy, group):
    serve_model.check_shardable(cfg)
    return distributed_decode_attention(
        group, kv_spec=kv_storage(policy),
        paged=getattr(policy, "kv_layout", "ring") == "paged",
        page_size=getattr(policy, "kv_page_size", 16))


def make_distributed_decode_step(cfg, policy, group=None):
    """decode_step with the LSE-combined distributed attention plugged in;
    ``step(params, cache, tok)`` takes a rank-local cache
    (``serve_model.init_cache(..., kv_shard=step.shard)`` or
    ``serve_model.shard_cache``) and, for a vlm stack, patch embeddings
    (B, 1, d) as ``tok``."""
    policy = get_policy(policy)
    attn_impl = _plug_for(cfg, policy, group)

    def step(params, cache, tok):
        if cfg.family == "vlm":
            return serve_model.decode_step(params, cache, None, cfg, policy,
                                           embeds=tok, attn_impl=attn_impl)
        return serve_model.decode_step(params, cache, tok, cfg, policy,
                                       attn_impl=attn_impl)

    step.shard = attn_impl.shard
    return step


def make_distributed_engine(cfg, policy, max_batch: int, max_len: int, *,
                            group=None, num_pages: Optional[int] = None,
                            device="cuda"):
    """A three-stage ``engine_api.TransprecisionEngine`` whose
    ``generate`` runs the LSE-combined KV-sharded attention over a
    rank-local decode state: the engine API and the distributed decode
    path are the same code, differing only in the plugged ``attn_impl``."""
    policy = get_policy(policy)
    return TransprecisionEngine(cfg, policy, max_batch, max_len,
                                num_pages=num_pages, device=device,
                                attn_impl=_plug_for(cfg, policy, group))
