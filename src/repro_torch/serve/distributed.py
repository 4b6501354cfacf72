"""Distributed decode: KV-sequence sharding + log-sum-exp combine, and the
recurrent state split over ranks, over ``torch.distributed`` (port of
``repro.serve.distributed``).

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
only its share of the decode state (``KVShard``; the rank-local caches are
``models.serve_model.init_cache(..., kv_shard=)``), the dims
``launch.mesh.cache_specs`` splits (``models.common.rank_split``):

* KV rows.  A rank owns global ring rows [r*W/n, (r+1)*W/n) of every
  slot, or physical pages [r*N/n, (r+1)*N/n) of a paged pool; ``pos``,
  ``tok`` and the page table are replicated.  Each layer's decode append
  takes the global flat row and writes it where the rank owns it (K5 on
  the card, ring and paged, with -1 for rows of other ranks), and the
  plug decodes the rank's codes (K1 on the card) before its partial LSE.
  The combine is two all-reduces a layer: ``MAX`` of m and one ``SUM``
  over o and l packed into one buffer.  A hybrid stack's local-attention
  rings split the same way (W = min(window, max_len) rows).
* The recurrent state, on "model".  A Mamba-2 layer's ``state`` (B, nh,
  hd, ds) by heads, its ``conv`` (B, K-1, ch) by channels (ch = d_inner +
  2 ng ds: the B and C channels fall to the last ranks); an RG-LRU
  layer's ``h`` (B, width) and ``conv`` (B, K-1, width) by width.  Each
  rank runs the layer's input products whole, the conv over its own
  channels, then all-gathers the conv's output, runs the recurrence for
  its own heads or width columns (``w_a`` / ``w_x``'s columns) and
  all-gathers y; the gated norm or ``y * gate`` and the output product
  run whole.  Two all-gathers a layer, of O(B * channels) elements: the
  state never moves.

Every collective goes through ``collective``, which counts each call, its
kind and bytes in ``COLLECTIVES`` (``reset_collectives`` sets it to 0);
under ``stand_in_collectives()`` it communicates nothing (the dry run's
rank on the meta device, ``launch.dryrun``'s ``distributed_decode``).
Tensor parallelism of the weights is not part of it: the reference's
``make_distributed_engine`` shards only the attention, and its SSM and
recurrent layers run whole under it.

Every extent a rank splits must be a multiple of the world size
(``ValueError``, naming the extent and the world; the reference's paged
body misreads rows silently when pages straddle shards).  An audio
stack's cross K/V and encoder memory stay whole on every rank, where the
cross-attention reads them without the plug.

With no initialised process group the world is 1 and no collective runs.
"""
from __future__ import annotations

import contextlib
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

# every collective of the distributed decode since the last
# ``reset_collectives``, by kind: calls, and bytes of their results and
# operands (an all-gather's result is world x its operand)
KINDS = ("all-reduce", "all-gather")
COLLECTIVES = {k: {"count": 0, "result_bytes": 0, "operand_bytes": 0}
               for k in KINDS}


def reset_collectives() -> None:
    for rec in COLLECTIVES.values():
        for key in rec:
            rec[key] = 0


@contextlib.contextmanager
def stand_in_collectives():
    """Inside the block ``collective`` counts each call, from 0, and
    communicates nothing (``_transport`` is a no-op there): an all-reduce
    leaves its tensor as it is, an all-gather concatenates world
    uninitialised parts (a rank's trace on the meta device, where no
    process group exists)."""
    global _transport
    real, _transport = _transport, lambda *_: None
    reset_collectives()
    try:
        yield COLLECTIVES
    finally:
        _transport = real


def _transport(kind: str, t, parts, shard, op) -> None:
    """The communication of one collective (``torch.distributed``): ``t``
    reduced in place, or gathered into ``parts``."""
    if kind == "all-reduce":
        dist.all_reduce(t, op=op, group=shard.group)
    else:
        dist.all_gather(parts, t, group=shard.group)


def collective(kind: str, t, shard, *, op=None, dim: int = -1):
    """The one door of every collective the distributed decode issues over
    ``shard``'s group: "all-reduce" reduces ``t`` in place by ``op`` and
    returns it; "all-gather" returns the world ranks' ``t`` concatenated
    along ``dim`` in rank order.  Counted in ``COLLECTIVES``."""
    t = t.contiguous()
    n = t.numel() * t.element_size()
    rec = COLLECTIVES[kind]
    rec["count"] += 1
    rec["operand_bytes"] += n
    rec["result_bytes"] += n * (shard.world if kind == "all-gather" else 1)
    parts = (None if kind == "all-reduce"
             else [torch.empty_like(t) for _ in range(shard.world)])
    _transport(kind, t, parts, shard, op)
    return t if parts is None else torch.cat(parts, dim=dim)


@dataclasses.dataclass(frozen=True)
class KVShard:
    """One rank's share of a distributed decode: its ``rank`` of ``world``
    in process ``group``; ``collective`` where a process group is
    initialised (the combine then all-reduces and the recurrent layers
    all-gather, at world 1 too) or where a dry run stands in for one."""
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
        """[lo, hi) of ``n`` entries (``what``: ring rows, SSD heads, ...)
        that this rank owns; raises ``ValueError`` unless ``world``
        divides ``n``."""
        if n % self.world:
            raise ValueError(
                f"{n} {what} do not split over {self.world} ranks: a rank "
                "owns one contiguous 1/world of them (KV pages must never "
                "straddle ranks)")
        k = n // self.world
        return self.rank * k, (self.rank + 1) * k

    def own(self, n: int, what: str) -> slice:
        """This rank's ``local_range`` of ``n`` as a slice."""
        return slice(*self.local_range(n, what))

    def all_gather(self, t, dim: int = -1):
        """Every rank's ``t`` concatenated along ``dim`` (``t`` itself
        where no collective runs)."""
        if not self.collective:
            return t
        return collective("all-gather", t, self, dim=dim)


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
        m_g = collective("all-reduce", m.clone(), shard,
                         op=dist.ReduceOp.MAX)
    corr = torch.exp(m - m_g)
    num, den = o * corr[..., None], l * corr
    if shard.collective:
        buf = collective("all-reduce", torch.cat(
            [num.reshape(-1), den.reshape(-1)]), shard, op=dist.ReduceOp.SUM)
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
    cache is this rank's slice of the sequence.  The rank is the plug's
    ``shard`` attribute, ``KVShard.of(group)``, read at each call: a dry
    run, with no process group, sets its own there.  The decode step reads
    it for the recurrent layers' split too.

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
    posit = kv_spec is not None and kv_spec.is_posit

    if paged:
        def attn_paged(q, k_codes, v_codes, seq_lens, *, k_scale=None,
                       v_scale=None, page_table, page_size=page_size, **_):
            shard = attn_paged.shard
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
        attn_paged.shard = KVShard.of(group)
        return attn_paged

    def ring(q, k_cache, v_cache, cache_len, shard):
        start = shard.rank * k_cache.shape[1]
        out = _combine(*_local_lse(_scaled_groups(q, k_cache.shape[2]),
                                   k_cache, v_cache, start, cache_len),
                       shard, q.dtype)
        return out.reshape(q.shape)

    if posit:
        def plug(q, k_codes, v_codes, cache_len, *, k_scale, v_scale, **_):
            kf = decode_kv_rows_device(k_codes, k_scale[..., None],
                                       kv_spec.fmt, kv_spec.packed)
            vf = decode_kv_rows_device(v_codes, v_scale[..., None],
                                       kv_spec.fmt, kv_spec.packed)
            return ring(q, kf, vf, cache_len, plug.shard)

        plug.packed_kv = True
    else:
        def plug(q, k_cache, v_cache, cache_len, **_):
            return ring(q, k_cache, v_cache, cache_len, plug.shard)

    plug.shard = KVShard.of(group)
    return plug


def _plug_for(policy, group):
    return distributed_decode_attention(
        group, kv_spec=kv_storage(policy),
        paged=getattr(policy, "kv_layout", "ring") == "paged",
        page_size=getattr(policy, "kv_page_size", 16))


class _DecodeStep:
    """``decode_step`` over the plug ``attn_impl``; ``shard`` is the
    plug's."""

    def __init__(self, cfg, policy, attn_impl):
        self.cfg, self.policy, self.attn_impl = cfg, policy, attn_impl

    @property
    def shard(self) -> KVShard:
        return self.attn_impl.shard

    def __call__(self, params, cache, tok):
        if self.cfg.family == "vlm":
            return serve_model.decode_step(
                params, cache, None, self.cfg, self.policy, embeds=tok,
                attn_impl=self.attn_impl)
        return serve_model.decode_step(params, cache, tok, self.cfg,
                                       self.policy, attn_impl=self.attn_impl)


def make_distributed_decode_step(cfg, policy, group=None):
    """decode_step with the distributed decode plugged in (the
    LSE-combined attention, the recurrent layers over the rank's split
    state), for every family; ``step(params, cache, tok)`` takes a
    rank-local cache (``serve_model.init_cache(..., kv_shard=step.shard)``
    or ``serve_model.shard_cache``) and, for a vlm stack, patch embeddings
    (B, 1, d) as ``tok``.  ``step.attn_impl`` is the plug, whose ``shard``
    names the rank (``step.shard``)."""
    policy = get_policy(policy)
    return _DecodeStep(cfg, policy, _plug_for(policy, group))


def make_distributed_engine(cfg, policy, max_batch: int, max_len: int, *,
                            group=None, num_pages: Optional[int] = None,
                            device="cuda"):
    """A three-stage ``engine_api.TransprecisionEngine`` of any family
    whose ``generate`` runs the distributed decode over a rank-local
    decode state: the engine API and the distributed decode path are the
    same code, differing only in the plugged ``attn_impl``."""
    policy = get_policy(policy)
    return TransprecisionEngine(cfg, policy, max_batch, max_len,
                                num_pages=num_pages, device=device,
                                attn_impl=_plug_for(policy, group))
