"""Serving-engine API: three stages over one shared decode state (port of
``repro.serve.engine_api``, ring and paged layouts).

    prefill(params, tokens, lengths) -> Prefix
    insert(prefix, decode_state, slot) -> decode_state
    generate(params, decode_state)    -> (decode_state, logits)

* **Bucketed prefill.**  Prompts are right-padded to a power-of-two bucket
  and prefilled at bucket width with per-row true lengths; padded keys are
  causally masked to exact-zero contributions.  Only where rows meet in
  attention alone: the MoE family (its routing sees every row of the
  call), the SSM family (its recurrence would carry the padding) and the
  hybrid family (its recurrence too, and its sliding window) prefill one
  prompt at its exact length, into a ``max_len``-wide prefix (a hybrid's
  attention rings are W = min(window, max_len) wide), as the reference
  does; so do the vlm and audio families, by the reference's rule.  An
  audio engine builds but cannot admit: its prompts carry no frames (the
  prefill raises ``ValueError``; the reference's raises ``KeyError``).
* **Prefix = bucket-width cache.**  ``prefill`` returns a ``Prefix`` whose
  cache leaves are (B, bucket, ...) ring rows; ``insert`` copies one row's
  prefix into rows [0, bucket) of a slot's ring IN PLACE (an SSM or
  recurrent prefix row's state and ``conv`` whole; a hybrid's ``tail``
  blocks as its ``blocks``).  Paged engines
  prefill through a ring copy of the policy at bucket width (the same
  codec as the pool) and ``insert`` scatters the prefix rows straight to
  the flat pool rows ``dst_rows``; no max_len ring is ever built.
* **generate** is one decode tick for the whole batch with per-slot
  positions; it writes K/V rows in place and advances ``state["tok"]`` to
  the greedy argmax per slot on the device.
* **verify** scores a (B, T) draft chunk in one target-precision pass and
  **rollback_ring** / **rollback_paged** rewind the rows a round rejected
  (the stages ``serve/speculative.py`` drives).

Distributed decode: ``attn_impl`` plugs a decode attention into
``generate`` (the reference's hook).  A plug with a ``shard``
(``serve/distributed.py``) makes the decode state rank-local: each rank
holds its slice of every ring's rows or of the pool's pages and of the
recurrent state's split dims (``models.common.rank_split``), the prefill
runs whole on every rank, and ``insert`` keeps the rank's share of the
prefix.  ``verify`` refuses such a state (``NotImplementedError``).

Energy accounting: the first call of each stage name records
``(fn, _abstract_args(args))`` in ``stage_specs``, the arguments as
shape-and-dtype meta tensors; ``obs/energy.py`` re-runs the stage on them
to count its work (``launch/op_cost.py``), as the reference re-lowers a
stage from its recorded spec.

Observability: with an enabled tracer every stage call is wrapped in a
``<stage>.dispatch`` span (the Python call, kernels queued) and a
``<stage>.device`` span around ``torch.cuda.synchronize``, inside a
``torch.profiler.record_function`` so host spans line up with device
traces.  With tracing disabled nothing is synchronized.

Donation (the reference's ``donate``): ``TransprecisionEngine(...,
donate=None)`` donates on a CUDA device and not on the CPU, as the
reference donates on any backend but the CPU; a plug with a ``shard``
resolves None to off and refuses True (``NotImplementedError``: its
collectives cannot be captured).  A donating engine's ``generate``,
``verify``, ``rollback_ring`` and ``rollback_paged`` consume the state
they are given and return one on the engine's fixed buffers, those of its
last ``init_decode_state``: the K/V rings or pool, ``pos``, ``tok``, the
page table, and for a recurrent stack (SSM, hybrid) two sets of recurrent
leaves that the steps alternate between (step n reads set n mod 2 and
writes set (n + 1) mod 2).  A caller uses the returned state, never an
old one.  Leaves a driver rebinds (``tok``, ``pos``, the page table) are
copied into the fixed buffers before the stage, and so are a stage's
host inputs: the verify chunk into a (B, T) buffer per T, the rollbacks'
``new_pos``, ``window_end``, ``scrub_from`` and ``scrub_rows``; a state
whose K/V or recurrent leaves are not the engine's own raises
``ValueError``, as a donated array raises in the reference.  On the card
the first ``generate`` after ``init_decode_state`` runs eagerly (the
kernels build, cuBLAS warms up), the second captures the fixed-buffer
step as a CUDA graph (one per parity) and replays it, and every later one
replays: one launch a tick for the whole stack.  Each speculative stage
does the same per shape (``verify`` per T, as the reference compiles per
T, ``rollback_ring`` per t, ``rollback_paged`` per scrub length): one
eager call, then a capture and replays.  Every graph of a state shares
one memory pool.  A failed capture raises; nothing falls back to eager
behind a donated call.  The graphs of ``generate`` and ``verify`` read
the parameters they were captured with (another ``params`` object
recaptures) and their returned logits are copies.  ``LAUNCHES`` counts a
replay as the kernels it replays; ``graph_stats()`` reports each stage's
eager calls, replays, capture ms and pool bytes.  ``stage_specs`` keeps
the eager stage functions (``_generate_impl``, ``_verify_impl``,
``rollback_ring_cache``, ``rollback_paged_cache``), which the energy
accountant re-runs on meta tensors.  On the CPU the fixed-buffer stages
run eagerly.

Chaos hardening (``serve/faults.py``): with a ``faults`` injector every
stage call first runs its ``on_stage`` hook, which may sleep (an injected
straggler) or raise; a ``retry`` policy re-runs stages whose exception is
flagged ``transient``.  The hook runs BEFORE the stage's function: the
stages write the decode state in place, so a failed attempt must not have
started writing K/V rows.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
import weakref
from time import perf_counter, sleep
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.transprecision import TCPolicy, get_policy
from ..kernels import _build
from ..models.common import KV_LEAVES, RECURRENT_SPLIT
from ..models.serve_model import (_local_rows, check_layout, decode_step,
                                  fresh_rec_state, init_cache, prefill,
                                  verify_step)
from ..obs import MetricsRegistry, Tracer

_MIN_BUCKET = 16

# A Prefix: {"logits": (B, vocab_pad), "cache": prefill cache (leaf rows at
# bucket width), "length": (B,) int32 true prompt lengths}.
Prefix = Dict[str, Any]


# ---------------------------------------------------------------------------
# Rollback stages (speculative decoding)
# ---------------------------------------------------------------------------

def rollback_ring_cache(cache, new_pos, window_end, scrub_from, t: int):
    """Rewind a ring-layout cache after a verify round, in place: set
    ``pos`` to ``new_pos`` (B,) and reset the speculatively written rows
    to their init values (codes / floats 0, scales 1).

    Scatter form, O(B·t) rows: per slot only the window of the last ``t``
    rows written, ``[window_end - t, window_end)`` (``window_end`` floored
    at t), and of those the rows at positions ``>= scrub_from``.  Slots
    with nothing to scrub pass ``scrub_from == window_end``.  Row index ==
    position: ``verify_step`` refuses sliding windows and a round never
    writes past the cap."""
    dev = cache["pos"].device
    _scrub_ring(cache["blocks"], torch.as_tensor(window_end, device=dev),
                torch.as_tensor(scrub_from, device=dev), t)
    cache["pos"] = torch.as_tensor(new_pos, device=dev).to(torch.int32,
                                                            copy=True)
    return cache


def _scrub_ring(blocks, window_end, scrub_from, t: int) -> None:
    """The ring rollback's row reset, from (B,) device tensors: no host
    data, so a CUDA graph can capture it."""
    end = torch.clamp(window_end.long(), min=t)
    frm = scrub_from.long()
    rows = end[:, None] - t + torch.arange(t, device=end.device)[None, :]
    keep = rows < frm[:, None]                                # (B, t)
    slot = torch.arange(rows.shape[0], device=end.device)[:, None].expand_as(
        rows)
    # the reference's scatter form: every window row is rewritten, kept
    # ones with their own value (no host sync, no data-dependent shape; a
    # row appears once per slot)
    for blk in blocks:                       # K/V leaves (P, B, W, ...)
        for name, leaf in blk.items():
            m = keep.reshape(keep.shape + (1,) * (leaf.ndim - 3))
            leaf[:, slot, rows] = torch.where(
                m, leaf[:, slot, rows], 1.0 if name.endswith("_scale") else 0)


def rollback_paged_cache(cache, new_pos, scrub_rows):
    """Rewind a paged-layout cache, in place: set ``pos`` to ``new_pos``
    (B,) and reset the flat pool rows ``scrub_rows`` ((N,), padded with
    trash row 0, where writes are benign) to their init values.  Page-table
    truncation and allocator frees are the engine's host-side half."""
    dev = cache["pos"].device
    _scrub_pool(cache["blocks"], torch.as_tensor(scrub_rows, device=dev))
    cache["pos"] = torch.as_tensor(new_pos, device=dev).to(torch.int32,
                                                            copy=True)
    return cache


def _scrub_pool(blocks, scrub_rows) -> None:
    """The paged rollback's row reset, from an (N,) device tensor."""
    rows = scrub_rows.long()
    for blk in blocks:                       # K/V pool leaves (P, R, ...)
        for name, leaf in blk.items():
            # a fill, not ``leaf[:, rows] = v``: on the card that copies v
            # from the host, which a capture refuses
            leaf.index_fill_(1, rows, 1.0 if name.endswith("_scale") else 0)


def _abstract_args(args):
    """``args`` with every tensor and numpy array (a host index vector)
    replaced by a meta tensor of its shape and dtype; Python scalars pass
    through.  Reads no data and syncs nothing: the energy accountant
    (``obs/energy.py``) counts a stage's work from this spec without
    holding a live buffer."""
    if isinstance(args, (torch.Tensor, np.ndarray)):
        return torch.empty_like(torch.as_tensor(args), device="meta")
    if isinstance(args, dict):
        return {k: _abstract_args(v) for k, v in args.items()}
    if isinstance(args, (tuple, list)):
        return type(args)(_abstract_args(v) for v in args)
    return args


def _weak_method(fn, owner):
    """``fn``, or where it is a method bound to ``owner``, a function that
    calls it through a weak reference: a stage spec must not keep its
    engine, and the donated state, CUDA graphs and weights the engine
    holds, alive in a reference cycle (dropping a driver frees them at
    once, without waiting for the cycle collector)."""
    if getattr(fn, "__self__", None) is not owner:
        return fn
    ref = weakref.WeakMethod(fn)

    @functools.wraps(fn.__func__)      # __wrapped__: the plain function
    def call(*args, **kwargs):
        method = ref()
        if method is None:
            raise ReferenceError(f"{call.__qualname__}: its engine is gone")
        return method(*args, **kwargs)
    return call


_CAPTURE_STREAMS: Dict[int, Any] = {}
_CAPTURE_LOCK = threading.Lock()


def _capture_stream(device) -> "torch.cuda.Stream":
    """The one side stream per device on which every donating engine runs
    its first (eager) tick and captures its graphs: cuBLAS keeps a
    workspace for each stream it has run on, for the life of the process,
    so a stream per engine would leave one behind per engine."""
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    stream = _CAPTURE_STREAMS.get(idx)
    if stream is None:
        stream = _CAPTURE_STREAMS.setdefault(idx, torch.cuda.Stream(idx))
    return stream


class _StageGraph:
    """One speculative stage at one shape (verify per T, ``rollback_ring``
    per t, ``rollback_paged`` per scrub length) over a donated state: its
    calls run eagerly and its replays, and once captured its CUDA graph,
    static output, the launches a replay counts, the capture's ms and the
    pool bytes it reserved."""

    def __init__(self):
        self.eager = 0
        self.replays = 0
        self.graph = None
        self.out = None
        self.launched: Optional[Dict[str, int]] = None
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None

    def stats(self) -> Dict[str, Any]:
        return {"eager_calls": self.eager, "replays": self.replays,
                "capture_ms": self.capture_ms, "pool_bytes": self.pool_bytes,
                "launches": (None if self.launched is None
                             else dict(self.launched))}


class _Donated:
    """The fixed buffers of a donating engine's decode state, and its
    captured steps.  ``top``: the state's top-level tensors (``pos``,
    ``tok``, the page table, an audio stack's ``memory``); ``sets``: one
    ``{"blocks", "tail"}`` set, or two for a recurrent stack (sharing the
    attention blocks), of which ``parity`` is the current one; ``graphs``:
    parity -> (CUDA graph, its logits, the launches it replays);
    ``stages``: stage -> shape -> :class:`_StageGraph` for the speculative
    stages, whose inputs are copied into ``bufs`` (the verify chunk per T,
    the rollbacks' positions and rows).  Every graph of the state shares
    ``pool``: a graph's temporaries are dead between its replays and each
    static output is copied out right after its replay, so one graph may
    reuse another's temporaries."""

    def __init__(self, state, cfg):
        self.top = {k: v for k, v in state.items()
                    if isinstance(v, torch.Tensor)}
        first = {k: state[k] for k in ("blocks", "tail") if k in state}
        other = fresh_rec_state(state, cfg, like=torch.zeros_like)
        self.sets = [first] if other is None else [first, other]
        self.parity = 0
        self.warm = False
        self.params = None
        self.graphs: Dict[int, Any] = {}
        self.capture_ms: Optional[float] = None
        self.pool_bytes: Optional[int] = None
        self.eager_ticks = 0        # fixed-buffer ticks run op by op
        self.replays = 0
        self.pool = None
        self.bufs: Dict[Any, torch.Tensor] = {}
        self.stages: Dict[str, Dict[int, _StageGraph]] = {}

    def next(self, p: int) -> int:
        return (p + 1) % len(self.sets)

    def adopt(self, state, stage: str = "generate") -> None:
        """Check that ``state`` holds this engine's K/V and current
        recurrent leaves (``ValueError`` otherwise) and copy every
        top-level leaf a driver rebound into its fixed buffer."""
        cur = self.sets[self.parity]
        for part, mine in cur.items():
            given = state.get(part, ())
            if len(given) != len(mine) or any(
                    g.keys() != m.keys() or any(g[k] is not m[k] for k in m)
                    for g, m in zip(given, mine)):
                raise ValueError(
                    f"{stage}: the state's {part} are not this engine's "
                    f"own buffers; a donated state is consumed by {stage} "
                    "(use the state it returned) and only "
                    "init_decode_state makes a new one")
        for name, buf in self.top.items():
            t = state.get(name)
            if not isinstance(t, torch.Tensor) or t.shape != buf.shape:
                raise ValueError(
                    f"{stage}: the state's {name!r} is missing or not of "
                    f"shape {tuple(buf.shape)}")
            if t is not buf:
                buf.copy_(t)

    def current(self) -> Dict[str, Any]:
        """The state's leaves at the current parity."""
        return {**self.top, **self.sets[self.parity]}

    def fill(self, key, value, dtype) -> torch.Tensor:
        """The fixed buffer ``key`` (made at the first call, of
        ``value``'s shape) with ``value``, host or device data, copied in;
        a capture reads the buffer, so a replay sees the new values."""
        value = torch.as_tensor(value)
        buf = self.bufs.get(key)
        if buf is None:
            buf = self.bufs[key] = torch.empty(
                value.shape, dtype=dtype, device=self.top["pos"].device)
        elif buf.shape != value.shape:
            raise ValueError(f"{key[0]}: shape {tuple(value.shape)}, the "
                             f"buffer's is {tuple(buf.shape)}")
        buf.copy_(value)
        return buf

    def stage(self, name: str, key: int) -> _StageGraph:
        return self.stages.setdefault(name, {}).setdefault(key,
                                                           _StageGraph())

    def reads(self, params) -> None:
        """Drop the graphs that read other parameters than ``params``
        (``generate``'s and ``verify``'s): the next call recaptures."""
        if self.params is not params:
            self.graphs = {}
            for rec in self.stages.get("verify", {}).values():
                rec.graph = rec.out = None
            self.params = params


class TransprecisionEngine:
    """The three-stage engine for one (model cfg, transprecision policy).

    The engine owns no request/queue state — drivers do.  ``weight_policy``
    is the policy the served weights were quantized under (drivers hoist
    it and serve through ``policy`` with its weight roles cleared); the
    energy accountant prices weight storage and MACs by its roles.  It
    defaults to ``policy``.  ``attn_impl`` plugs a custom decode attention
    (e.g. the KV-sharded distributed path) into ``generate``.  ``donate``
    (None: on for a CUDA device, off on the CPU and under a sharded plug)
    makes ``generate`` consume its state and, on the card, replay one
    captured CUDA graph a tick (the module docstring); ``donate=False``
    keeps the eager step, for debugging.  The resolved flag is
    ``self.donate``; clearing it serves eagerly from then on."""

    def __init__(self, cfg, policy: TCPolicy, max_batch: int, max_len: int,
                 *, num_pages: Optional[int] = None, attn_impl=None,
                 device="cuda", tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 stage_prefix: str = "", faults=None, retry=None,
                 weight_policy: Optional[TCPolicy] = None,
                 donate: Optional[bool] = None):
        self.cfg = cfg
        self.policy = get_policy(policy)
        self.weight_policy = (self.policy if weight_policy is None
                              else get_policy(weight_policy))
        self.paged = check_layout(self.policy)
        self.num_pages = num_pages
        self.attn_impl = attn_impl
        # a sharded plug's rank: its decode state holds the rank's slice
        self.kv_shard = getattr(attn_impl, "shard", None)
        if self.kv_shard is not None:       # its refusals, before any state
            init_cache(cfg, max_batch, max_len, policy=self.policy,
                       num_pages=num_pages, device="meta",
                       kv_shard=self.kv_shard)
        # paged: prompts prefill through the ring datapath at bucket width
        # and insert scatters the rows into pool pages
        self._prefill_policy = (dataclasses.replace(
            self.policy, kv_layout="ring", name=self.policy.name + "+prefix")
            if self.paged else self.policy)
        self.device = resolve_device(device)
        if donate and self.kv_shard is not None:
            raise NotImplementedError(
                "donate=True with a sharded decode attention: its "
                "collectives cannot be captured in a CUDA graph; pass "
                "donate=None (off under a shard) or False")
        # the reference's rule: donate wherever the backend is not the CPU
        self.donate = (self.device.type == "cuda" and self.kv_shard is None
                       if donate is None else bool(donate))
        self._donated: Optional[_Donated] = None
        self.tracer = tracer
        self.metrics = metrics
        self.stage_prefix = stage_prefix
        self.max_batch, self.max_len = max_batch, max_len
        # bucketed (right-padded) prefill only for decoder-only attention
        # stacks without a sliding window, MoE, vision or audio inputs
        # (the reference's rule); the others keep exact-length prefill
        self.bucketed = (all(bt == "attn" for bt in cfg.block_types)
                         and not cfg.window
                         and cfg.family not in ("moe", "audio", "vlm"))
        # chaos hardening (both None = a plain call): a FaultInjector whose
        # on_stage hook runs before every stage, and a RetryPolicy for
        # transient stage failures (serve/faults.py)
        self.faults = faults
        self.retry = retry
        # per stage name: the always-on call counter ("stage.<name>.calls",
        # the energy model's live multiplier) and the first call's
        # (fn, abstract args), from which the accountant counts the stage
        self._call_counters: Dict[str, Any] = {}
        self.stage_specs: Dict[str, Any] = {}

    # ---- observability ----
    def _staged(self, stage: str, fn, *args, spec_fn=None):
        """Run one engine stage with paired dispatch / device-complete
        stamps; a plain call with no enabled tracer.  ``stage_specs``
        records ``spec_fn`` (default ``fn``): the eager function the
        energy accountant can re-run on meta tensors."""
        name = self.stage_prefix + stage
        if self.metrics is not None:
            ctr = self._call_counters.get(name)
            if ctr is None:
                ctr = self._call_counters[name] = self.metrics.counter(
                    f"stage.{name}.calls")
            ctr.inc()
        if name not in self.stage_specs:
            self.stage_specs[name] = (_weak_method(spec_fn or fn, self),
                                      _abstract_args(args))
        tr = self.tracer
        if tr is None or not tr.enabled:
            return self._invoke(name, fn, args)
        t0 = perf_counter()
        with torch.profiler.record_function(name):
            with tr.span(name + ".dispatch", cat="engine"):
                out = self._invoke(name, fn, args)
        t1 = perf_counter()
        with tr.span(name + ".device", cat="engine"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        t2 = perf_counter()
        if self.metrics is not None:
            self.metrics.histogram(f"stage.{name}.dispatch_s").observe(
                t1 - t0)
            self.metrics.histogram(f"stage.{name}.device_s").observe(
                t2 - t1)
        return out

    def _invoke(self, name, fn, args):
        """One stage call behind the fault-injection and retry hooks (a
        plain call with neither armed).  Injection raises BEFORE ``fn``
        runs, so a failed attempt writes nothing; only exceptions flagged
        ``transient`` are retried, with bounded exponential backoff
        (``stage.retries`` / ``stage.<name>.retries`` counters;
        ``stage.retry_exhausted`` when the budget runs out and the failure
        propagates)."""
        faults, retry = self.faults, self.retry
        if faults is None and retry is None:
            return fn(*args)
        tries = 0
        while True:
            try:
                if faults is not None:
                    faults.on_stage(name)
                return fn(*args)
            except Exception as e:
                transient = bool(getattr(e, "transient", False))
                tries += 1
                if retry is None or not transient \
                        or tries >= retry.max_attempts:
                    if transient and retry is not None \
                            and self.metrics is not None:
                        self.metrics.counter("stage.retry_exhausted").inc()
                    raise
                if self.metrics is not None:
                    self.metrics.counter("stage.retries").inc()
                    self.metrics.counter(f"stage.{name}.retries").inc()
                sleep(retry.delay(tries - 1))

    # ---- stage: decode-state construction ----
    def init_decode_state(self) -> Dict[str, Any]:
        """Empty decode state for ``max_batch`` slots: the KV cache with
        per-slot ``pos`` plus the ``"tok"`` next-input leaf.  Paged engines
        with an explicit pool size get a zero page table (the driver owns
        it)."""
        state = init_cache(self.cfg, self.max_batch, self.max_len,
                           policy=self.policy, num_pages=self.num_pages,
                           device=self.device, kv_shard=self.kv_shard)
        state["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=self.device)
        state["tok"] = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                   device=self.device)
        if self.donate:         # this state's buffers become the engine's
            self._donated = _Donated(state, self.cfg)
        return state

    # ---- stage: prefill ----
    def bucket_for(self, s: int) -> int:
        """Prefill width for an ``s``-token prompt: the smallest power-of-
        two bucket (>= 16, <= max_len) that holds it; ``s`` itself where
        the engine is not bucketed."""
        if not self.bucketed:
            return s
        b = _MIN_BUCKET
        while b < s:
            b <<= 1
        return min(b, self.max_len)

    def prefill(self, params, tokens, lengths=None) -> Prefix:
        """Run a prompt batch: ``tokens`` (B, S) int, right-padded;
        ``lengths`` (B,) true prompt lengths (None = every row is exactly S
        tokens).  Returns a :data:`Prefix` with a bucket-width cache, or
        with a ``max_len``-wide one where the engine is not bucketed (the
        reference's prefix for those families: inserting it resets the
        slot's other rows, and paged, trash row 0, to their init
        values)."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b, s = tokens.shape
        if lengths is not None and not self.bucketed:
            raise ValueError(
                f"{self.cfg.name} prefills at exact length only "
                "(bucketed/padded prefill needs a decoder-only attention "
                "stack); pass lengths=None")
        plen = s if self.bucketed else self.max_len
        cfg, policy = self.cfg, self._prefill_policy

        def impl(p, t, l):      # keeps no reference to the engine
            logits, cache = prefill(p, {"tokens": t}, cfg, plen, policy,
                                    true_len=l)
            length = (l if l is not None else
                      torch.full((b,), s, dtype=torch.int32,
                                 device=t.device))
            return {"logits": logits, "cache": cache, "length": length}

        if lengths is not None:
            lengths = torch.as_tensor(lengths, device=self.device).to(
                torch.int32)
        return self._staged("prefill", impl, params, tokens, lengths)

    # ---- stage: insert ----
    def insert(self, prefix: Prefix, state, slot: int, row: int = 0,
               dst_rows=None):
        """Copy prefix row ``row`` into decode-state slot ``slot``, in
        place, and set ``pos[slot]`` to the prompt length.  Ring: its
        bucket-width K/V rows land at ring rows [0, bucket) (a window
        prefill's ring is the state's width: row pos mod W); an SSM or
        recurrent row's state and ``conv``, and an audio row's cross K/V,
        replace the slot's.  Paged: the K/V rows scatter to the
        ``dst_rows`` flat pool rows ((N,) int, N <= bucket, padded with
        trash row 0).  A rank-local state keeps the K/V rows the rank owns
        and its slice of the recurrent ``state``, ``conv`` and ``h``
        (``blocks`` and ``tail`` alike, ``rank_split``'s dims) and the rest
        whole."""
        if dst_rows is not None:
            dst_rows = torch.as_tensor(dst_rows, device=self.device).to(
                torch.int64)
        return self._staged("insert", self._insert_impl, state,
                            prefix["cache"], prefix["length"], slot, row,
                            dst_rows)

    def _insert_impl(self, state, pcache, length, slot, row, dst_rows):
        # a rank-local state (``kv_shard``) holds ring rows [lo, lo + Wl)
        # of each slot, or pool rows [lo, lo + Rl), and its 1/world of each
        # recurrent leaf's split dim; rank 0 of 1 holds all.  An audio
        # block's cross K/V is whole per slot on every rank
        rank = 0 if self.kv_shard is None else self.kv_shard.rank
        for part, lead in (("blocks", (slice(None),)), ("tail", ())):
            for dst, src in zip(state.get(part, ()), pcache.get(part, ())):
                for name, d in dst.items():
                    s = src[name][lead + (row,)]   # ([P,] width, ...)
                    if name in RECURRENT_SPLIT:    # its dim in s: one less
                        dim = len(lead) + RECURRENT_SPLIT[name][0]
                        n = d.shape[dim]
                        d[lead + (slot,)] = s.narrow(dim - 1, rank * n, n)
                    elif name not in KV_LEAVES:
                        d[lead + (slot,)] = s
                    elif dst_rows is None:
                        w = d.shape[len(lead) + 1]
                        lo = rank * w
                        n = min(s.shape[len(lead)] - lo, w)
                        if n > 0:
                            d[lead + (slot, slice(0, n))] = \
                                s[lead + (slice(lo, lo + n),)]
                    else:
                        rows = dst_rows
                        s = s[lead + (slice(0, len(dst_rows)),)]
                        if self.kv_shard is not None:  # own rows only
                            r = d.shape[len(lead)]
                            rows = _local_rows(dst_rows, rank * r, r)
                            s = s[lead + (rows >= 0,)]
                            rows = rows[rows >= 0]
                        d[lead + (rows,)] = s      # ([P,] R, ...)
        state["pos"][slot] = length[row]
        return state

    # ---- stage: generate ----
    def _generate_impl(self, params, state):
        logits, state = decode_step(params, state, state["tok"], self.cfg,
                                    self.policy, attn_impl=self.attn_impl)
        state["tok"] = logits[..., : self.cfg.vocab].argmax(dim=-1).to(
            torch.int32)[:, None]
        return state, logits

    def _fixed_step(self, params, parity: int):
        """The donated tick on the fixed buffers: reads recurrent set
        ``parity`` and writes the next one, writes K/V rows in place and
        ``pos`` and ``tok`` into their buffers.  Returns the logits."""
        own = self._donated
        nxt = own.next(parity)
        cache = {**own.top, **own.sets[parity]}
        logits, cache = decode_step(
            params, cache, own.top["tok"], self.cfg, self.policy,
            attn_impl=self.attn_impl,
            rec_out=own.sets[nxt] if nxt != parity else None)
        own.top["pos"].copy_(cache["pos"])
        own.top["tok"].copy_(logits[..., : self.cfg.vocab].argmax(dim=-1)
                             .to(torch.int32)[:, None])
        return logits

    def _capture_graph(self, own: _Donated, fn):
        """Capture ``fn()`` as a CUDA graph in ``own``'s pool (capture
        records; nothing runs).  Returns (graph, fn's output, the kernel
        launches the capture counted, which are taken back out of
        ``LAUNCHES`` and added on each replay).  Raises if the capture
        fails."""
        if own.pool is None:
            own.pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        before = dict(_build.LAUNCHES)
        with torch.cuda.stream(_capture_stream(self.device)):
            graph.capture_begin(pool=own.pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                _build.LAUNCHES.update(before)
                raise
            graph.capture_end()
        launched = {k: n - before[k]
                    for k, n in _build.LAUNCHES.items() if n != before[k]}
        _build.LAUNCHES.update(before)
        return graph, out, launched

    def _capture(self, params, own: _Donated) -> None:
        """Capture the fixed-buffer step of every parity as CUDA graphs in
        the state's pool.  Raises if a capture fails."""
        torch.cuda.synchronize(self.device)
        reserved0 = torch.cuda.memory_reserved(self.device)
        t0 = perf_counter()
        own.reads(params)
        own.graphs = {}
        for p in sorted(range(len(own.sets)),
                        key=lambda q: q != own.parity):
            try:
                own.graphs[p] = self._capture_graph(
                    own, lambda: self._fixed_step(params, p))
            except BaseException:
                own.graphs = {}
                raise
        torch.cuda.synchronize(self.device)
        own.capture_ms = 1e3 * (perf_counter() - t0)
        own.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved0

    def _run_stage(self, own: _Donated, stage: str, key: int, fn,
                   params=None):
        """``fn()`` (a speculative stage on the fixed buffers) the donated
        way: eagerly on the CPU; on the card eagerly on the capture stream
        at the first call of (``stage``, ``key``), captured at the second
        and replayed from then on (recaptured where ``params``, which the
        graph reads, is another object).  Returns ``fn``'s output, copied
        out of a replayed graph."""
        rec = own.stage(stage, key)
        if self.device.type != "cuda":
            rec.eager += 1
            return fn()
        with torch.cuda.device(self.device):
            if rec.eager == 0:
                out = self._on_capture_stream(fn)
                rec.eager += 1
                return out
            if params is not None:
                own.reads(params)
            if rec.graph is None:
                with _CAPTURE_LOCK:     # one capture at a time
                    torch.cuda.synchronize(self.device)
                    reserved0 = torch.cuda.memory_reserved(self.device)
                    t0 = perf_counter()
                    rec.graph, rec.out, rec.launched = self._capture_graph(
                        own, fn)
                    torch.cuda.synchronize(self.device)
                    rec.capture_ms = 1e3 * (perf_counter() - t0)
                    rec.pool_bytes = (torch.cuda.memory_reserved(self.device)
                                      - reserved0)
            rec.graph.replay()
            rec.replays += 1
            for k, n in rec.launched.items():
                _build.LAUNCHES[k] += n
            return None if rec.out is None else rec.out.clone()

    def _on_capture_stream(self, fn):
        """``fn()`` run eagerly on the capture stream, ordered after the
        current stream's work and before its later work: a stage's first
        call there loads its kernels and gives cuBLAS its workspace on the
        stream the capture uses."""
        cur = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        with _CAPTURE_LOCK:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = fn()
            cur.wait_stream(side)
        if out is not None:             # read on this stream from here
            out.record_stream(cur)
        return out

    def _generate_donated(self, params, state):
        own = self._own("generate")
        own.adopt(state)
        p = own.parity
        if self.device.type != "cuda":
            logits = self._fixed_step(params, p)
            own.eager_ticks += 1
        else:
            with torch.cuda.device(self.device):
                if not own.warm:
                    logits = self._on_capture_stream(
                        lambda: self._fixed_step(params, p))
                    own.warm = True
                    own.eager_ticks += 1
                else:
                    if not own.graphs or own.params is not params:
                        with _CAPTURE_LOCK:     # one capture at a time
                            self._capture(params, own)
                    graph, logits, launched = own.graphs[p]
                    graph.replay()
                    own.replays += 1
                    for k, n in launched.items():
                        _build.LAUNCHES[k] += n
        own.parity = own.next(p)
        state.update(own.current())
        return state, logits.clone()

    def generate(self, params, state):
        """One decode tick for every slot: feeds ``state["tok"]``, writes
        each slot's K/V row at its own position, advances ``pos`` and
        ``tok``.  Returns ``(state, logits (B, vocab_pad))``.  A donating
        engine consumes ``state`` (the module docstring)."""
        if self.donate:
            return self._staged("generate", self._generate_donated, params,
                                state, spec_fn=self._generate_impl)
        return self._staged("generate", self._generate_impl, params, state)

    def graph_stats(self) -> Dict[str, Any]:
        """The donated step since the last ``init_decode_state``: its ticks
        run eagerly and its replays, the capture's ms, the graph pool's
        bytes (reserved by the capture) and the kernel launches each
        replay counts, per parity (None where nothing was captured).  Each
        speculative stage that ran on the state adds a key of its own
        (``verify``, ``rollback_ring``, ``rollback_paged``): per shape
        (T, t or the scrub length) its ``eager_calls``, ``replays``,
        ``capture_ms``, ``pool_bytes`` and ``launches``."""
        own = self._donated
        if own is None:
            return {"eager_ticks": 0, "replays": 0, "capture_ms": None,
                    "pool_bytes": None, "launches": None}
        out = {"eager_ticks": own.eager_ticks, "replays": own.replays,
               "capture_ms": own.capture_ms, "pool_bytes": own.pool_bytes,
               "launches": ({p: dict(g[2]) for p, g in own.graphs.items()}
                            if own.graphs else None)}
        for stage, recs in own.stages.items():
            out[stage] = {k: r.stats() for k, r in sorted(recs.items())}
        return out

    def _own(self, stage: str) -> _Donated:
        if self._donated is None:
            raise ValueError(f"{stage}: a donating engine serves the state "
                             "of its own init_decode_state")
        return self._donated

    # ---- stage: verify (speculative rounds) ----
    def _verify_impl(self, params, state, chunk):
        logits, state = verify_step(params, state, chunk, self.cfg,
                                    self.policy)
        return state, logits

    def _verify_donated(self, params, state, chunk):
        own = self._own("verify")
        own.adopt(state, "verify")
        t = chunk.shape[1]
        buf = own.fill(("chunk", t), chunk, torch.int64)

        def step():         # pos + T lands in the fixed pos
            return verify_step(params, own.current(), buf, self.cfg,
                               self.policy, pos_out=own.top["pos"])[0]

        logits = self._run_stage(own, "verify", t, step, params)
        state.update(own.current())
        return state, logits

    def verify(self, params, state, chunk):
        """Score a (B, T) draft chunk in one target-precision pass
        (``models.serve_model.verify_step``): token t of slot b is scored
        and its K/V row written at position ``pos[b] + t``, in place.
        Returns ``(state, logits (B, T, vocab_pad))``; ``state["tok"]`` is
        left for the caller to set after acceptance.  A donating engine
        consumes ``state``, copies the chunk into a fixed (B, T) buffer
        and, on the card, replays a graph per T after one eager call."""
        if self.kv_shard is not None:
            raise NotImplementedError(
                "verify over a rank-local (KV-sequence-sharded) decode "
                "state: the chunk pass reads the whole cache")
        if self.donate:
            return self._staged("verify", self._verify_donated, params,
                                state, torch.as_tensor(chunk),
                                spec_fn=self._verify_impl)
        chunk = torch.as_tensor(chunk, device=self.device).to(torch.int64)
        return self._staged("verify", self._verify_impl, params, state,
                            chunk)

    # ---- stage: rollback ----
    def _rollback_ring_donated(self, state, new_pos, window_end, scrub_from,
                               t: int):
        own = self._own("rollback")
        own.adopt(state, "rollback")
        end = own.fill(("window_end", t), window_end, torch.int64)
        frm = own.fill(("scrub_from", t), scrub_from, torch.int64)
        new = own.fill(("new_pos",), new_pos, torch.int32)
        blocks, pos = own.sets[own.parity]["blocks"], own.top["pos"]

        def step():
            _scrub_ring(blocks, end, frm, t)
            pos.copy_(new)

        self._run_stage(own, "rollback_ring", t, step)
        state.update(own.current())
        return state

    def rollback_ring(self, state, new_pos, window_end, scrub_from, t: int):
        """:func:`rollback_ring_cache`, in place.  A donating engine copies
        the positions into fixed buffers and, on the card, replays a graph
        per t after one eager call."""
        if self.donate:
            return self._staged("rollback", self._rollback_ring_donated,
                                state, new_pos, window_end, scrub_from, t,
                                spec_fn=rollback_ring_cache)
        return self._staged("rollback", rollback_ring_cache, state, new_pos,
                            window_end, scrub_from, t)

    def _rollback_paged_donated(self, state, new_pos, scrub_rows):
        own = self._own("rollback")
        own.adopt(state, "rollback")
        n = len(scrub_rows)
        rows = own.fill(("scrub_rows", n), scrub_rows, torch.int64)
        new = own.fill(("new_pos",), new_pos, torch.int32)
        blocks, pos = own.sets[own.parity]["blocks"], own.top["pos"]

        def step():
            _scrub_pool(blocks, rows)
            pos.copy_(new)

        self._run_stage(own, "rollback_paged", n, step)
        state.update(own.current())
        return state

    def rollback_paged(self, state, new_pos, scrub_rows):
        """:func:`rollback_paged_cache`, in place.  A donating engine
        copies the positions and rows into fixed buffers and, on the
        card, replays a graph per scrub length after one eager call."""
        if self.donate:
            return self._staged("rollback", self._rollback_paged_donated,
                                state, new_pos, scrub_rows,
                                spec_fn=rollback_paged_cache)
        return self._staged("rollback", rollback_paged_cache, state,
                            new_pos, scrub_rows)
