"""Serving-engine API: three stages over one shared decode state (port of
``repro.serve.engine_api``, ring and paged layouts).

    prefill(params, tokens, lengths) -> Prefix
    insert(prefix, decode_state, slot) -> decode_state
    generate(params, decode_state)    -> (decode_state, logits)

* **Bucketed prefill.**  Prompts are right-padded to a power-of-two bucket
  and prefilled at bucket width with per-row true lengths; padded keys are
  causally masked to exact-zero contributions.
* **Prefix = bucket-width cache.**  ``prefill`` returns a ``Prefix`` whose
  cache leaves are (B, bucket, ...) ring rows; ``insert`` copies one row's
  prefix into rows [0, bucket) of a slot's ring IN PLACE.  Paged engines
  prefill through a ring copy of the policy at bucket width (the same
  codec as the pool) and ``insert`` scatters the prefix rows straight to
  the flat pool rows ``dst_rows``; no max_len ring is ever built.
* **generate** is one decode tick for the whole batch with per-slot
  positions; it writes K/V rows in place and advances ``state["tok"]`` to
  the greedy argmax per slot on the device.
* **verify** scores a (B, T) draft chunk in one target-precision pass and
  **rollback_ring** / **rollback_paged** rewind the rows a round rejected
  (the stages ``serve/speculative.py`` drives).

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

Chaos hardening (``serve/faults.py``): with a ``faults`` injector every
stage call first runs its ``on_stage`` hook, which may sleep (an injected
straggler) or raise; a ``retry`` policy re-runs stages whose exception is
flagged ``transient``.  The hook runs BEFORE the stage's function: the
stages write the decode state in place, so a failed attempt must not have
started writing K/V rows.
"""
from __future__ import annotations

import dataclasses
from time import perf_counter, sleep
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.transprecision import TCPolicy, get_policy
from ..models.serve_model import (check_layout, decode_step, init_cache,
                                  prefill, verify_step)
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
    end = torch.clamp(torch.as_tensor(window_end, device=dev).long(), min=t)
    frm = torch.as_tensor(scrub_from, device=dev).long()
    rows = end[:, None] - t + torch.arange(t, device=dev)[None, :]  # (B, t)
    keep = rows < frm[:, None]
    slot = torch.arange(rows.shape[0], device=dev)[:, None].expand_as(rows)
    # the reference's scatter form: every window row is rewritten, kept
    # ones with their own value (no host sync, no data-dependent shape; a
    # row appears once per slot)
    for blk in cache["blocks"]:              # K/V leaves (P, B, W, ...)
        for name, leaf in blk.items():
            m = keep.reshape(keep.shape + (1,) * (leaf.ndim - 3))
            leaf[:, slot, rows] = torch.where(
                m, leaf[:, slot, rows], 1.0 if name.endswith("_scale") else 0)
    cache["pos"] = torch.as_tensor(new_pos, device=dev).to(torch.int32,
                                                            copy=True)
    return cache


def rollback_paged_cache(cache, new_pos, scrub_rows):
    """Rewind a paged-layout cache, in place: set ``pos`` to ``new_pos``
    (B,) and reset the flat pool rows ``scrub_rows`` ((N,), padded with
    trash row 0, where writes are benign) to their init values.  Page-table
    truncation and allocator frees are the engine's host-side half."""
    dev = cache["pos"].device
    rows = torch.as_tensor(scrub_rows, device=dev).long()
    for blk in cache["blocks"]:              # K/V pool leaves (P, R, ...)
        for name, leaf in blk.items():
            leaf[:, rows] = 1.0 if name.endswith("_scale") else 0
    cache["pos"] = torch.as_tensor(new_pos, device=dev).to(torch.int32,
                                                            copy=True)
    return cache


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


class TransprecisionEngine:
    """The three-stage engine for one (model cfg, transprecision policy).

    The engine owns no request/queue state — drivers do.  ``weight_policy``
    is the policy the served weights were quantized under (drivers hoist
    it and serve through ``policy`` with its weight roles cleared); the
    energy accountant prices weight storage and MACs by its roles.  It
    defaults to ``policy``."""

    def __init__(self, cfg, policy: TCPolicy, max_batch: int, max_len: int,
                 *, num_pages: Optional[int] = None, device="cuda",
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 stage_prefix: str = "", faults=None, retry=None,
                 weight_policy: Optional[TCPolicy] = None):
        self.cfg = cfg
        self.policy = get_policy(policy)
        self.weight_policy = (self.policy if weight_policy is None
                              else get_policy(weight_policy))
        self.paged = check_layout(self.policy)
        self.num_pages = num_pages
        # paged: prompts prefill through the ring datapath at bucket width
        # and insert scatters the rows into pool pages
        self._prefill_policy = (dataclasses.replace(
            self.policy, kv_layout="ring", name=self.policy.name + "+prefix")
            if self.paged else self.policy)
        self.device = resolve_device(device)
        self.tracer = tracer
        self.metrics = metrics
        self.stage_prefix = stage_prefix
        self.max_batch, self.max_len = max_batch, max_len
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
    def _staged(self, stage: str, fn, *args):
        """Run one engine stage with paired dispatch / device-complete
        stamps; a plain call with no enabled tracer."""
        name = self.stage_prefix + stage
        if self.metrics is not None:
            ctr = self._call_counters.get(name)
            if ctr is None:
                ctr = self._call_counters[name] = self.metrics.counter(
                    f"stage.{name}.calls")
            ctr.inc()
        if name not in self.stage_specs:
            self.stage_specs[name] = (fn, _abstract_args(args))
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
                           device=self.device)
        state["pos"] = torch.zeros((self.max_batch,), dtype=torch.int32,
                                   device=self.device)
        state["tok"] = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                   device=self.device)
        return state

    # ---- stage: prefill ----
    def bucket_for(self, s: int) -> int:
        """Prefill width for an ``s``-token prompt: the smallest power-of-
        two bucket (>= 16, <= max_len) that holds it."""
        b = _MIN_BUCKET
        while b < s:
            b <<= 1
        return min(b, self.max_len)

    def prefill(self, params, tokens, lengths=None) -> Prefix:
        """Run a prompt batch: ``tokens`` (B, S) int, right-padded;
        ``lengths`` (B,) true prompt lengths (None = every row is exactly S
        tokens).  Returns a :data:`Prefix` with a bucket-width cache."""
        tokens = torch.as_tensor(tokens, device=self.device).to(torch.int64)
        b, s = tokens.shape

        def impl(p, t, l):
            logits, cache = prefill(p, {"tokens": t}, self.cfg, s,
                                    self._prefill_policy, true_len=l)
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
        bucket-width K/V rows land at ring rows [0, bucket).  Paged: they
        scatter to the ``dst_rows`` flat pool rows ((N,) int, N <= bucket,
        padded with trash row 0)."""
        if dst_rows is not None:
            dst_rows = torch.as_tensor(dst_rows, device=self.device).to(
                torch.int64)
        return self._staged("insert", self._insert_impl, state,
                            prefix["cache"], prefix["length"], slot, row,
                            dst_rows)

    def _insert_impl(self, state, pcache, length, slot, row, dst_rows):
        for dst, src in zip(state["blocks"], pcache["blocks"]):
            for name, d in dst.items():
                if dst_rows is None:
                    d[:, slot, :src[name].shape[2]] = src[name][:, row]
                else:       # (P, R, ...) <- (P, w, ...)
                    d[:, dst_rows] = src[name][:, row, :len(dst_rows)]
        state["pos"][slot] = length[row]
        return state

    # ---- stage: generate ----
    def _generate_impl(self, params, state):
        logits, state = decode_step(params, state, state["tok"], self.cfg,
                                    self.policy)
        state["tok"] = logits[..., : self.cfg.vocab].argmax(dim=-1).to(
            torch.int32)[:, None]
        return state, logits

    def generate(self, params, state):
        """One decode tick for every slot: feeds ``state["tok"]``, writes
        each slot's K/V row at its own position, advances ``pos`` and
        ``tok``.  Returns ``(state, logits (B, vocab_pad))``."""
        return self._staged("generate", self._generate_impl, params, state)

    # ---- stage: verify (speculative rounds) ----
    def _verify_impl(self, params, state, chunk):
        logits, state = verify_step(params, state, chunk, self.cfg,
                                    self.policy)
        return state, logits

    def verify(self, params, state, chunk):
        """Score a (B, T) draft chunk in one target-precision pass
        (``models.serve_model.verify_step``): token t of slot b is scored
        and its K/V row written at position ``pos[b] + t``, in place.
        Returns ``(state, logits (B, T, vocab_pad))``; ``state["tok"]`` is
        left for the caller to set after acceptance."""
        chunk = torch.as_tensor(chunk, device=self.device).to(torch.int64)
        return self._staged("verify", self._verify_impl, params, state,
                            chunk)

    # ---- stage: rollback ----
    def rollback_ring(self, state, new_pos, window_end, scrub_from, t: int):
        """:func:`rollback_ring_cache`, in place."""
        return self._staged("rollback", rollback_ring_cache, state, new_pos,
                            window_end, scrub_from, t)

    def rollback_paged(self, state, new_pos, scrub_rows):
        """:func:`rollback_paged_cache`, in place."""
        return self._staged("rollback", rollback_paged_cache, state,
                            new_pos, scrub_rows)
