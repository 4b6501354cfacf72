"""Batched serving engine: slot-based continuous batching over a TALU-style
transprecision model (port of ``repro.serve.engine``, ring and paged
layouts).

A fixed batch of B slots: finished sequences free their slot and the next
queued request is prefilled into it while other slots keep decoding.
``generate`` runs the whole batch with true per-slot positions; prompts
prefill in power-of-two buckets; sampling is greedy or temperature (per
request) from the engine's own numpy RNG; ``on_emit`` streams tokens.

Two KV layouts (``kv_layout``): ``ring`` reserves a dense max_len ring per
slot; ``paged`` runs a shared posit page pool + per-sequence page tables
(``serve/paged.py`` allocator, ``kernels/paged_kv.py`` device path), with
prefill K/V rows scattered straight into pool pages.  Admission reserves
each request's worst-case page demand (prompt + max_new), so growth
mid-decode never exhausts the pool; with ``page_overcommit`` the
reservation is waived and a dry pool evicts the newest sequence instead
(recompute-on-readmit, ``stats["evictions"]``).  Admission scans the whole
queue, so a blocked head never starves later entries.

Chaos hardening, all off by default (single ``is not None`` checks on the
hot path): ``faults`` (a ``FaultPlan`` or ``FaultInjector``,
``serve/faults.py``) schedules stage errors and delays, dry pools and
NaN-poisoned logits; ``retry`` (a ``RetryPolicy``) re-runs transient stage
failures; ``guard`` (True or a ``GuardConfig``) arms the numeric
quarantine with its precision-fallback re-decode (``serve/guard.py``).
``abort`` terminally releases a request from outside the decode loop
(the orchestrator's deadlines, cancellation and crash containment).

Weight quantization is hoisted: the policy's weight hook is a pure function
of each weight, so the engine applies it once at construction
(``models.lm.hoist_weight_quant``) and serves through the policy with its
weight roles cleared; the KV format is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.transprecision import BF16, TCPolicy, get_policy, kv_storage
from ..kernels import _build
from ..kernels.kv_cache import append_geometry, code_channels, split_geometry
from ..models import lm
from ..obs import MetricsRegistry, StatsView, Tracer
from .engine_api import TransprecisionEngine
from .faults import FaultInjector, FaultPlan, RetryPolicy
from .guard import GuardConfig, NumericGuard
from .paged import PageAllocator, SlotPages, pages_for

_KV_LEAF_NAMES = ("k", "v", "k_scale", "v_scale")


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    temperature: float = 0.0     # 0 => greedy
    seed: int = 0
    eos_id: Optional[int] = None
    # KV-cache storage override (f32|bf16|posit16|posit8|posit4); None
    # keeps the policy's own kv_format / legacy packed_kv resolution.
    kv_format: Optional[str] = None
    # KV-cache layout override (ring|paged); None keeps the policy's
    kv_layout: Optional[str] = None
    # paged layout: tokens per page (None keeps the policy's) and total
    # physical pages incl. the trash page (None = full reservation:
    # 1 + max_batch * ceil(max_len / page_size)).  Pages are allocated on
    # demand as sequences grow, but admission reserves each request's
    # worst case (prompt + max_new), so decode-time growth can never
    # exhaust the pool: requests queue until reservations free up.
    page_size: Optional[int] = None
    num_pages: Optional[int] = None
    # waive the worst-case reservation and admit on current demand only;
    # a pool that runs dry mid-decode evicts the newest-admitted sequence
    # and requeues it for recompute-on-readmit (stats["evictions"])
    page_overcommit: bool = False


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int
    max_new: int = 32
    # per-request sampling temperature; None inherits ServeConfig's
    temperature: Optional[float] = None
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None  # set when the request is rejected
    # lifecycle stamps (``time.perf_counter()``): submit, admit,
    # prefill_done, insert_done, first_token, finish.  Stamped with
    # ``setdefault``, so a readmission after a page-pool eviction keeps the
    # request's original stamps
    timing: Dict[str, float] = dataclasses.field(
        default_factory=dict, repr=False)
    # recompute-on-readmit state after a page-pool eviction: the tokens
    # (prompt + all-but-last emitted) the readmission prefills
    _resume: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False)


def check_kv_kernels(cfg: lm.ModelCfg, policy: TCPolicy,
                     max_len: int) -> None:
    """The contracts of the card's KV kernels for this model and KV format,
    checked when a CUDA engine is built, before any cache is written:
    K3's and K5's lane groups (``append_geometry``: the model's K/V rows in
    its dtype) and K4's and K6's split walk (``split_geometry``: rows of
    codes, query heads per KV head, q in the model's dtype).  Raises
    ``ValueError`` naming the contract (``TypeError`` for a dtype the
    kernels do not read).  A float KV cache runs no kernel."""
    spec = kv_storage(policy)
    if spec is None or not spec.is_posit:
        return
    name, hd = "ServingEngine", cfg.head_dim
    _build.check_fmt(name, spec.fmt)
    code_bytes = 1 if spec.fmt.bits <= 8 else 2
    append_geometry(name, hd, cfg.dtype)
    split_geometry(name, hd,
                   code_channels(hd, spec.fmt, spec.packed) * code_bytes,
                   cfg.n_heads // cfg.n_kv_heads, cfg.dtype, max_len)


def load_kv_kernels(policy: TCPolicy) -> None:
    """Build (at first use) and load the KV kernels' libraries on the
    calling thread when ``policy`` keeps posit KV codes: K3/K4, K5/K6 and
    K1 (the speculative verify's read).  An engine built for the card
    calls this in its constructor, so a first build's ``nvcc`` (tens of
    seconds) never runs inside a stage on an orchestrator's scheduler
    thread, under its watchdog."""
    spec = kv_storage(policy)
    if spec is not None and spec.is_posit:
        for name in ("kv_cache", "paged_kv", "posit_codec"):
            _build.lib(name)


class ServingEngine:
    def __init__(self, cfg: lm.ModelCfg, params, scfg: ServeConfig,
                 policy: TCPolicy = BF16, *, device="cuda",
                 tracer: Optional[Tracer] = None, faults=None,
                 retry: Optional[RetryPolicy] = None, guard=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.policy = get_policy(policy)
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = MetricsRegistry()
        if isinstance(faults, FaultPlan):
            faults = FaultInjector(faults, metrics=self.metrics)
        self.faults: Optional[FaultInjector] = faults
        if self.faults is not None and self.faults.metrics is None:
            self.faults.metrics = self.metrics
        self.retry = retry
        guard_cfg = (guard if isinstance(guard, GuardConfig)
                     else (GuardConfig() if guard else None))
        overrides = {}
        if scfg.kv_format is not None:
            overrides["kv_format"] = scfg.kv_format
        if scfg.kv_layout is not None:
            overrides["kv_layout"] = scfg.kv_layout
        if scfg.page_size is not None:
            overrides["kv_page_size"] = scfg.page_size
        if overrides:
            tag = "+".join(f"{k[3:]}_{v}" for k, v in overrides.items())
            self.policy = dataclasses.replace(
                self.policy, name=f"{self.policy.name}+{tag}", **overrides)
        if self.device.type == "cuda":
            check_kv_kernels(cfg, self.policy, scfg.max_len)
            load_kv_kernels(self.policy)
        params = _to_device(params, self.device)
        # the guard's rungs hoist their own weights from the raw parameters
        self.raw_params = params if guard_cfg is not None else None
        self.params = lm.hoist_weight_quant(params, self.policy)
        b, L = scfg.max_batch, scfg.max_len
        self.paged = self.policy.kv_layout == "paged"
        self.allocator = None
        if self.paged:
            ps = self.policy.kv_page_size
            self._pmax = pages_for(L, ps)
            self.num_pages = (scfg.num_pages if scfg.num_pages is not None
                              else 1 + b * self._pmax)
            self.allocator = PageAllocator(self.num_pages, ps,
                                           metrics=self.metrics,
                                           tracer=self.tracer,
                                           faults=self.faults)
            self.slot_pages = [SlotPages(ps) for _ in range(b)]
            # worst-case page reservations (admission control): pages a
            # slot may still grow into are committed but not yet allocated
            self._committed = 0
            self._slot_commit = [0] * b
            self._table = np.zeros((b, self._pmax), np.int32)
        self.engine = TransprecisionEngine(
            cfg, lm.weights_free(self.policy), b, L,
            num_pages=self.num_pages if self.paged else None,
            device=self.device, tracer=self.tracer, metrics=self.metrics,
            faults=self.faults, retry=self.retry, weight_policy=self.policy)
        self.guard: Optional[NumericGuard] = (
            NumericGuard(self, guard_cfg) if guard_cfg is not None else None)
        # paged: cache["page_table"] is one device tensor, updated in place
        # from the host mirror self._table
        self.cache = self.engine.init_decode_state()
        self.slot_pos = np.zeros(b, np.int64)         # valid tokens per slot
        self.slot_req: List[Optional[Request]] = [None] * b
        self.last_tok = np.zeros((b, 1), np.int32)
        # admission order per slot: a dry pool evicts the newest sequence
        self._admit_seq = np.zeros(b, np.int64)
        self._admit_counter = 0
        self._evicted: List[Request] = []   # awaiting readmission
        self.on_emit: Optional[Callable[[Request, List[int]], None]] = None
        self._rng = np.random.default_rng(scfg.seed)
        self.stats = StatsView(self.metrics, prefix="engine.")
        self.stats.bind_counters("prefills", "decode_steps", "tokens",
                                 "rejected", "evictions")
        self.stats.bind_gauges("peak_live_pages", "kv_cache_bytes")
        self.stats["kv_cache_bytes"] = self.kv_cache_bytes()

    # ---- cache footprint ----
    def _kv_bytes(self, pool_frac: float = 1.0, cache=None) -> int:
        """Bytes of the attention K/V leaves (codes + scales) of ``cache``
        (default: the engine's target cache); the paged pool's leaves
        scaled by an allocated-page fraction (another cache, such as the
        speculative engine's draft ring, is never scaled).  Leaves are
        summed in the reference's order (sorted names), scaled one by one,
        so the float result truncates alike."""
        paged = self.paged and cache is None
        total = 0.0
        for blk in (self.cache if cache is None else cache)["blocks"]:
            for name in sorted(blk):
                if name in _KV_LEAF_NAMES:
                    t = blk[name]
                    nbytes = t.numel() * t.element_size()
                    total += nbytes * pool_frac if paged else nbytes
        return int(total)

    def kv_cache_bytes(self) -> int:
        """Reserved device footprint of the attention K/V state."""
        return self._kv_bytes()

    def kv_cache_live_bytes(self) -> int:
        """Footprint counting only allocated pages for the paged layout
        (== reserved for ring, which preallocates everything)."""
        if not self.paged:
            return self._kv_bytes()
        return self._kv_bytes(self.allocator.live_pages / self.num_pages)

    def kv_cache_peak_live_bytes(self) -> int:
        """High-water live-page footprint over the served run (== reserved
        for ring)."""
        if not self.paged:
            return self._kv_bytes()
        return self._kv_bytes(self.stats["peak_live_pages"] / self.num_pages)

    # ---- slot management ----
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def free_slots(self) -> int:
        return sum(r is None for r in self.slot_req)

    def _sync_table(self) -> None:
        """Mirror the host page table into the device tensor, in place (one
        stable address)."""
        self.cache["page_table"].copy_(torch.from_numpy(self._table))

    def _admission_tokens(self, req: Request) -> np.ndarray:
        """Tokens a (re)admission must prefill: the prompt or, after a
        page-pool eviction, the prompt plus all-but-last emitted token (the
        last one is the readmitted slot's next decode input)."""
        if req._resume is not None:
            return req._resume
        return np.asarray(req.prompt)

    def _worst_pages(self, req: Request) -> int:
        """Worst-case page demand of ``req``: its admission tokens plus the
        remaining max_new budget, capped by max_len and floored at prompt +
        1 (admission always allocates the page of the first decode
        append, even when max_new is 0)."""
        s = len(self._admission_tokens(req))
        remaining = max(req.max_new - len(req.out_tokens), 0)
        tokens = min(max(s + remaining, s + 1), self.scfg.max_len)
        return pages_for(tokens, self.allocator.page_size)

    def _reserve(self, req: Request) -> Optional[Tuple[int, Any]]:
        """Host-side half of admission: claim a slot and (paged) the
        prompt's pool pages.  Returns (slot, prompt dst rows or None), or
        None when no slot / pages are free right now."""
        n = len(self._admission_tokens(req))
        if n >= self.scfg.max_len:
            raise ValueError(f"prompt length {n} >= max_len "
                             f"{self.scfg.max_len}; reject before admission")
        slot = self._free_slot()
        if slot is None:
            return None
        dst_rows = None
        if self.paged:
            ps = self.allocator.page_size
            worst = 0       # overcommit: admit on current demand
            if not self.scfg.page_overcommit:
                worst = self._worst_pages(req)
                if self._committed + worst > self.num_pages - 1:
                    return None
            pages = self.allocator.alloc(pages_for(n + 1, ps))
            if pages is None:
                return None
            self._committed += worst
            self._slot_commit[slot] = worst
            self.slot_pages[slot] = sp = SlotPages(ps, pages)
            self._table[slot] = sp.table_row(self._pmax)
            self._sync_table()
            t = np.arange(n)
            dst_rows = np.asarray(pages, np.int64)[t // ps] * ps + t % ps
        self.slot_req[slot] = req
        self.slot_pos[slot] = n
        self._admit_counter += 1
        self._admit_seq[slot] = self._admit_counter
        return slot, dst_rows

    def _install(self, req: Request, slot: int, dst_rows, prefix,
                 row: int) -> None:
        """Device + bookkeeping half of admission: insert prefix row ``row``
        into ``slot``, sample the first token, finish prompt-only
        requests."""
        dst = None
        if dst_rows is not None:
            # pad to the prefix bucket width; padding rows land on trash
            # row 0
            dst = np.zeros(prefix["cache"]["blocks"][0]["k"].shape[2],
                           np.int64)
            dst[:len(dst_rows)] = dst_rows
        self.cache = self.engine.insert(prefix, self.cache, slot, row,
                                        dst_rows=dst)
        req.timing.setdefault("insert_done", time.perf_counter())
        self.stats["prefills"] += 1
        if req._resume is not None:
            # recompute-on-readmit: the stream already holds every token
            # up to out_tokens[-1]; decode continues from it
            req._resume = None
            self.last_tok[slot, 0] = req.out_tokens[-1]
            return
        logits = _host(prefix["logits"][row])
        tok = int(self._sample(logits[None], [self._req_temp(req)])[0])
        self.last_tok[slot, 0] = tok
        self._emit(req, [tok])
        if (len(req.out_tokens) >= req.max_new
                or req.out_tokens[-1] == self.scfg.eos_id):
            req.done = True
            self._free_request_slot(slot)

    def add_request(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if no slot (or, paged,
        not enough free pages) is free."""
        return all(self.add_requests([req]))

    def add_requests(self, reqs: Sequence[Request]) -> List[bool]:
        """Batched admission: reserve a slot per request (FIFO, stopping at
        the first that does not fit), run ONE bucketed prefill over every
        admitted prompt and insert per row."""
        toks = [self._admission_tokens(r) for r in reqs]
        admitted = []
        ok = [False] * len(reqs)
        for j, req in enumerate(reqs):
            r = self._reserve(req)
            if r is None:
                break
            admitted.append((req, r[0], r[1], j))
            ok[j] = True
        if not admitted:
            return ok
        now = time.perf_counter()
        for req, _, _, _ in admitted:
            sub = req.timing.setdefault("submit", now)
            if "admit" not in req.timing:   # a readmit is no queue wait
                req.timing["admit"] = now
                if self.tracer.enabled and now > sub:
                    self.tracer.record("queue.wait", sub, now, cat="queue",
                                       uid=req.uid)
        bucket = self.engine.bucket_for(max(len(toks[j])
                                            for _, _, _, j in admitted))
        pad = np.zeros((len(admitted), bucket), np.int64)
        lens = np.zeros(len(admitted), np.int32)
        for row, (_, _, _, j) in enumerate(admitted):
            pad[row, :len(toks[j])] = toks[j]
            lens[row] = len(toks[j])
        prefix = self.engine.prefill(self.params, torch.from_numpy(pad),
                                     torch.from_numpy(lens))
        done = time.perf_counter()
        for row, (req, slot, dst_rows, _) in enumerate(admitted):
            req.timing.setdefault("prefill_done", done)
            self._install(req, slot, dst_rows, prefix, row)
        return ok

    def _free_request_slot(self, slot: int) -> None:
        """Release a slot (paged: return its pages to the allocator, point
        the slot at the trash page and park its write position at 0)."""
        req = self.slot_req[slot]
        if req is not None and req.done:
            req.timing.setdefault("finish", time.perf_counter())
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0
        if self.paged:
            self._committed -= self._slot_commit[slot]
            self._slot_commit[slot] = 0
            self.allocator.free(self.slot_pages[slot].pages)
            self.slot_pages[slot] = SlotPages(self.allocator.page_size)
            self._table[slot] = 0
            self._sync_table()
            self.cache["pos"][slot] = 0

    def _evict_newest(self) -> Optional[int]:
        """Dry pool under ``page_overcommit``: evict the most recently
        admitted active sequence (free its slot and pages, keep its
        progress for recompute-on-readmit, requeue it).  Returns the freed
        slot, or None with nothing left to evict."""
        cands = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not cands:
            return None
        slot = max(cands, key=lambda i: self._admit_seq[i])
        req = self.slot_req[slot]
        req._resume = np.concatenate(
            [np.asarray(req.prompt, np.int64),
             np.asarray(req.out_tokens[:-1], np.int64)])
        self._free_request_slot(slot)
        self._evicted.append(req)
        self.stats["evictions"] += 1
        return slot

    def _grow_pages(self, active: List[int],
                    target: Callable[[int], int]) -> None:
        """Allocate pages so each active slot i can write rows up to
        ``target(i) - 1`` this tick.  Under ``page_overcommit`` a dry pool
        evicts the newest sequence instead of raising (possibly the growing
        one: its ``slot_req`` goes None)."""
        grew = False
        for i in active:
            while self.slot_req[i] is not None:
                need = self.slot_pages[i].pages_needed(int(target(i)))
                if not need:
                    break
                pages = self.allocator.alloc(need)
                if pages is not None:
                    self.slot_pages[i].pages.extend(pages)
                    self._table[i] = self.slot_pages[i].table_row(self._pmax)
                    grew = True
                    break
                if not self.scfg.page_overcommit:
                    raise RuntimeError(
                        "paged KV pool exhausted mid-decode: the admission "
                        "reservation invariant was violated")
                if self._evict_newest() is None:
                    raise RuntimeError("paged KV pool exhausted with no "
                                       "sequence left to evict")
        if grew:
            self._sync_table()
        self.stats["peak_live_pages"] = max(
            self.stats["peak_live_pages"], self.allocator.live_pages)

    def _req_temp(self, req: Request) -> float:
        return (self.scfg.temperature if req.temperature is None
                else req.temperature)

    def _sample(self, logits: np.ndarray,
                temps: Optional[np.ndarray] = None) -> np.ndarray:
        """Sample next tokens row-wise: rows at temperature <= 0 are greedy,
        the rest softmax samples at their own temperature."""
        logits = logits[..., : self.cfg.vocab]
        greedy = logits.argmax(-1)
        if temps is None:
            temps = np.full(greedy.shape, self.scfg.temperature)
        temps = np.broadcast_to(np.asarray(temps, np.float32), greedy.shape)
        hot = temps > 0
        if not hot.any():
            return greedy
        t = np.where(hot, temps, 1.0)[..., None]
        p = torch.softmax(torch.from_numpy(logits / t), dim=-1).numpy()
        c = np.cumsum(p, -1)
        u = self._rng.random(c.shape[:-1] + (1,))
        sampled = (c < u).sum(-1)
        return np.where(hot, sampled, greedy)

    def _emit(self, req: Request, toks: List[int]) -> None:
        if toks:
            req.timing.setdefault("first_token", time.perf_counter())
        req.out_tokens.extend(toks)
        self.stats["tokens"] += len(toks)
        if self.on_emit is not None:
            self.on_emit(req, toks)

    # ---- one decode tick for the whole batch ----
    def step(self):
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        if self.paged:
            # every active slot needs a page for the row this tick writes
            self._grow_pages(active, lambda i: self.slot_pos[i] + 1)
            active = [i for i in active if self.slot_req[i] is not None]
            if not active:
                return
        self.cache["tok"] = torch.from_numpy(self.last_tok).to(self.device)
        # guard-armed: the pre-round pos and tok (generate rebinds both on
        # the dict and writes K/V rows in place), for a fallback re-decode
        prev = dict(self.cache) if self.guard is not None else None
        self.cache, logits = self.engine.generate(self.params, self.cache)
        logits = _host(logits)
        if self.faults is not None or self.guard is not None:
            logits = np.array(logits, copy=True)   # writable host copy
            poisons = {}
            if self.faults is not None:
                poisons = self.faults.poison_round(
                    {i: self.slot_req[i].uid for i in active})
                for i in poisons:
                    logits[i] = np.nan
            if self.guard is not None:
                self.guard.check_round(prev, logits, active, poisons)
                # ladder-exhausted requests terminated inside the guard:
                # reclaim their slot + pages, drop them from this round
                for i in active:
                    r = self.slot_req[i]
                    if r is not None and r.done:
                        self._free_request_slot(i)
                active = [i for i in active
                          if self.slot_req[i] is not None]
        temps = np.asarray([0.0 if r is None else self._req_temp(r)
                            for r in self.slot_req], np.float32)
        with self.tracer.span("host.sample"):
            toks = self._sample(logits, temps)
        self.stats["decode_steps"] += 1
        for i in active:
            req = self.slot_req[i]
            tok = int(toks[i])
            self.last_tok[i, 0] = tok
            self.slot_pos[i] += 1
            self._emit(req, [tok])
            eos = self.scfg.eos_id
            if (len(req.out_tokens) >= req.max_new
                    or (eos is not None and tok == eos)
                    or self.slot_pos[i] >= self.scfg.max_len - 1):
                req.done = True
                self._free_request_slot(i)

    def abort(self, req: Request, error: Optional[str] = None) -> None:
        """Terminally release ``req`` from outside the decode loop
        (deadline expiry, cancellation, crash containment): free its slot
        and pages if it is active, drop it from the eviction requeue, and
        mark it done.  Idempotent; runs on the thread driving the engine
        (the orchestrator's scheduler thread)."""
        req.done = True
        if error is not None and req.error is None:
            req.error = error
        for i, r in enumerate(self.slot_req):
            if r is req:
                self._free_request_slot(i)   # stamps finish (req.done)
                return
        if req in self._evicted:
            self._evicted.remove(req)
        req.timing.setdefault("finish", time.perf_counter())

    def _reject_reason(self, req: Request) -> Optional[str]:
        """Why ``req`` can never be admitted (None: admissible once a slot
        and pages free up)."""
        n = len(self._admission_tokens(req))
        if n >= self.scfg.max_len:
            return f"prompt length {n} >= max_len {self.scfg.max_len}"
        if self.paged:
            if self.scfg.page_overcommit:
                if pages_for(n + 1, self.allocator.page_size) \
                        > self.num_pages - 1:
                    return ("prompt alone needs more pages than the pool "
                            f"holds ({self.num_pages - 1} allocatable)")
            elif self._worst_pages(req) > self.num_pages - 1:
                return ("request worst case needs more pages than the pool "
                        f"holds ({self.num_pages - 1} allocatable)")
        return None

    def _admit(self, queue: List[Request]) -> None:
        """Admit every currently admissible queued request, scanning past
        blocked entries (no head-of-line blocking; earlier entries get
        first pick) and rejecting those that can never fit."""
        i = 0
        while i < len(queue):
            req = queue[i]
            reject = self._reject_reason(req)
            if reject is not None:
                req.done = True
                req.error = reject
                now = time.perf_counter()
                req.timing.setdefault("submit", now)
                req.timing.setdefault("finish", now)
                self.stats["rejected"] += 1
                queue.pop(i)
                continue
            if self.add_request(req):
                queue.pop(i)
                continue
            i += 1

    def serve(self, requests: List[Request], max_ticks: int = 10_000
              ) -> Dict[str, Any]:
        """Run to completion with continuous batching."""
        queue = list(requests)
        t0 = time.perf_counter()
        for r in queue:
            r.timing.setdefault("submit", t0)
        ticks = 0
        while (queue or self._evicted
               or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            if self._evicted:   # evicted sequences readmit first (oldest)
                queue[0:0] = self._evicted
                self._evicted.clear()
            with self.tracer.span("serve.admit"):
                self._admit(queue)
            with self.tracer.span("serve.step"):
                self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        # live bytes at drain are 0 by construction (every finished request
        # returns its pages); the peak is the figure that counts
        return {"wall_s": dt, **self.stats,
                "kv_peak_live_bytes": self.kv_cache_peak_live_bytes(),
                "tok_per_s": self.stats["tokens"] / max(dt, 1e-9)}


def _host(t: torch.Tensor) -> np.ndarray:
    """Device logits -> float32 numpy (bf16 widens exactly)."""
    return t.detach().to(torch.float32).cpu().numpy()


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
