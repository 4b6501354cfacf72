"""Transprecision self-speculative decoding: posit8 draft, target verify
(port of ``repro.serve.speculative``, ring and paged layouts).

Each round runs the SAME weights twice at two precisions: up to ``gamma``
cheap autoregressive *draft* steps under ``core.transprecision.
draft_policy`` (posit8 weights and a posit8 KV ring by default), then ONE
*verify* pass under the target policy that scores every chunk position at
once (the engine API's ``verify`` stage).  Drafts that match the target's
greedy choice commit; the first mismatch yields the target's own token as
a bonus, and the K/V rows written past the commit point are rolled back:

* ring: rewind the per-slot ``pos`` and reset the rolled-back rows to
  their init values, O(B·gamma) rows per round
  (``engine_api.rollback_ring_cache``);
* paged: truncate the slot's page list to the committed length, return
  orphaned pages to the allocator, reset the rolled-back pool rows.

Near the cache cap the chunk shrinks: a round's chunk is ``T = min(gamma +
1, min_i(max_len - pos_i))`` over the active slots, so slots decode up to
``max_len - 1`` as baseline does (admission needs one extra row: prompts
longer than ``max_len - 2`` are rejected).  The draft ring mirrors the
committed prefix; a round whose drafts are all accepted leaves it one row
short, and that slot's next round spends its first draft step catching up
(``_lag_tok``) and proposes one fewer token.

Weights: the engine hoists weight quantization once per policy, so the
draft keeps its own copy of the params quantized under the draft policy
(``draft_params``), beside the target's.  On the card both engines donate
their state: each draft step replays one captured CUDA graph, the
target's verify replays one graph per chunk length T, and each rollback
(the target's and the draft's) one graph per shape, each after one eager
call (``engine_api``'s docstring); the round's host arrays (the chunk,
the new positions, the rows to scrub) are copied into the graphs' fixed
buffers before each replay.

On CPU tensors the verify reads the cache through the same plain decode
and reduction as ``decode_step``, and a CPU product's rows do not depend
on how many rows share it (``models.common._einsum``), so greedy
speculative streams are token-identical to baseline greedy at float32.  On the card the decode
step reads through K4 / K6 and the verify through K1 + chunk attention:
another summation order, and at bf16 K4 / K6 round the attention output to
bf16 before the output projection where the verify keeps it in f32, so
near-tied logits may argmax differently.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..core.transprecision import BF16, TCPolicy, draft_policy
from ..models import lm
from ..models.serve_model import check_verifiable
from .engine import (Request, ServeConfig, ServingEngine, _to_device,
                     check_kv_kernels, load_kv_kernels)
from .engine_api import (TransprecisionEngine, rollback_paged_cache,
                         rollback_ring_cache)
from .paged import pages_for

__all__ = ["SpeculativeEngine", "rollback_ring_cache",
           "rollback_paged_cache"]


class SpeculativeEngine(ServingEngine):
    """Continuous-batching engine with self-speculative greedy decode.

    Per round (one ``step()``): up to gamma lockstep draft ``generate``
    steps on a draft-policy engine, one ``verify`` chunk on the target
    engine, per-slot acceptance, KV rollback.  Greedy-only: requests whose
    resolved temperature is > 0 are rejected at admission."""

    def __init__(self, cfg: lm.ModelCfg, params, scfg: ServeConfig,
                 policy: TCPolicy = BF16, *, gamma: int = 4,
                 draft_weights_fmt: str = "posit8_2",
                 draft_kv_format: str = "posit8", device="cuda",
                 tracer=None, faults=None, retry=None, guard=None):
        if gamma < 1:
            raise ValueError(f"gamma must be >= 1, got {gamma}")
        if guard:
            raise ValueError(
                "the numeric guard is a base-engine decode-round policy; "
                "speculative verify-round quarantine is a follow-on "
                "(pass guard=None)")
        check_verifiable(cfg)       # rollback is a row rewind
        super().__init__(cfg, params, scfg, policy, device=device,
                         tracer=tracer, faults=faults, retry=retry)
        self.gamma = gamma
        self._T = gamma + 1                     # max verify chunk length
        if scfg.max_len <= 2:
            raise ValueError(f"max_len {scfg.max_len} leaves no room for "
                             "a verify chunk")
        self.draft = draft_policy(self.policy, weights_fmt=draft_weights_fmt,
                                  kv_format=draft_kv_format)
        if self.device.type == "cuda":
            check_kv_kernels(cfg, self.draft, scfg.max_len)
            load_kv_kernels(self.draft)
        # the draft's own hoisted weights (self.params are the target's)
        self.draft_params = lm.hoist_weight_quant(
            _to_device(params, self.device), self.draft)
        b, L = scfg.max_batch, scfg.max_len
        # the draft runs its own engine over a dense ring; it shares the
        # tracer, registry, fault injector and retry policy, so its stages
        # show up (and can fault) as "draft.generate" etc.
        self.draft_engine = TransprecisionEngine(
            cfg, lm.weights_free(self.draft, cfg.tie_embed), b, L,
            device=self.device, tracer=self.tracer, metrics=self.metrics, stage_prefix="draft.",
            faults=self.faults, retry=self.retry, weight_policy=self.draft)
        self.draft_cache = self.draft_engine.init_decode_state()
        self.draft_pos = np.zeros(b, np.int64)  # committed draft rows/slot
        # the committed token the draft cache is missing (an all-accepted
        # round leaves the draft one row behind); None = in sync
        self._lag_tok: List[Optional[int]] = [None] * b

        self.stats.bind_counters("spec_rounds", "draft_steps",
                                 "drafts_proposed", "drafts_accepted")
        # per-round verify chunk length, accepted drafts per slot-round,
        # and K/V rows rolled back per slot-round
        self._h_chunk = self.metrics.histogram("spec.chunk_T",
                                               lo=1.0, hi=1e3, ratio=1.25)
        self._h_accept = self.metrics.histogram("spec.accepted_per_round",
                                                lo=1.0, hi=1e3, ratio=1.25)
        self._h_rollback = self.metrics.histogram("spec.rollback_rows",
                                                  lo=1.0, hi=1e3,
                                                  ratio=1.25)
        # the draft ring is device memory too: report it in the footprint
        self.stats["kv_cache_bytes"] = self.kv_cache_bytes()

    # ---- cache footprint (target cache + the dense draft ring) ----
    def _draft_kv_bytes(self) -> int:
        """The draft ring's reserved bytes (always a full ring, never
        paged); 0 while the base __init__ runs, before it exists."""
        draft_cache = getattr(self, "draft_cache", None)
        if draft_cache is None:
            return 0
        return self._kv_bytes(cache=draft_cache)

    def kv_cache_bytes(self) -> int:
        return super().kv_cache_bytes() + self._draft_kv_bytes()

    def kv_cache_live_bytes(self) -> int:
        return super().kv_cache_live_bytes() + self._draft_kv_bytes()

    def kv_cache_peak_live_bytes(self) -> int:
        return super().kv_cache_peak_live_bytes() + self._draft_kv_bytes()

    # ---- admission ----
    def _reject_reason(self, req: Request) -> Optional[str]:
        r = super()._reject_reason(req)
        if r is not None:
            return r
        if len(self._admission_tokens(req)) > self.scfg.max_len - 2:
            return (f"prompt length {len(req.prompt)} > max_len - 2 = "
                    f"{self.scfg.max_len - 2}: no row of verify-chunk "
                    "headroom")
        if self._req_temp(req) > 0:
            return ("speculative decoding is greedy-only; set "
                    "Request.temperature=0 (or serve through the baseline "
                    "engine)")
        return None

    def _worst_pages(self, req: Request) -> int:
        """Worst-case page demand including the verify chunk's transient
        rows: a round may write up to gamma+1 rows past the committed
        length before rolling back."""
        s = len(self._admission_tokens(req))
        remaining = max(req.max_new - len(req.out_tokens), 0)
        tokens = min(max(s + remaining, s + 1) + self._T,
                     self.scfg.max_len)
        return pages_for(tokens, self.allocator.page_size)

    def _free_request_slot(self, slot: int) -> None:
        super()._free_request_slot(slot)
        self.draft_pos[slot] = 0
        self._lag_tok[slot] = None

    def add_requests(self, reqs: List[Request]) -> List[bool]:
        # each admission needs its own draft prefill: one request at a time
        ok: List[bool] = []
        for r in reqs:
            admitted = self.add_request(r)
            ok.append(admitted)
            if not admitted:
                break
        ok.extend([False] * (len(reqs) - len(ok)))
        return ok

    def add_request(self, req: Request) -> bool:
        reject = self._reject_reason(req)
        if reject is not None:
            raise ValueError(f"{reject}; reject before admission")
        toks = np.asarray(self._admission_tokens(req))  # before _install
        if not all(ServingEngine.add_requests(self, [req])):
            return False
        slot = next((i for i, r in enumerate(self.slot_req) if r is req),
                    None)
        if slot is None:        # finished at admission (max_new<=1 / EOS)
            return True
        # mirror the prompt into the draft ring, so round 1 drafts from the
        # target's committed prefix (a bucket of it, or, where the engine is
        # not bucketed (vlm), its exact length: the reference passes the
        # lengths there too, which its unbucketed engine refuses)
        n = len(toks)
        pad = np.zeros((1, self.draft_engine.bucket_for(n)), np.int64)
        pad[0, :n] = toks
        dpfx = self.draft_engine.prefill(
            self.draft_params, torch.from_numpy(pad),
            [n] if self.draft_engine.bucketed else None)
        self.draft_cache = self.draft_engine.insert(dpfx, self.draft_cache,
                                                    slot)
        self.draft_pos[slot] = n
        self._lag_tok[slot] = None
        return True

    # ---- one speculative round for the whole batch ----
    def step(self):
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active:
            return
        b = self.scfg.max_batch
        # the round's chunk must fit every active slot's remaining rows
        # (admission keeps pos <= max_len - 2 while active, so T >= 2)
        T = min(self._T,
                int(min(self.scfg.max_len - self.slot_pos[i]
                        for i in active)))
        gamma = T - 1
        pre_pos = self.slot_pos.copy()          # committed rows per slot
        pre_draft = self.draft_pos.copy()
        self._h_chunk.observe(T)

        # ---- draft phase: gamma lockstep low-precision steps ----
        cur = np.zeros((b, 1), np.int32)
        proposals = np.zeros((b, gamma), np.int32)
        nprop = np.zeros(b, np.int64)
        catchup = np.zeros(b, bool)
        for i in active:
            if self._lag_tok[i] is not None:
                cur[i, 0] = self._lag_tok[i]
                catchup[i] = True
            else:
                cur[i, 0] = self.last_tok[i, 0]
        with self.tracer.span("spec.draft", cat="host"):
            for s in range(gamma):
                self.draft_cache["tok"] = torch.from_numpy(cur).to(
                    self.device)
                self.draft_cache, _ = self.draft_engine.generate(
                    self.draft_params, self.draft_cache)
                # generate's on-device greedy argmax over the vocab
                toks = self.draft_cache["tok"][:, 0].cpu().numpy()
                self.stats["draft_steps"] += 1
                for i in active:
                    if s == 0 and catchup[i]:
                        # catch-up: the output re-predicts a committed
                        # token; discard it and feed the real one next
                        cur[i, 0] = self.last_tok[i, 0]
                        continue
                    proposals[i, nprop[i]] = toks[i]
                    nprop[i] += 1
                    cur[i, 0] = toks[i]
        self.stats["drafts_proposed"] += int(nprop[active].sum())

        # ---- verify phase: one target-precision chunk pass ----
        chunk = np.zeros((b, T), np.int64)
        for i in active:
            chunk[i, 0] = self.last_tok[i, 0]
            chunk[i, 1:1 + nprop[i]] = proposals[i, : nprop[i]]
        if self.paged:
            self._grow_pages(active, lambda i: self.slot_pos[i] + T)
            active = [i for i in active if self.slot_req[i] is not None]
            if not active:
                return
        # page lists as of the verify's write extent (rollback scrubs
        # against these, before truncation and free)
        old_pages = ([list(self.slot_pages[i].pages) for i in range(b)]
                     if self.paged else None)
        self.cache, logits_v = self.engine.verify(
            self.params, self.cache, torch.from_numpy(chunk))
        g = logits_v[..., : self.cfg.vocab].argmax(dim=-1).cpu().numpy()
        self.stats["decode_steps"] += 1
        self.stats["spec_rounds"] += 1

        # ---- per-slot acceptance + commit ----
        with self.tracer.span("spec.accept", cat="host"):
            for i in active:
                req = self.slot_req[i]
                n = int(nprop[i])
                k = 0
                while k < n and proposals[i, k] == g[i, k]:
                    k += 1
                # emission budget: stop at exactly max_new tokens and at
                # pos max_len - 1, as baseline greedy does (at least one
                # token always lands)
                cap = max(int(self.scfg.max_len - 1 - pre_pos[i]), 1)
                k = min(k, req.max_new - len(req.out_tokens) - 1, cap - 1)
                emitted = [int(t) for t in proposals[i, :k]] + [int(g[i, k])]
                eos = self.scfg.eos_id
                if eos is not None and eos in emitted:
                    emitted = emitted[: emitted.index(eos) + 1]
                # accepted drafts plus (unless an EOS draft truncated the
                # list first) one non-draft bonus token
                self.stats["drafts_accepted"] += min(len(emitted), k)
                self._h_accept.observe(min(len(emitted), k))
                self.last_tok[i, 0] = emitted[-1]
                self.slot_pos[i] = pre_pos[i] + len(emitted)
                self._emit(req, emitted)
                # draft sync: rows the draft holds for the committed prefix
                self.draft_pos[i] = min(pre_draft[i] + gamma,
                                        self.slot_pos[i])
                lag = int(self.slot_pos[i] - self.draft_pos[i])
                self._lag_tok[i] = int(chunk[i, k]) if lag else None
                if (len(req.out_tokens) >= req.max_new
                        or (eos is not None and emitted[-1] == eos)
                        or self.slot_pos[i] >= self.scfg.max_len - 1):
                    req.done = True
                    self._free_request_slot(i)  # resets slot + draft state

        # ---- KV rollback: target cache ----
        new_pos = self.slot_pos.copy()          # post-free (0 for done/idle)
        with self.tracer.span("spec.rollback", cat="host"):
            for i in active:
                if self.slot_req[i] is not None:
                    self._h_rollback.observe(int(pre_pos[i]) + T
                                             - int(new_pos[i]))
            if self.paged:
                ps = self.allocator.page_size
                scrub = np.zeros(b * T, np.int64)  # padded w/ trash row 0
                nscrub = 0
                truncated = False
                for i in active:
                    if self.slot_req[i] is None:   # freed above: pages
                        continue                   # already in the pool
                    sp = self.slot_pages[i]
                    keep = pages_for(int(new_pos[i]), ps)
                    orphans = sp.pages[keep:]
                    for p in range(int(new_pos[i]), int(pre_pos[i]) + T):
                        scrub[nscrub] = old_pages[i][p // ps] * ps + p % ps
                        nscrub += 1
                    if orphans:
                        self.allocator.free(orphans)
                        del sp.pages[keep:]
                        self._table[i] = sp.table_row(self._pmax)
                        truncated = True
                if truncated:
                    self._sync_table()
                self.cache = self.engine.rollback_paged(self.cache, new_pos,
                                                        scrub)
            else:
                # only the T rows this round wrote per slot; freed slots
                # skip the scrub (rewritten before any read on
                # readmission), idle slots no-op
                window_end = np.full(b, T, np.int64)
                scrub_from = window_end.copy()
                for i in active:
                    window_end[i] = pre_pos[i] + T
                    scrub_from[i] = (self.slot_pos[i]
                                     if self.slot_req[i] is not None
                                     else window_end[i])
                self.cache = self.engine.rollback_ring(
                    self.cache, new_pos, window_end, scrub_from, T)
            # ---- KV rollback: draft ring (always the ring layout) ----
            d_end = np.full(b, gamma, np.int64)
            d_from = d_end.copy()
            for i in active:
                d_end[i] = pre_draft[i] + gamma
                d_from[i] = (self.draft_pos[i]
                             if self.slot_req[i] is not None
                             else d_end[i])
            self.draft_cache = self.draft_engine.rollback_ring(
                self.draft_cache, self.draft_pos, d_end, d_from, gamma)
