"""Batched serving engine: slot-based continuous batching over a TALU-style
transprecision model (port of ``repro.serve.engine``, ring layout).

A fixed batch of B slots: finished sequences free their slot and the next
queued request is prefilled into it while other slots keep decoding.
``generate`` runs the whole batch with true per-slot positions; prompts
prefill in power-of-two buckets; sampling is greedy or temperature (per
request) from the engine's own numpy RNG; ``on_emit`` streams tokens.

Weight quantization is hoisted: the policy's weight hook is a pure function
of each weight, so the engine applies it once at construction
(``models.lm.hoist_weight_quant``) and serves through the policy with its
weight roles cleared; the KV format is unchanged.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core.transprecision import BF16, TCPolicy, get_policy
from ..models import lm
from ..obs import MetricsRegistry, StatsView, Tracer
from .engine_api import TransprecisionEngine

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
    # KV-cache layout override; only "ring" is ported
    kv_layout: Optional[str] = None


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
    # prefill_done, insert_done, first_token, finish
    timing: Dict[str, float] = dataclasses.field(
        default_factory=dict, repr=False)


class ServingEngine:
    def __init__(self, cfg: lm.ModelCfg, params, scfg: ServeConfig,
                 policy: TCPolicy = BF16, *, device="cuda",
                 tracer: Optional[Tracer] = None, faults=None, retry=None,
                 guard=None):
        if faults is not None or retry is not None or guard:
            raise NotImplementedError("fault injection, retry and the "
                                      "numeric guard are a later slice of "
                                      "the port")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.policy = get_policy(policy)
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = MetricsRegistry()
        overrides = {}
        if scfg.kv_format is not None:
            overrides["kv_format"] = scfg.kv_format
        if scfg.kv_layout is not None:
            overrides["kv_layout"] = scfg.kv_layout
        if overrides:
            tag = "+".join(f"{k[3:]}_{v}" for k, v in overrides.items())
            self.policy = dataclasses.replace(
                self.policy, name=f"{self.policy.name}+{tag}", **overrides)
        params = _to_device(params, self.device)
        self.params = lm.hoist_weight_quant(params, self.policy)
        b = scfg.max_batch
        self.engine = TransprecisionEngine(
            cfg, lm.weights_free(self.policy), b, scfg.max_len,
            device=self.device, tracer=self.tracer, metrics=self.metrics)
        self.cache = self.engine.init_decode_state()
        self.slot_pos = np.zeros(b, np.int64)         # valid tokens per slot
        self.slot_req: List[Optional[Request]] = [None] * b
        self.last_tok = np.zeros((b, 1), np.int32)
        self.on_emit: Optional[Callable[[Request, List[int]], None]] = None
        self._rng = np.random.default_rng(scfg.seed)
        self.stats = StatsView(self.metrics, prefix="engine.")
        self.stats.bind_counters("prefills", "decode_steps", "tokens",
                                 "rejected")
        self.stats.bind_gauges("kv_cache_bytes")
        self.stats["kv_cache_bytes"] = self.kv_cache_bytes()

    # ---- cache footprint ----
    def kv_cache_bytes(self) -> int:
        """Device footprint of the attention K/V state (codes + scales)."""
        return sum(t.numel() * t.element_size()
                   for blk in self.cache["blocks"]
                   for name, t in blk.items() if name in _KV_LEAF_NAMES)

    # ---- slot management ----
    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slot_req):
            if r is None:
                return i
        return None

    def free_slots(self) -> int:
        return sum(r is None for r in self.slot_req)

    def _install(self, req: Request, slot: int, prefix, row: int) -> None:
        """Insert prefix row ``row`` into ``slot``, sample the first token,
        finish prompt-only requests."""
        self.cache = self.engine.insert(prefix, self.cache, slot, row)
        req.timing.setdefault("insert_done", time.perf_counter())
        self.stats["prefills"] += 1
        logits = _host(prefix["logits"][row])
        tok = int(self._sample(logits[None], [self._req_temp(req)])[0])
        self.last_tok[slot, 0] = tok
        self._emit(req, [tok])
        if (len(req.out_tokens) >= req.max_new
                or req.out_tokens[-1] == self.scfg.eos_id):
            req.done = True
            self._free_request_slot(slot)

    def add_request(self, req: Request) -> bool:
        """Prefill ``req`` into a free slot; False if no slot is free."""
        return all(self.add_requests([req]))

    def add_requests(self, reqs: Sequence[Request]) -> List[bool]:
        """Batched admission: claim a slot per request (FIFO, stopping at
        the first that does not fit), run ONE bucketed prefill over every
        admitted prompt and insert per row."""
        admitted = []
        ok = [False] * len(reqs)
        for j, req in enumerate(reqs):
            n = len(req.prompt)
            if n >= self.scfg.max_len:
                raise ValueError(f"prompt length {n} >= max_len "
                                 f"{self.scfg.max_len}; reject before "
                                 "admission")
            slot = self._free_slot()
            if slot is None:
                break
            self.slot_req[slot] = req
            self.slot_pos[slot] = n
            admitted.append((req, slot))
            ok[j] = True
        if not admitted:
            return ok
        now = time.perf_counter()
        for req, _ in admitted:
            sub = req.timing.setdefault("submit", now)
            req.timing.setdefault("admit", now)
            if self.tracer.enabled and now > sub:
                self.tracer.record("queue.wait", sub, now, cat="queue")
        bucket = self.engine.bucket_for(max(len(r.prompt)
                                            for r, _ in admitted))
        pad = np.zeros((len(admitted), bucket), np.int64)
        lens = np.zeros(len(admitted), np.int32)
        for row, (req, _) in enumerate(admitted):
            pad[row, :len(req.prompt)] = req.prompt
            lens[row] = len(req.prompt)
        prefix = self.engine.prefill(self.params, torch.from_numpy(pad),
                                     torch.from_numpy(lens))
        done = time.perf_counter()
        for row, (req, slot) in enumerate(admitted):
            req.timing.setdefault("prefill_done", done)
            self._install(req, slot, prefix, row)
        return ok

    def _free_request_slot(self, slot: int) -> None:
        req = self.slot_req[slot]
        if req is not None and req.done:
            req.timing.setdefault("finish", time.perf_counter())
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0

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
        self.cache["tok"] = torch.from_numpy(self.last_tok).to(self.device)
        self.cache, logits = self.engine.generate(self.params, self.cache)
        logits = _host(logits)
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

    def _admit(self, queue: List[Request]) -> None:
        """Admit every currently admissible queued request (FIFO), rejecting
        those that can never fit."""
        i = 0
        while i < len(queue):
            req = queue[i]
            n = len(req.prompt)
            if n >= self.scfg.max_len:
                req.done = True
                req.error = f"prompt length {n} >= max_len {self.scfg.max_len}"
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
        while (queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            with self.tracer.span("serve.admit"):
                self._admit(queue)
            with self.tracer.span("serve.step"):
                self.step()
            ticks += 1
        dt = time.perf_counter() - t0
        return {"wall_s": dt, **self.stats,
                "kv_peak_live_bytes": self.kv_cache_bytes(),
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
