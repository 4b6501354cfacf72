"""Numeric quarantine + automatic precision-fallback re-decode (port of
``repro.serve.guard``).

The paper's thesis — runtime precision reconfiguration on one datapath —
applied as a *failure policy*: when a slot's decode logits come back
non-finite (a posit8 weight path blowing up, or an injected
``poison_logits`` fault), the slot is quarantined for that round and its
logits row is recomputed up a **precision-escalation ladder** derived
from the engine's own policy (posit8 → posit16 → full target precision)
until the row reads finite again.  Un-faulted slots keep their original
logits bit-for-bit, so a quarantine never perturbs its batch neighbours.

Mechanics per quarantined round:

* a guard-armed engine and its rungs run with ``donate=False`` (the
  reference's rule): the fallback must re-read the pre-round state, which
  a donated ``generate`` consumes;
* the driver takes ``prev = dict(cache)`` before ``generate``: the round
  writes K/V rows in place and rebinds ``pos`` and ``tok`` on the dict,
  so the copy keeps the pre-round ``pos`` and ``tok`` tensors (one dict
  copy per step, no tensor copy);
* each ladder rung is a lazily built :class:`TransprecisionEngine`
  (stage prefix ``guard<k>.``) sharing the main engine's tracer/metrics,
  serving the rung's OWN weights: the engine serves weights hoisted under
  its policy (posit8-rounded for ``paper_edge_p8``), so each rung hoists
  the engine's raw device parameters under the rung's policy on its first
  quarantine and runs ``lm.weights_free(rung)``;
* a rung re-runs the SAME round from ``prev`` with its cache leaves
  cloned (one pool copy per rung tried, never per step).  In a
  decoder-only stack the round left every row below ``pos`` untouched and
  the rung rewrites the row at ``pos`` (append, then attend) before
  reading it, so the clone is, for everything the rung reads, the
  pre-round state.  An SSM stack rewrites its whole recurrent state each
  round, so its decode step writes the new ``state`` / ``conv`` into new
  tensors and rebinds ``blocks`` on the dict: ``prev`` holds the
  pre-round state itself.  Only
  the quarantined slot's logits row is taken; the rung's cache writes are
  discarded and the main cache keeps the original round's K/V (poison is
  a logits-level event), so neighbours' streams and rows are untouched;
* a request's achieved ladder level is **sticky** (``levels`` by uid): a
  slot that needed posit16 last round starts there next time it faults;
* if the ladder is exhausted and the row is still non-finite the request
  terminates with ``error`` (slot + pages reclaimed by the engine) —
  quarantine degrades one request, never the batch.

Counters in the shared registry: ``guard.nonfinite_rows`` (detections),
``guard.quarantined`` (slot-rounds quarantined), ``guard.fallbacks``
(fallback re-decodes run), ``guard.exhausted`` (requests failed through
the whole ladder).  Disabled (``guard=None`` engines), the only hot-path
cost is one ``is not None`` check per decode round.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.transprecision import TCPolicy
from ..models import lm
from .engine_api import TransprecisionEngine

__all__ = ["GuardConfig", "NumericGuard", "fallback_ladder", "pre_round"]

# roles the ladder escalates (weight compute + activations); KV
# format/layout stay FIXED so every rung consumes the same decode state
# the main engine produced
_LADDER_ROLES = ("attn_weights", "mlp_weights", "embed_weights",
                 "activations")


def _up(fmt: Optional[str]) -> Optional[str]:
    """One notch up: posit8/int8-class formats → posit16; 16-bit and up
    → full precision (None)."""
    if fmt is None:
        return None
    return None if "16" in fmt else "posit16_2"


def fallback_ladder(policy: TCPolicy) -> Tuple[TCPolicy, ...]:
    """Precision-escalation ladder for ``policy``: successive rungs
    upgrade every compute role one notch until full precision, dropping
    layer/node overrides (escalation is uniform).  A policy already at
    full precision gets a single same-precision retry rung — transient
    numeric state is still worth one re-decode."""
    rungs, cur = [], policy
    while True:
        nxt = {r: _up(getattr(cur, r)) for r in _LADDER_ROLES}
        if all(nxt[r] == getattr(cur, r) for r in _LADDER_ROLES) \
                and not cur.layer_overrides and not cur.node_overrides:
            break
        cur = dataclasses.replace(
            cur, name=f"{policy.name}+guard{len(rungs) + 1}",
            layer_overrides=(), node_overrides=(), **nxt)
        rungs.append(cur)
    if not rungs:
        rungs.append(dataclasses.replace(policy,
                                         name=policy.name + "+guard_retry"))
    return tuple(rungs)


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``ladder`` overrides the derived escalation ladder;
    ``max_levels`` truncates it (1 = a single fallback rung)."""
    max_levels: Optional[int] = None
    ladder: Optional[Tuple[TCPolicy, ...]] = None


def pre_round(prev: Dict[str, Any]) -> Dict[str, Any]:
    """A decode state that re-runs a round: ``prev`` (the dict copy taken
    before ``generate``, holding the pre-round ``pos``, ``tok`` and, for
    an SSM or hybrid stack, ``blocks`` and ``tail`` with their recurrent
    states) with its cache leaves cloned, so the re-run's in-place writes
    land in the copy.  See the module docstring for why the post-round
    K/V rows serve."""
    state = dict(prev)
    for part in ("blocks", "tail"):
        if part in prev:
            state[part] = tuple({k: v.clone() for k, v in blk.items()}
                                for blk in prev[part])
    return state


class NumericGuard:
    """Per-slot non-finite-logits quarantine for a ``ServingEngine``."""

    def __init__(self, engine, gcfg: GuardConfig = GuardConfig()):
        self.engine = engine
        ladder = (gcfg.ladder if gcfg.ladder is not None
                  else fallback_ladder(engine.policy))
        if gcfg.max_levels is not None:
            ladder = ladder[:gcfg.max_levels]
        if not ladder:
            raise ValueError("guard needs at least one ladder level")
        self.ladder: Tuple[TCPolicy, ...] = tuple(ladder)
        # uid -> achieved level (sticky; 0 = base policy, never stored)
        self.levels: Dict[int, int] = {}
        m = engine.metrics
        self._c_rows = m.counter("guard.nonfinite_rows")
        self._c_quar = m.counter("guard.quarantined")
        self._c_fall = m.counter("guard.fallbacks")
        self._c_exh = m.counter("guard.exhausted")
        self._rungs: Dict[int, Tuple[TransprecisionEngine, Any]] = {}

    def level(self, uid: int) -> int:
        """Achieved ladder level for a request (0 = base policy)."""
        return self.levels.get(uid, 0)

    def rung(self, lvl: int) -> Tuple[TransprecisionEngine, Any]:
        """(stage engine, hoisted weights) of ladder level ``lvl``, built
        on its first quarantine: the engine's raw device parameters
        quantized under the rung's policy, served through the policy with
        its weight roles cleared, and the engine's plugged decode
        attention (a sharded rung re-decodes the rank-local state)."""
        r = self._rungs.get(lvl)
        if r is None:
            eng, base = self.engine, self.engine.engine
            policy = self.ladder[lvl - 1]
            stages = TransprecisionEngine(
                eng.cfg, lm.weights_free(policy, eng.cfg.tie_embed),
                base.max_batch, base.max_len, num_pages=base.num_pages,
                attn_impl=base.attn_impl, device=eng.device,
                tracer=eng.tracer, metrics=eng.metrics,
                stage_prefix=f"guard{lvl}.", donate=False)
            r = (stages, lm.hoist_weight_quant(eng.raw_params, policy))
            self._rungs[lvl] = r
        return r

    def check_round(self, prev_state, logits: np.ndarray, active,
                    poisons: Optional[Dict[int, object]] = None) -> None:
        """Scan the round's host logits (mutated in place) for non-finite
        rows among ``active`` slots; re-decode each such row from
        ``prev_state`` up the ladder.  Requests that stay non-finite
        through the top rung are marked ``done`` with an ``error`` — the
        engine frees their slot/pages afterwards.  ``poisons`` maps slots
        to injected faults whose ``fixed_by_level`` simulates a failure
        that only clears above a given precision."""
        poisons = poisons or {}
        eng = self.engine
        for i in active:
            if np.isfinite(logits[i]).all():
                continue
            req = eng.slot_req[i]
            self._c_rows.inc()
            self._c_quar.inc()
            fault = poisons.get(i)
            # sticky start: a request that already proved it needs level k
            # RETRIES at k first (lvl is pre-incremented in the loop) — it
            # must not skip past its achieved rung, or a second fault on
            # the same request would instantly exhaust the ladder
            lvl = max(self.levels.get(req.uid, 1) - 1, 0)
            with eng.tracer.span("guard.redecode", cat="guard",
                                 slot=i, uid=req.uid):
                while lvl < len(self.ladder):
                    lvl += 1
                    self._c_fall.inc()
                    stages, params = self.rung(lvl)
                    _, fb_logits = stages.generate(params,
                                                   pre_round(prev_state))
                    row = fb_logits[i].to(torch.float32).cpu().numpy()
                    if fault is not None \
                            and lvl < getattr(fault, "fixed_by_level", 1):
                        row = np.full_like(row, np.nan)
                    if np.isfinite(row).all():
                        logits[i] = row
                        self.levels[req.uid] = lvl
                        break
                else:
                    self._c_exh.inc()
                    req.done = True
                    req.error = ("non-finite logits persisted through "
                                 f"the {len(self.ladder)}-level "
                                 "precision-fallback ladder")
