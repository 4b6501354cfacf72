"""Deterministic, seed-driven fault injection for the serving stack (a
copy of ``repro.serve.faults``: plain numpy, the same schedules).

Chaos hardening needs failures that are *reproducible*: a
:class:`FaultPlan` is a static schedule of :class:`Fault`\\ s, each keyed
to a call-site ("site") and a 0-based call index at that site.  The
:class:`FaultInjector` keeps one monotonically increasing counter per
site; a fault fires on calls ``at <= n < at + count``.  Same plan, same
request stream → the same faults fire at the same points, so the chaos
suite (``tests/test_torch_chaos.py``) can assert exact invariants
instead of "it usually survives".

Sites and what their faults do:

* ``<stage name>`` (``prefill`` / ``generate`` / ``insert`` / ``verify``
  / ``draft.generate`` / ...) — ``stage_error`` raises
  :class:`InjectedFault` *before* the stage dispatches (the stages write
  the decode state in place, so a failed attempt must leave no half-
  written K/V rows), ``stage_delay`` sleeps
  ``delay_s`` first (injected straggler).  Transient stage errors are
  retried by the engine under a :class:`RetryPolicy`; persistent ones
  propagate to the driver (crash containment's job).
* ``alloc`` / ``fork`` — ``pool_dry`` makes ``PageAllocator.alloc``
  return None (admission queues / overcommit evicts), ``fork_fail``
  raises from ``fork``.
* ``round`` — one call per base-engine decode round: ``poison_logits``
  overwrites the chosen ``slot``'s logits row with NaN host-side
  (modeling a low-precision datapath blow-up); ``fixed_by_level`` says
  how far up the guard's precision-fallback ladder the fault persists
  (1 = the first fallback re-decode already reads finite).
* ``tokenize`` / ``detok`` / ``sched`` — ``tokenize_crash`` /
  ``detok_crash`` / ``sched_crash`` raise inside the orchestrator's
  worker loops (exercising loop-death containment).

Every hook is behind an ``if injector is not None`` check at the call
site — a disabled serving stack pays nothing.  Fired faults are appended
to ``injector.events`` (kind/site/call/slot/uid) and tick
``faults.injected`` + ``faults.<kind>`` counters in the shared metrics
registry.

``train/fault_tolerance.py`` (CrashBarrier's ``crash_at_steps``) is the
in-repo precedent; this module is the serving-side generalization.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Fault", "FaultPlan", "FaultInjector", "InjectedFault",
           "RetryPolicy"]

_STAGE_KINDS = ("stage_error", "stage_delay")
_SITE_OF = {"pool_dry": "alloc", "fork_fail": "fork",
            "poison_logits": "round", "tokenize_crash": "tokenize",
            "detok_crash": "detok", "sched_crash": "sched"}
KINDS = _STAGE_KINDS + tuple(_SITE_OF)


class InjectedFault(RuntimeError):
    """An injected failure.  ``transient`` marks faults a bounded retry
    is allowed to absorb; persistent ones must reach crash containment."""

    def __init__(self, msg: str, *, kind: str = "injected",
                 transient: bool = False):
        super().__init__(msg)
        self.kind = kind
        self.transient = transient


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff for *transient* stage failures.

    ``max_attempts`` is the total number of tries (1 = no retry);
    the sleep before retry ``k`` (0-based) is
    ``min(backoff_s * multiplier**k, max_backoff_s)``."""
    max_attempts: int = 4
    backoff_s: float = 0.005
    multiplier: float = 2.0
    max_backoff_s: float = 0.25

    def delay(self, retry_index: int) -> float:
        return min(self.backoff_s * self.multiplier ** retry_index,
                   self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.  ``at``/``count``: fire on calls
    ``[at, at + count)`` of this fault's site counter.  ``stage`` names
    the site for stage faults (other kinds have fixed sites)."""
    kind: str
    stage: str = ""
    at: int = 0
    count: int = 1
    transient: bool = True        # stage_error: retryable?
    delay_s: float = 0.02         # stage_delay: injected latency
    slot: int = 0                 # poison_logits: victim batch slot
    fixed_by_level: int = 1       # poison_logits: first guard level that
                                  # reads finite logits again

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {sorted(KINDS)})")
        if self.kind in _STAGE_KINDS and not self.stage:
            raise ValueError(f"{self.kind} needs a stage site name")

    @property
    def site(self) -> str:
        return self.stage if self.kind in _STAGE_KINDS \
            else _SITE_OF[self.kind]


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A static fault schedule (plus seed provenance for random plans)."""
    faults: Tuple[Fault, ...] = ()
    seed: Optional[int] = None

    # stage sites random plans target (base + speculative engines)
    RANDOM_STAGES = ("prefill", "generate", "insert")

    @classmethod
    def random(cls, seed: int, n: int = 6, *, rounds: int = 40,
               slots: int = 2, lethal: bool = False,
               stages: Tuple[str, ...] = RANDOM_STAGES) -> "FaultPlan":
        """Seeded random schedule of ``n`` faults over the first
        ``rounds`` calls of each site.  Benign plans draw transient stage
        errors (retryable), stage delays, poisoned logits (guard-
        recoverable) and pool-dry allocs (queue/evict-recoverable);
        ``lethal`` adds persistent stage errors and loop crashes, whose
        only correct outcome is containment.  Pool-dry faults assume a
        ``page_overcommit`` engine (a reservation-mode engine treats a
        dry growth alloc as an invariant violation — by design)."""
        rng = np.random.default_rng(seed)
        kinds = ["stage_error", "stage_delay", "poison_logits", "pool_dry"]
        if lethal:
            kinds += ["stage_error_persistent", "detok_crash",
                      "tokenize_crash", "sched_crash"]
        faults: List[Fault] = []
        for _ in range(n):
            k = kinds[int(rng.integers(len(kinds)))]
            at = int(rng.integers(0, rounds))
            if k in ("stage_error", "stage_error_persistent"):
                faults.append(Fault(
                    "stage_error", stage=str(stages[int(rng.integers(
                        len(stages)))]), at=at,
                    count=int(rng.integers(1, 3)),
                    transient=(k == "stage_error")))
            elif k == "stage_delay":
                faults.append(Fault(
                    "stage_delay", stage=str(stages[int(rng.integers(
                        len(stages)))]), at=at,
                    delay_s=float(rng.uniform(0.005, 0.03))))
            elif k == "poison_logits":
                faults.append(Fault(
                    "poison_logits", at=at,
                    slot=int(rng.integers(slots)),
                    fixed_by_level=int(rng.integers(1, 3))))
            elif k == "pool_dry":
                faults.append(Fault("pool_dry", at=at,
                                    count=int(rng.integers(1, 3))))
            else:
                faults.append(Fault(k, at=at))
        return cls(tuple(faults), seed=seed)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """CLI-facing plan specs: ``none``, ``random:seed=3,n=6`` (keys:
        seed/n/rounds/slots/lethal), or a path to a JSON file holding a
        list of :class:`Fault` field dicts."""
        spec = spec.strip()
        if spec in ("", "none"):
            return cls()
        if spec.startswith("random:") or spec == "random":
            kv = {}
            for part in spec.partition(":")[2].split(","):
                if not part:
                    continue
                k, _, v = part.partition("=")
                kv[k.strip()] = v.strip()
            return cls.random(seed=int(kv.get("seed", 0)),
                              n=int(kv.get("n", 6)),
                              rounds=int(kv.get("rounds", 40)),
                              slots=int(kv.get("slots", 2)),
                              lethal=bool(int(kv.get("lethal", 0))))
        with open(spec) as f:
            return cls(tuple(Fault(**d) for d in json.load(f)))


class FaultInjector:
    """Threads a :class:`FaultPlan` through the serving stack's hook
    points.  Thread-safe: the scheduler, detokenizer and allocator all
    call in.  ``events`` records every fired fault."""

    def __init__(self, plan: FaultPlan, *, metrics=None):
        self.plan = plan
        self.metrics = metrics
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._by_site: Dict[str, List[Fault]] = {}
        for f in plan.faults:
            self._by_site.setdefault(f.site, []).append(f)
        self.events: List[dict] = []
        self.uids_poisoned: set = set()

    def _fire(self, site: str) -> List[Fault]:
        """Advance ``site``'s call counter; return the faults scheduled
        for this call."""
        scheduled = self._by_site.get(site)
        with self._lock:
            n = self._counters.get(site, 0)
            self._counters[site] = n + 1
        if not scheduled:
            return []
        return [f for f in scheduled if f.at <= n < f.at + f.count]

    def _log(self, fault: Fault, site: str, **extra) -> None:
        with self._lock:
            call = self._counters.get(site, 1) - 1
            self.events.append({"kind": fault.kind, "site": site,
                                "call": call, **extra})
        if self.metrics is not None:
            self.metrics.counter("faults.injected").inc()
            self.metrics.counter(f"faults.{fault.kind}").inc()

    # ---- hook points ----
    def on_stage(self, name: str) -> None:
        """Engine-stage hook (``engine_api``), called BEFORE the stage
        dispatches: injected stragglers sleep, injected errors raise —
        a failed attempt never writes the decode state."""
        fired = self._fire(name)
        if not fired:
            return
        for f in fired:
            if f.kind == "stage_delay":
                self._log(f, name, delay_s=f.delay_s)
                time.sleep(f.delay_s)
        for f in fired:
            if f.kind == "stage_error":
                self._log(f, name, transient=f.transient)
                mode = "transient" if f.transient else "persistent"
                raise InjectedFault(
                    f"injected {mode} failure in stage {name} "
                    f"(call {self._counters[name] - 1})",
                    kind="stage_error", transient=f.transient)

    def on_alloc(self, n: int) -> bool:
        """PageAllocator.alloc hook: True forces a dry-pool result."""
        for f in self._fire("alloc"):
            if f.kind == "pool_dry":
                self._log(f, "alloc", pages=n)
                return True
        return False

    def on_fork(self) -> None:
        for f in self._fire("fork"):
            if f.kind == "fork_fail":
                self._log(f, "fork")
                raise InjectedFault("injected page-fork failure",
                                    kind="fork_fail")

    def poison_round(self, uid_by_slot: Dict[int, int]) -> Dict[int, Fault]:
        """Decode-round hook: which active slots get NaN logits this
        round.  Returns ``{slot: fault}``; the engine overwrites those
        logits rows and hands the map to the numeric guard (which uses
        ``fixed_by_level`` to decide when the fallback re-decode reads
        finite again)."""
        fired = self._fire("round")
        out: Dict[int, Fault] = {}
        for f in fired:
            if f.kind != "poison_logits":
                continue
            uid = uid_by_slot.get(f.slot)
            if uid is None:
                continue            # victim slot idle: fault is a no-op
            out[f.slot] = f
            self.uids_poisoned.add(uid)
            self._log(f, "round", slot=f.slot, uid=uid,
                      fixed_by_level=f.fixed_by_level)
        return out

    def _crash(self, site: str, kind: str) -> None:
        for f in self._fire(site):
            if f.kind == kind:
                self._log(f, site)
                raise InjectedFault(f"injected {site} crash", kind=kind)

    def on_tokenize(self) -> None:
        self._crash("tokenize", "tokenize_crash")

    def on_detok(self) -> None:
        self._crash("detok", "detok_crash")

    def on_sched(self) -> None:
        """Scheduler-tick hook (one call per scheduler iteration)."""
        self._crash("sched", "sched_crash")
