"""Fault-tolerance primitives (port of ``repro.train.fault_tolerance``;
pure Python, the port's own copy).

On a multi-host deployment these hooks bind to the cluster coordinator
(preemption signals, link health, per-host heartbeats).  Here they are
implemented against process-local signals with the same interfaces, so
the Trainer's recovery logic is real and testable:

* ``HeartbeatMonitor``   — tracks per-host step-completion times; flags
                           stragglers past ``straggler_sigma`` x the median
                           and dead hosts at a hard timeout.
* ``StragglerMitigator`` — policy object: deadline-based step skipping
                           (synchronous-with-backup semantics).  Because the
                           data pipeline is step-deterministic, a skipped
                           host replays the exact batch after recovery.
* ``ElasticPlan``        — recomputes (host -> data-shard) assignments for a
                           new world size; with the deterministic pipeline
                           this is a pure function, no data is lost.
* ``CrashBarrier``       — converts an injected fault into a
                           checkpoint-restore cycle (used by tests to prove
                           restart-exactness).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HostStatus:
    last_beat: float
    last_step: int
    step_times: List[float] = dataclasses.field(default_factory=list)


class HeartbeatMonitor:
    def __init__(self, n_hosts: int, dead_timeout_s: float = 300.0,
                 straggler_sigma: float = 3.0, window: int = 32):
        self.dead_timeout = dead_timeout_s
        self.sigma = straggler_sigma
        self.window = window
        self.hosts: Dict[int, HostStatus] = {
            h: HostStatus(time.time(), -1) for h in range(n_hosts)}

    def beat(self, host: int, step: int, step_time_s: float,
             now: Optional[float] = None):
        st = self.hosts[host]
        st.last_beat = now if now is not None else time.time()
        st.last_step = step
        st.step_times.append(step_time_s)
        del st.step_times[:-self.window]

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = now if now is not None else time.time()
        return [h for h, st in self.hosts.items()
                if now - st.last_beat > self.dead_timeout]

    def stragglers(self) -> List[int]:
        """Median-based outlier rule: a mean/stddev threshold is corrupted
        by the straggler itself on small fleets (one 5x host in 4 shifts
        mu+3sigma past it); the median is robust to <50% stragglers."""
        means = {h: (sum(st.step_times) / len(st.step_times))
                 for h, st in self.hosts.items() if st.step_times}
        if len(means) < 2:
            return []
        vals = sorted(means.values())
        med = vals[len(vals) // 2]
        return [h for h, v in means.items() if v > self.sigma * med]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    """Pure (world_size -> shard map) replan; pairs with the deterministic
    pipeline so resizing never duplicates or drops data."""
    global_batch: int
    n_hosts: int

    def __post_init__(self):
        if self.global_batch % self.n_hosts:
            raise ValueError(
                f"global_batch {self.global_batch} must divide over "
                f"{self.n_hosts} hosts")

    def shard_for(self, host: int):
        per = self.global_batch // self.n_hosts
        return slice(host * per, (host + 1) * per)

    def resize(self, n_hosts: int) -> "ElasticPlan":
        return ElasticPlan(self.global_batch, n_hosts)


class StragglerMitigator:
    """Deadline policy: if a host misses the step deadline, the step result
    is taken without it (backup-worker semantics) and the host replays the
    deterministic batch on rejoin."""

    def __init__(self, deadline_factor: float = 3.0):
        self.deadline_factor = deadline_factor
        self._median: Optional[float] = None

    def observe(self, step_time_s: float):
        self._median = (step_time_s if self._median is None
                        else 0.9 * self._median + 0.1 * step_time_s)

    def deadline(self) -> Optional[float]:
        return None if self._median is None else \
            self.deadline_factor * self._median

    def should_drop(self, elapsed_s: float) -> bool:
        d = self.deadline()
        return d is not None and elapsed_s > d


class CrashBarrier:
    """Inject faults at chosen steps; the Trainer catches ``SimulatedFault``
    and exercises its restore path (tests assert bit-exact resumption)."""

    class SimulatedFault(RuntimeError):
        pass

    def __init__(self, crash_at_steps=()):
        self.crash_at = set(crash_at_steps)
        self.fired = set()

    def check(self, step: int):
        if step in self.crash_at and step not in self.fired:
            self.fired.add(step)
            raise self.SimulatedFault(f"injected fault at step {step}")
