"""Low-overhead span tracer: context-manager API, thread-aware,
monotonic-clocked, exact per-name aggregates (host-only copy of the
aggregating part of ``repro.obs.tracer``).

The serving engine opens *spans* around units of work::

    tracer = Tracer(enabled=True)
    with tracer.span("generate.dispatch", cat="engine"):
        out = generate_fn(params, state)

Design points:

* **Disabled is (nearly) free.**  ``span()`` on a disabled tracer returns
  a shared no-op context manager after one attribute check — no
  allocation, no clock read.  The serving hot loop keeps its spans in
  place permanently and pays < 1 µs/call when tracing is off.
* **Monotonic clock.**  All stamps are ``time.perf_counter()`` — the
  highest-resolution monotonic clock, system-wide on Linux, so stamps
  compare across threads.
* **Thread-aware nesting.**  Each thread keeps its own span stack
  (``threading.local``), so spans nest correctly per thread and a span's
  *self time* (duration minus time spent in child spans) is computed
  online at close.  Summed over all spans of one thread, self times tile
  the traced wall time exactly.
* Engine stages are additionally wrapped in
  ``torch.profiler.record_function`` at the call site so host spans line
  up with device traces captured via ``torch.profiler``.
"""
from __future__ import annotations

import threading
from time import perf_counter
from typing import Any, Dict, List

__all__ = ["Tracer", "Span"]


class _NullSpan:
    """Shared no-op context manager returned while tracing is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Span:
    """One live span; use via ``with tracer.span(...)``, not directly."""
    __slots__ = ("_tracer", "name", "cat", "t0", "t1", "_child_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self._child_s = 0.0

    def __enter__(self) -> "Span":
        self._tracer._stack().append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = perf_counter()
        stack = self._tracer._stack()
        # tolerate misuse (exit out of order) without corrupting siblings
        if stack and stack[-1] is self:
            stack.pop()
        dur = self.t1 - self.t0
        if stack:
            stack[-1]._child_s += dur
        self._tracer._add(self.name, self.cat, dur, dur - self._child_s)
        return False


class Tracer:
    """Span recorder: exact per-name aggregates (count, total, self)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        # (name, cat) -> [count, total_s, self_s]
        self._agg: Dict[Any, List[float]] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ---- recording ----
    def span(self, name: str, cat: str = "host") -> Any:
        """Open a span; returns a context manager.  No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat)

    def record(self, name: str, t0: float, t1: float,
               cat: str = "host") -> None:
        """Record an already-closed span from external ``perf_counter``
        stamps (e.g. a request's queue wait measured between its submit
        and admit stamps).  No stack interaction: the span never nests,
        so its self time equals its duration, and — unlike ``span()`` —
        it does not subtract from any live parent span."""
        if self.enabled:
            self._add(name, cat, t1 - t0, t1 - t0)

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _add(self, name: str, cat: str, dur: float, self_s: float) -> None:
        with self._lock:
            agg = self._agg.get((name, cat))
            if agg is None:
                self._agg[(name, cat)] = [1, dur, self_s]
            else:
                agg[0] += 1
                agg[1] += dur
                agg[2] += self_s

    # ---- control ----
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop recorded aggregates (enabled flag unchanged)."""
        with self._lock:
            self._agg.clear()

    # ---- inspection ----
    def self_times(self) -> Dict[str, Dict[str, Any]]:
        """Exact per-span-name aggregates over the whole run:
        ``{name: {cat, count, total_s, self_s}}``.  ``self_s`` excludes
        time spent inside child spans, so summing it across names never
        double-counts nested work."""
        with self._lock:
            items = list(self._agg.items())
        out: Dict[str, Dict[str, Any]] = {}
        for (name, cat), (count, total, self_s) in items:
            rec = out.get(name)
            if rec is None:
                out[name] = {"cat": cat, "count": int(count),
                             "total_s": total, "self_s": self_s}
            else:                      # same name under two cats: merge
                rec["count"] += int(count)
                rec["total_s"] += total
                rec["self_s"] += self_s
        return out
