"""Low-overhead span tracer: context-manager API, thread-aware,
monotonic-clocked, ring-buffered, Chrome-trace/Perfetto export (host-only
copy of ``repro.obs.tracer``).

The serving stack (engine stages, orchestrator loop, speculative rounds,
page allocator, the numeric guard) opens *spans* around units of work::

    tracer = Tracer(enabled=True)
    with tracer.span("generate.dispatch", cat="engine"):
        out = generate_fn(params, state)

Design points:

* **Disabled is (nearly) free.**  ``span()`` on a disabled tracer returns
  a shared no-op context manager after one attribute check — no
  allocation, no clock read, whatever keyword arguments the call site
  passes.  The serving hot loop keeps its spans in place permanently.
* **Monotonic clock.**  All stamps are ``time.perf_counter()`` — the
  highest-resolution monotonic clock, system-wide on Linux, so stamps
  compare across threads.
* **Thread-aware nesting.**  Each thread keeps its own span stack
  (``threading.local``), so spans nest correctly per thread and a span's
  *self time* (duration minus time spent in child spans) is computed
  online at close.  Self times are the currency of the per-stage wall
  clock attribution in :mod:`repro_torch.obs.report`: summed over all
  spans of one thread they tile the traced wall time exactly.
* **Bounded memory.**  Finished spans land in a ring buffer
  (``collections.deque(maxlen=capacity)``) — old events fall off, but the
  per-name *aggregates* (count / total / self seconds) are exact over the
  whole run regardless of ring capacity.
* **Chrome trace export.**  ``chrome_trace()`` emits the Trace Event
  Format JSON (``ph: "X"`` complete events, µs timestamps, thread-name
  metadata) that ``chrome://tracing`` and https://ui.perfetto.dev load
  directly; engine stages are additionally wrapped in
  ``torch.profiler.record_function`` at the call site so host spans line
  up with device traces captured via ``torch.profiler``.
"""
from __future__ import annotations

import json
import os
import threading
from collections import deque
from time import perf_counter
from typing import Any, Dict, List, Optional

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
    __slots__ = ("_tracer", "name", "cat", "args", "t0", "t1", "_child_s")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
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
        self._tracer._record(self, dur, dur - self._child_s)
        return False


class Tracer:
    """Span recorder: ring buffer of events + exact per-name aggregates."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.enabled = enabled
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        # (name, cat) -> [count, total_s, self_s]; exact even on overflow
        self._agg: Dict[Any, List[float]] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._threads: Dict[int, str] = {}
        self._epoch = perf_counter()
        self._pid = os.getpid()

    # ---- recording ----
    def span(self, name: str, cat: str = "host", **args) -> Any:
        """Open a span; returns a context manager.  No-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return Span(self, name, cat, args or None)

    def record(self, name: str, t0: float, t1: float, cat: str = "host",
               **args) -> None:
        """Record an already-closed span from external ``perf_counter``
        stamps (e.g. a request's queue wait measured between its submit
        and admit stamps).  No stack interaction: the span never nests,
        so its self time equals its duration, and — unlike ``span()`` —
        it does not subtract from any live parent span.  Use ``cat`` to
        pick the attribution bucket (``"queue"`` spans are reported
        outside the wall-clock sum: a request waiting overlaps other
        requests decoding)."""
        if not self.enabled:
            return
        dur = t1 - t0
        tid = threading.get_ident()
        t = threading.current_thread()
        key = (name, cat)
        with self._lock:
            self._threads.setdefault(tid, t.name)
            self._ring.append((name, cat, tid, t0, t1, args or None))
            agg = self._agg.get(key)
            if agg is None:
                self._agg[key] = [1, dur, dur]
            else:
                agg[0] += 1
                agg[1] += dur
                agg[2] += dur

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
            t = threading.current_thread()
            with self._lock:
                self._threads[t.ident] = t.name
        return stack

    def _record(self, span: Span, dur: float, self_s: float) -> None:
        tid = threading.get_ident()
        key = (span.name, span.cat)
        with self._lock:
            self._ring.append((span.name, span.cat, tid, span.t0, span.t1,
                               span.args))
            agg = self._agg.get(key)
            if agg is None:
                self._agg[key] = [1, dur, self_s]
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
        """Drop recorded events and aggregates (enabled flag unchanged)."""
        with self._lock:
            self._ring.clear()
            self._agg.clear()
            self._epoch = perf_counter()

    # ---- inspection / export ----
    def events(self) -> List[Dict[str, Any]]:
        """Finished spans still in the ring buffer, oldest first."""
        with self._lock:
            raw = list(self._ring)
        return [{"name": n, "cat": c, "tid": tid, "t0": t0, "t1": t1,
                 "args": args} for n, c, tid, t0, t1, args in raw]

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

    def chrome_trace(self) -> Dict[str, Any]:
        """Trace Event Format dict (load in chrome://tracing / Perfetto)."""
        events: List[Dict[str, Any]] = []
        with self._lock:
            raw = list(self._ring)
            threads = dict(self._threads)
            epoch = self._epoch
        for name, cat, tid, t0, t1, args in raw:
            ev: Dict[str, Any] = {
                "name": name, "cat": cat, "ph": "X", "pid": self._pid,
                "tid": tid, "ts": (t0 - epoch) * 1e6,
                "dur": (t1 - t0) * 1e6}
            if args:
                ev["args"] = args
            events.append(ev)
        for tid, tname in threads.items():
            events.append({"name": "thread_name", "ph": "M",
                           "pid": self._pid, "tid": tid,
                           "args": {"name": tname}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
