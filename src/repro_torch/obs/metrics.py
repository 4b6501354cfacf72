"""Typed metrics registry: counters, gauges, log-bucketed histograms
(host-only copy of ``repro.obs.metrics``).

One shared, snapshot-able registry backs every ``stats`` dict of the
serving engine:

* ``Counter`` — monotonically increasing event count (``inc``); ``set``
  exists for benchmark warmup resets.
* ``Gauge`` — last-written value (queue depth, live pages, cache bytes).
* ``Histogram`` — log-bucketed latency distribution.  Buckets are
  geometric (ratio ``2**(1/8)`` by default, ~9 % wide), so p50/p95/p99
  come out within one bucket width of the exact sample percentile at any
  scale from sub-µs to hours while storing only a sparse dict of bucket
  counts; exact ``count``/``sum``/``min``/``max`` ride along.
* ``MetricsRegistry`` — typed get-or-create by name (requesting an
  existing name as a different type raises), JSON-able ``snapshot()``.
* ``StatsView`` — a MutableMapping facade that maps the engines' legacy
  ``stats["tokens"]``-style keys onto registry metrics, so the registry
  is the single source of truth.

Thread safety: mutations take a per-metric lock; all operations are
cheap enough for the serving hot loop (a counter ``inc`` is the same
order as the dict update it replaced).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterator, List, MutableMapping, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView"]

Number = Union[int, float]


class Counter:
    """Monotonic event counter (``set`` only for explicit resets)."""
    __slots__ = ("name", "_v", "_lock")
    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._v: Number = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._v += n

    def set(self, v: Number) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> Number:
        return self._v


class Gauge:
    """Last-written value."""
    __slots__ = ("name", "_v", "_lock")
    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._v: Number = 0
        self._lock = threading.Lock()

    def set(self, v: Number) -> None:
        with self._lock:
            self._v = v

    def inc(self, n: Number = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> Number:
        return self._v


class Histogram:
    """Log-bucketed histogram with percentile estimation.

    Bucket ``i`` covers ``[lo * ratio**i, lo * ratio**(i+1))``; values
    below ``lo`` (including 0) land in bucket -1, values past the top in
    the last bucket.  Percentiles interpolate within the bucket in log
    space and clamp to the exact observed [min, max], so the relative
    error is bounded by one bucket width (~``ratio - 1``)."""

    kind = "histogram"

    def __init__(self, name: str, lo: float = 1e-7, hi: float = 1e4,
                 ratio: float = 2.0 ** 0.125):
        if not (0 < lo < hi) or ratio <= 1:
            raise ValueError(f"bad histogram bounds lo={lo} hi={hi} "
                             f"ratio={ratio}")
        self.name = name
        self.lo, self.hi, self.ratio = lo, hi, ratio
        self._log_lo = math.log(lo)
        self._log_ratio = math.log(ratio)
        self._nbuckets = int(math.ceil((math.log(hi) - self._log_lo)
                                       / self._log_ratio))
        self._buckets: Dict[int, int] = {}
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def _index(self, x: float) -> int:
        if x < self.lo:
            return -1
        i = int((math.log(x) - self._log_lo) / self._log_ratio)
        return min(i, self._nbuckets - 1)

    def observe(self, x: Number) -> None:
        x = float(x)
        i = self._index(x)
        with self._lock:
            self._buckets[i] = self._buckets.get(i, 0) + 1
            self.count += 1
            self.sum += x
            if self.min is None or x < self.min:
                self.min = x
            if self.max is None or x > self.max:
                self.max = x

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-th percentile (q in [0, 100])."""
        with self._lock:
            if not self.count:
                return None
            buckets = sorted(self._buckets.items())
            count, mn, mx = self.count, self.min, self.max
        target = q / 100.0 * count
        seen = 0
        for i, c in buckets:
            if seen + c >= target:
                if i < 0:               # sub-lo bucket: all we know is < lo
                    return max(min(self.lo, mx), mn)
                # interpolate in log space within the bucket
                frac = (target - seen) / c
                log_v = (self._log_lo + (i + frac) * self._log_ratio)
                return min(max(math.exp(log_v), mn), mx)
            seen += c
        return mx

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            buckets = sorted(self._buckets.items())
            snap = {"count": self.count, "sum": self.sum,
                    "min": self.min, "max": self.max}
        snap.update(p50=self.percentile(50), p95=self.percentile(95),
                    p99=self.percentile(99),
                    buckets=[[i, c] for i, c in buckets],
                    lo=self.lo, hi=self.hi, ratio=self.ratio)
        return snap


class MetricsRegistry:
    """Typed, snapshot-able collection of named metrics."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Plain JSON-able dict: ``{"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, p50, p95, p99,
        buckets, ...}}}``."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for m in metrics:
            if isinstance(m, Counter):
                out["counters"][m.name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = m.value
            else:
                out["histograms"][m.name] = m.snapshot()
        return out

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any]) -> "MetricsRegistry":
        """Rebuild a registry whose ``snapshot()`` equals ``snap`` (the
        round trip is exact: histogram percentiles are derived from the
        restored bucket counts and min/max)."""
        reg = cls()
        for name, v in snap.get("counters", {}).items():
            reg.counter(name).set(v)
        for name, v in snap.get("gauges", {}).items():
            reg.gauge(name).set(v)
        for name, h in snap.get("histograms", {}).items():
            m = reg.histogram(name, lo=h.get("lo", 1e-7),
                              hi=h.get("hi", 1e4),
                              ratio=h.get("ratio", 2.0 ** 0.125))
            m.count = h["count"]
            m.sum = h["sum"]
            m.min = h["min"]
            m.max = h["max"]
            m._buckets = {int(i): int(c) for i, c in h.get("buckets", [])}
        return reg


class StatsView(MutableMapping):
    """Dict-like ``stats`` facade over registry metrics.

    Tests, benches and launchers read (and occasionally reset) the
    engine's ``stats`` keys.  A StatsView keeps that dict surface —
    ``stats["tokens"] += n``, ``stats.get("tokens", 0)``,
    ``stats.update(tokens=0)``, ``{**stats}`` — while each key is backed
    by a registry Counter or Gauge, so there is exactly one copy of every
    statistic."""

    def __init__(self, registry: MetricsRegistry, prefix: str = ""):
        self._registry = registry
        self._prefix = prefix
        self._bound: Dict[str, Any] = {}

    def bind(self, key: str, metric) -> None:
        """Expose registry ``metric`` under the ``stats`` key ``key``."""
        self._bound[key] = metric

    def bind_counters(self, *keys: str) -> None:
        for k in keys:
            self.bind(k, self._registry.counter(self._prefix + k))

    def bind_gauges(self, *keys: str) -> None:
        for k in keys:
            self.bind(k, self._registry.gauge(self._prefix + k))

    def metric_name(self, key: str) -> str:
        """Registry name backing the ``stats`` key ``key`` (for
        consistency checks)."""
        return self._bound[key].name

    def __getitem__(self, key: str) -> Number:
        return self._bound[key].value

    def __setitem__(self, key: str, value: Number) -> None:
        m = self._bound.get(key)
        if m is None:                      # late keys default to gauges
            m = self._registry.gauge(self._prefix + key)
            self._bound[key] = m
        m.set(value)

    def __delitem__(self, key: str) -> None:
        del self._bound[key]               # unbinds the view only

    def __iter__(self) -> Iterator[str]:
        return iter(self._bound)

    def __len__(self) -> int:
        return len(self._bound)

    def __repr__(self) -> str:
        return f"StatsView({dict(self)})"
