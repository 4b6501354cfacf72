"""Serving observability (host-only): span tracing and typed metrics."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsView
from .tracer import Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
           "Span", "Tracer"]
