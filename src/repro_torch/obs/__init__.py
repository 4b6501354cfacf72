"""Serving observability (host-only): span tracing, typed metrics and the
per-stage wall-clock attribution."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsView
from .report import format_breakdown, stage_breakdown
from .tracer import Span, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "StatsView",
           "Span", "Tracer", "format_breakdown", "stage_breakdown"]
