"""Serving observability (host-only): span tracing, typed metrics, the
per-stage wall-clock attribution and the modeled energy per token
(``EnergyAccountant``: each stage's work counted on meta tensors, priced
with the paper's TALU per-MAC PDP and a DRAM pJ/byte constant, times the
live per-stage call counters)."""
from .energy import EnergyAccountant, StageEnergy, format_energy
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, StatsView
from .report import format_breakdown, stage_breakdown
from .tracer import Span, Tracer

__all__ = ["Counter", "EnergyAccountant", "Gauge", "Histogram",
           "MetricsRegistry", "StageEnergy", "StatsView", "Span", "Tracer",
           "format_breakdown", "format_energy", "stage_breakdown"]
