"""Per-stage wall-clock attribution from a span trace (port of
``repro.obs.report``).

Turns a :class:`~repro_torch.obs.tracer.Tracer`'s exact self-time
aggregates into a breakdown: for each engine stage (prefill / insert /
generate / verify / rollback, plus the ``draft.``-prefixed speculative
draft stages and the ``guard<k>.`` fallback rungs) the **host-dispatch**
time (the Python call, kernels queued) and the **device** time (the
``torch.cuda.synchronize`` wait that follows), plus the explicitly
measured host buckets (sampling, orchestrator segments, allocator work)
and the unattributed remainder.

Because the inputs are per-span *self* times (child spans subtracted,
see ``Tracer.self_times``), the buckets are disjoint by construction on
each thread: summing them never double-counts a ``generate`` dispatch
inside the ``orch.step`` loop segment that issued it.  Spans from the
detokenizer thread run concurrently with the scheduler and are reported
separately (``concurrent``), outside the wall-clock sum.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

# span categories whose work overlaps the scheduler thread rather than
# partitioning it (reported, but excluded from the attribution sum)
CONCURRENT_CATS = ("detok",)
# per-request wait categories: a request queue-waiting overlaps other
# requests' decode wall time, so the bucket is reported on its own
# (summable against per-request admit-submit stamps) but never added to
# the attribution sum — it would double-count the decode work it overlaps
QUEUE_CATS = ("queue",)

__all__ = ["stage_breakdown", "format_breakdown"]


def _sub(cur: Dict[str, Any], base: Optional[Dict[str, Any]]):
    """Aggregate delta ``cur - base`` (for windowed breakdowns)."""
    if not base:
        return cur
    out = {}
    for name, rec in cur.items():
        b = base.get(name)
        if b is None:
            out[name] = dict(rec)
            continue
        d = {"cat": rec["cat"], "count": rec["count"] - b["count"],
             "total_s": rec["total_s"] - b["total_s"],
             "self_s": rec["self_s"] - b["self_s"]}
        if d["count"] > 0 or d["total_s"] > 1e-12:
            out[name] = d
    return out


def stage_breakdown(tracer, wall_s: float, *,
                    since: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
    """Attribute ``wall_s`` seconds of serving to stages and host buckets.

    ``since`` is an earlier ``tracer.self_times()`` snapshot; passing it
    restricts the breakdown to the window since that snapshot (used by
    the load-sweep bench to keep one trace per run but one breakdown per
    load point).

    Returns::

        {"wall_s": ..., "stages": {stage: {"dispatch_s", "device_s",
         "calls"}}, "host": {bucket: seconds}, "concurrent": {...},
         "queue": {span: {"total_s", "count"}},
         "attributed_s": ..., "unattributed_s": ...,
         "attributed_frac": ...}

    ``queue`` holds per-request wait spans (``cat="queue"``, recorded by
    the engine from submit→admit stamps): summed seconds and span count
    per name, outside the attribution sum — N queued requests wait
    concurrently with each other and with the decode work the other
    buckets already cover, so adding them would overcount the wall.
    """
    agg = _sub(tracer.self_times(), since)
    stages: Dict[str, Dict[str, float]] = {}
    host: Dict[str, float] = {}
    concurrent: Dict[str, float] = {}
    queue: Dict[str, Dict[str, float]] = {}
    attributed = 0.0
    for name, rec in agg.items():
        if rec["cat"] == "engine":
            stage, _, kind = name.rpartition(".")
            s = stages.setdefault(stage, {"dispatch_s": 0.0,
                                          "device_s": 0.0, "calls": 0})
            if kind == "dispatch":
                s["dispatch_s"] += rec["self_s"]
                s["calls"] += rec["count"]
            else:
                s["device_s"] += rec["self_s"]
            attributed += rec["self_s"]
        elif rec["cat"] in QUEUE_CATS:
            q = queue.setdefault(name, {"total_s": 0.0, "count": 0})
            q["total_s"] += rec["total_s"]
            q["count"] += rec["count"]
        elif rec["cat"] in CONCURRENT_CATS:
            concurrent[name] = concurrent.get(name, 0.0) + rec["self_s"]
        else:
            host[name] = host.get(name, 0.0) + rec["self_s"]
            attributed += rec["self_s"]
    wall_s = max(wall_s, 1e-12)
    # spans can marginally overrun the measured wall window (e.g. the
    # orchestrator polls on either side of it); clamp the remainder at 0
    unattributed = max(wall_s - attributed, 0.0)
    return {"wall_s": wall_s,
            "stages": {k: {"dispatch_s": v["dispatch_s"],
                           "device_s": v["device_s"],
                           "calls": int(v["calls"])}
                       for k, v in sorted(stages.items())},
            "host": dict(sorted(host.items())),
            "concurrent": dict(sorted(concurrent.items())),
            "queue": {k: {"total_s": v["total_s"], "count": int(v["count"])}
                      for k, v in sorted(queue.items())},
            "attributed_s": attributed,
            "unattributed_s": unattributed,
            "attributed_frac": min(attributed / wall_s, 1.0)}


def format_breakdown(bd: Dict[str, Any]) -> str:
    """Human-readable table of a :func:`stage_breakdown` result."""
    wall = bd["wall_s"]
    lines = [f"{'stage':<22s} {'dispatch':>10s} {'device':>10s} "
             f"{'calls':>7s} {'% wall':>7s}"]
    for name, s in bd["stages"].items():
        tot = s["dispatch_s"] + s["device_s"]
        lines.append(f"{name:<22s} {s['dispatch_s'] * 1e3:>8.1f}ms "
                     f"{s['device_s'] * 1e3:>8.1f}ms {s['calls']:>7d} "
                     f"{100 * tot / wall:>6.1f}%")
    for name, v in bd["host"].items():
        lines.append(f"{name:<22s} {v * 1e3:>8.1f}ms {'':>10s} {'':>7s} "
                     f"{100 * v / wall:>6.1f}%")
    for name, v in bd["concurrent"].items():
        lines.append(f"{name + ' (conc.)':<22s} {v * 1e3:>8.1f}ms")
    for name, q in bd.get("queue", {}).items():
        lines.append(f"{name + ' (queue)':<22s} {q['total_s'] * 1e3:>8.1f}ms"
                     f" {'':>10s} {q['count']:>7d}")
    lines.append(f"{'(unattributed)':<22s} "
                 f"{bd['unattributed_s'] * 1e3:>8.1f}ms {'':>10s} {'':>7s} "
                 f"{100 * bd['unattributed_s'] / wall:>6.1f}%")
    lines.append(f"attributed {100 * bd['attributed_frac']:.1f}% of "
                 f"{wall * 1e3:.1f}ms wall")
    return "\n".join(lines)
