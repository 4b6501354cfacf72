"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU at
smoke size, synchronous and ``--async`` (through the orchestrator), with
``--fault-plan random:seed=3,n=6 --health`` on the paged-overcommit
layout, the speculative engine, the trace and metrics outputs and the
modeled energy table (``--energy``, sync, async and paged speculative); and
the stage breakdown, the tracer's events and its Chrome trace against the
JAX package's from identical recorded spans."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import format_breakdown as j_format  # noqa: E402
from repro.obs import stage_breakdown as j_breakdown  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.obs import (Tracer, format_breakdown,  # noqa: E402
                             stage_breakdown)

BASE = ["--device", "cpu", "--requests", "6", "--max-new", "6",
        "--batch", "2", "--max-len", "64"]
CHAOS = ["--kv-layout", "paged", "--overcommit", "--fault-plan",
         "random:seed=3,n=6", "--health"]


def _drained(eng):
    assert all(r is None for r in eng.slot_req)
    if eng.paged:
        assert eng.allocator.live_pages == 0
        eng.allocator.assert_consistent()


def test_sync_launch_with_fault_plan_and_health(capsys):
    out = launch.main(BASE + CHAOS)
    reqs = out["requests"]
    assert all(r.done and r.error is None for r in reqs)
    assert all(len(r.out_tokens) == 6 for r in reqs)
    h = out["health"]
    assert h["faults.injected"] == len(out["engine"].faults.events) > 0
    assert out["engine"].guard is not None
    _drained(out["engine"])
    printed = capsys.readouterr().out
    assert "health:" in printed and "stats:" in printed


def test_async_launch_with_fault_plan_and_health(capsys, tmp_path):
    log = tmp_path / "req.jsonl"
    out = launch.main(BASE + CHAOS + ["--async", "--watchdog-s", "30",
                                      "--deadline-s", "120",
                                      "--request-log", str(log),
                                      "--ttft-slo", "1e6",
                                      "--itl-slo", "1e6"])
    assert out["errors"] == {}
    assert len(out["submitted"]) == 6
    assert all(len(s.out_tokens) == 6 for s in out["streams"])
    h = out["health"]
    assert h["healthy"] and h["in_flight"] == 0 and h["error"] is None
    assert h["engine"]["live_pages"] == 0
    assert h["counters"]["orch.finished"] == 6
    assert h["counters"]["orch.slo.ttft_total"] == 6
    assert h["counters"]["orch.slo.ttft_violations"] == 0
    assert not any(t.is_alive() for t in (out["orchestrator"]._sched,
                                          out["orchestrator"]._detok))
    _drained(out["engine"])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(lines) == 6 and all(x["error"] is None for x in lines)
    printed = capsys.readouterr().out
    assert "TTFT p50/p99" in printed and "SLO:" in printed


@pytest.mark.parametrize("mode", [[], ["--async"]])
def test_speculative_launch_with_fault_plan(mode, capsys):
    out = launch.main(BASE + ["--speculative", "--gamma", "2",
                              "--fault-plan", "random:seed=3,n=6"] + mode)
    eng = out["engine"]
    assert eng.guard is None and eng.faults is not None
    assert eng.draft_engine.faults is eng.faults
    done = out["requests"] if not mode else out["streams"]
    assert all(len(r.out_tokens) == 6 for r in done)
    _drained(eng)
    if not mode:
        assert "speculative: gamma=2" in capsys.readouterr().out


def test_trace_and_metrics_outputs(tmp_path, capsys):
    trace, metrics = tmp_path / "t.json", tmp_path / "m.json"
    launch.main(BASE + ["--async", "--trace-out", str(trace),
                        "--metrics-json", str(metrics)])
    ev = json.loads(trace.read_text())["traceEvents"]
    names = {e["name"] for e in ev}
    assert {"generate.dispatch", "orch.step", "orch.detok",
            "thread_name"} <= names
    assert any(e.get("args", {}).get("kind") == "poll" for e in ev
               if e["name"] == "orch.idle")
    snap = json.loads(metrics.read_text())
    assert snap["counters"]["orch.finished"] == 6
    assert "stage.generate.dispatch_s" in snap["histograms"]
    assert "attributed" in capsys.readouterr().out


@pytest.mark.parametrize("mode", [[], ["--async"],
                                  ["--kv-layout", "paged", "--speculative",
                                   "--gamma", "2"]])
def test_energy_flag_prints_the_table(mode, capsys):
    out = launch.main(BASE + ["--energy"] + mode)
    bd = out["energy"]
    assert "errors" not in bd and bd["tokens"] == 36
    assert bd["joules_per_token"] > 0
    stages = {"prefill", "insert"} | ({"verify", "draft.generate"} if mode
                                      and mode[-1] == "2" else {"generate"})
    assert stages <= set(bd["stages"])
    printed = capsys.readouterr().out
    assert "energy (modeled: TALU Table IV, 20 pJ/B DRAM):" in printed
    assert all(f"  {name} " in printed for name in stages)


def _record_spans(tracer):
    """An identical recorded trace for both packages: engine stages
    (dispatch + device), host buckets, a concurrent detok span, queue
    waits, and a second category under one name."""
    spans = [("prefill.dispatch", "engine", 0.0, 0.010),
             ("prefill.device", "engine", 0.010, 0.030),
             ("generate.dispatch", "engine", 0.030, 0.032),
             ("generate.device", "engine", 0.032, 0.040),
             ("generate.dispatch", "engine", 0.040, 0.043),
             ("generate.device", "engine", 0.043, 0.050),
             ("guard1.generate.dispatch", "engine", 0.050, 0.051),
             ("guard1.generate.device", "engine", 0.051, 0.055),
             ("draft.generate.dispatch", "engine", 0.055, 0.056),
             ("host.sample", "host", 0.056, 0.057),
             ("orch.admit", "host", 0.057, 0.060),
             ("guard.redecode", "guard", 0.060, 0.061),
             ("orch.detok", "detok", 0.030, 0.045),
             ("queue.wait", "queue", 0.0, 0.020),
             ("queue.wait", "queue", 0.0, 0.035),
             ("pages.alloc", "alloc", 0.061, 0.0615),
             ("pages.alloc", "host", 0.0615, 0.062)]
    for name, cat, t0, t1 in spans:
        tracer.record(name, t0, t1, cat=cat, n=1)


@pytest.mark.parametrize("since", [False, True])
def test_stage_breakdown_equals_reference(since):
    jt, tt = JTracer(enabled=True), Tracer(enabled=True)
    base = None
    if since:
        for t in (jt, tt):
            t.record("generate.dispatch", 0.0, 0.5, cat="engine")
            t.record("orch.idle", 0.0, 0.25, cat="host")
        base = (jt.self_times(), tt.self_times())
    _record_spans(jt)
    _record_spans(tt)
    assert tt.self_times() == jt.self_times()
    jb = j_breakdown(jt, 0.07, since=base[0] if since else None)
    tb = stage_breakdown(tt, 0.07, since=base[1] if since else None)
    assert tb == jb
    assert format_breakdown(tb) == j_format(jb)
    assert set(tb["stages"]) >= {"prefill", "generate", "guard1.generate"}
    assert "orch.detok" in tb["concurrent"] and "queue.wait" in tb["queue"]


def test_tracer_events_chrome_trace_and_disabled_args():
    jt, tt = JTracer(capacity=4, enabled=True), Tracer(capacity=4,
                                                       enabled=True)
    for t in (jt, tt):
        with t.span("orch.admit", n=3):
            with t.span("guard.redecode", cat="guard", slot=1, uid=7):
                pass
        for i in range(4):
            t.record("queue.wait", 0.0, 0.001 * i, cat="queue", uid=i)
    strip = lambda evs: [(e["name"], e["cat"], e["args"])  # noqa: E731
                         for e in evs]
    assert strip(tt.events()) == strip(jt.events())   # ring of 4
    assert len(tt.events()) == 4
    assert tt.self_times()["orch.admit"]["count"] == 1
    ct, cj = tt.chrome_trace(), jt.chrome_trace()
    assert [sorted(e) for e in ct["traceEvents"]] \
        == [sorted(e) for e in cj["traceEvents"]]
    off = Tracer()
    with off.span("orch.idle", kind="poll"):        # no-op, no TypeError
        pass
    off.record("queue.wait", 0.0, 1.0, cat="queue", uid=1)
    assert off.events() == [] and off.self_times() == {}
