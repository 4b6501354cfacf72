"""Fault injection of the PyTorch port vs the JAX package's
(``repro_torch.serve.faults`` is a copy of ``repro.serve.faults``).

Seeded ``FaultPlan.random`` schedules and ``FaultPlan.parse`` specs equal
the reference's field by field, benign and lethal, over several seeds;
the injector counts calls per site and logs the same events for the same
call sequence; ``RetryPolicy.delay`` matches; the allocator's ``pool_dry``
and ``fork_fail`` hooks leave it consistent; a stage's retry re-runs only
transient failures, with the injection before the stage's function."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import paged as jpaged  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serve import faults as tfaults  # noqa: E402
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from repro_torch.serve.paged import PageAllocator  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def _fields(plan):
    return plan.seed, [dataclasses.asdict(f) for f in plan.faults]


@pytest.mark.parametrize("lethal", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 7, 12345])
def test_random_plan_equals_reference(seed, lethal):
    kw = dict(n=12, rounds=25, slots=2, lethal=lethal)
    t = tfaults.FaultPlan.random(seed, **kw)
    j = jfaults.FaultPlan.random(seed, **kw)
    assert _fields(t) == _fields(j)
    assert len(t.faults) == 12
    if not lethal:
        assert all(f.transient for f in t.faults if f.kind == "stage_error")


@pytest.mark.parametrize("spec", [
    "none", "", "random", "random:seed=3,n=6",
    "random:seed=3,n=5,rounds=10,slots=2",
    "random:seed=7,n=8,rounds=20,slots=2,lethal=1", "json"])
def test_parse_equals_reference(spec, tmp_path):
    if spec == "json":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps([
            {"kind": "stage_error", "stage": "generate", "at": 1},
            {"kind": "poison_logits", "slot": 1, "fixed_by_level": 2},
            {"kind": "pool_dry", "at": 4, "count": 2},
            {"kind": "stage_delay", "stage": "draft.generate",
             "delay_s": 0.5}]))
        spec = str(path)
    t, j = tfaults.FaultPlan.parse(spec), jfaults.FaultPlan.parse(spec)
    assert _fields(t) == _fields(j)
    assert t == tfaults.FaultPlan.parse(spec)          # deterministic


def test_fault_validation_and_sites_match_reference():
    for mod in (jfaults, tfaults):
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.Fault("meteor_strike")
        with pytest.raises(ValueError, match="stage site"):
            mod.Fault("stage_error")
    assert tfaults.KINDS == jfaults.KINDS
    for kind in tfaults.KINDS:
        stage = "verify" if kind.startswith("stage") else ""
        assert (tfaults.Fault(kind, stage=stage).site
                == jfaults.Fault(kind, stage=stage).site)
    assert (tfaults.FaultPlan.RANDOM_STAGES
            == jfaults.FaultPlan.RANDOM_STAGES)


def _drive(mod, plan):
    """One fixed call sequence over every hook; returns the injector,
    what each call did, and the counters."""
    m = MetricsRegistry()
    inj = mod.FaultInjector(plan, metrics=m)
    seen = []
    for n in range(6):
        for stage in ("prefill", "generate"):
            try:
                inj.on_stage(stage)
                seen.append((stage, n, "ok"))
            except mod.InjectedFault as e:
                seen.append((stage, n, e.kind, e.transient))
        seen.append(("alloc", n, inj.on_alloc(n + 1)))
        seen.append(("round", n, sorted(inj.poison_round({0: 10 + n,
                                                          1: 20 + n}))))
        for hook in ("on_tokenize", "on_detok", "on_sched", "on_fork"):
            try:
                getattr(inj, hook)()
                seen.append((hook, n, "ok"))
            except mod.InjectedFault as e:
                seen.append((hook, n, e.kind))
    return inj, seen, m


def test_injector_counts_calls_per_site_like_reference():
    specs = [dict(kind="stage_error", stage="generate", at=1, count=2),
             dict(kind="stage_error", stage="prefill", at=3,
                  transient=False),
             dict(kind="stage_delay", stage="generate", at=4,
                  delay_s=0.001),
             dict(kind="pool_dry", at=2, count=2),
             dict(kind="poison_logits", at=1, slot=1, fixed_by_level=2),
             dict(kind="poison_logits", at=3, slot=5),     # idle: no-op
             dict(kind="tokenize_crash", at=4), dict(kind="detok_crash"),
             dict(kind="sched_crash", at=5), dict(kind="fork_fail", at=2)]
    out = []
    for mod in (jfaults, tfaults):
        plan = mod.FaultPlan(tuple(mod.Fault(**d) for d in specs))
        out.append(_drive(mod, plan))
    (ji, jseen, _), (ti, tseen, tm) = out
    assert tseen == jseen
    assert ti.events == ji.events
    assert ti.uids_poisoned == ji.uids_poisoned == {21}
    assert ti._counters == ji._counters
    assert ti._counters["generate"] == 6 and ti._counters["round"] == 6
    c = tm.snapshot()["counters"]
    assert c["faults.injected"] == len(ti.events) == 11
    assert c["faults.stage_error"] == 3 and c["faults.pool_dry"] == 2
    # a fault fires on calls [at, at + count) only
    assert [e["call"] for e in ti.events if e["site"] == "generate"] \
        == [1, 2, 4]


@pytest.mark.parametrize("kw", [{}, dict(backoff_s=0.001,
                                         max_backoff_s=0.01),
                                dict(backoff_s=0.1, multiplier=3.0,
                                     max_backoff_s=2.0)])
def test_retry_policy_delay_equals_reference(kw):
    t, j = tfaults.RetryPolicy(**kw), jfaults.RetryPolicy(**kw)
    assert t.max_attempts == j.max_attempts == 4
    for k in range(10):
        assert t.delay(k) == j.delay(k)
    assert t.delay(9) == t.max_backoff_s


def test_pool_dry_alloc_matches_reference_and_stays_consistent():
    """``pool_dry`` makes calls 1 and 2 report a dry pool though pages are
    free; the allocator mutates nothing on them, exactly as the
    reference's does."""
    res = []
    for mod, alloc_mod in ((jfaults, jpaged), (tfaults, None)):
        inj = mod.FaultInjector(mod.FaultPlan((
            mod.Fault("pool_dry", at=1, count=2),)))
        m = MetricsRegistry()
        a = (alloc_mod.PageAllocator(9, 4, faults=inj) if alloc_mod
             else PageAllocator(9, 4, faults=inj, metrics=m))
        got = [a.alloc(n) for n in (2, 1, 3, 3, 3)]
        res.append((got, list(a._free), a._refs.tolist(), inj.events))
        if alloc_mod is None:
            a.assert_consistent()
            assert m.counter("pages.alloc_failures").value == 2
            for pages in got:
                if pages:
                    a.free(pages)
            assert a.live_pages == 0
            a.assert_consistent()
    assert res[0] == res[1]
    assert res[1][0][1] is None and res[1][0][2] is None
    assert [e["pages"] for e in res[1][3]] == [1, 3]


def test_injected_fork_failure_leaves_allocator_consistent():
    alloc = PageAllocator(8, 4, faults=tfaults.FaultInjector(
        tfaults.FaultPlan((tfaults.Fault("fork_fail", at=1),))))
    pages = alloc.alloc(3)
    forked = alloc.fork(pages)               # call 0: fine
    with pytest.raises(tfaults.InjectedFault):
        alloc.fork(pages)                    # call 1: injected failure
    # the failed fork mutated nothing: refcounts still cover exactly the
    # two owners, and a full free drains the pool
    alloc.assert_consistent()
    assert all(alloc.ref_count(p) == 2 for p in pages)
    alloc.free(forked)
    alloc.free(pages)
    assert alloc.live_pages == 0
    alloc.assert_consistent()


def test_assert_consistent_catches_corruption():
    alloc = PageAllocator(6, 4)
    pages = alloc.alloc(2)
    alloc.assert_consistent()
    alloc._refs[pages[0]] = 0                # a lost reference
    with pytest.raises(AssertionError, match="mismatch"):
        alloc.assert_consistent()
    alloc._refs[pages[0]] = 1
    alloc._free.append(alloc._free[-1])      # a double free
    with pytest.raises(AssertionError, match="duplicates"):
        alloc.assert_consistent()


def _stage_engine(faults=None, retry=None):
    cfg = get_config("paper-edge", smoke=True)
    return TransprecisionEngine(cfg, get_policy("bf16"), 2, 32,
                                device="cpu", metrics=MetricsRegistry(),
                                faults=faults, retry=retry)


@pytest.mark.parametrize("traced", [False, True])
def test_stage_retry_runs_injection_before_the_stage(traced):
    """Transient injected errors are retried with backoff and the stage's
    function runs once per successful attempt only: the injection fires
    before it, so a failed attempt writes nothing."""
    inj = tfaults.FaultInjector(tfaults.FaultPlan((
        tfaults.Fault("stage_error", stage="generate", at=0, count=2),)))
    eng = _stage_engine(inj, tfaults.RetryPolicy(backoff_s=0.0))
    if traced:
        from repro_torch.obs import Tracer
        eng.tracer = Tracer(enabled=True)
    calls = []
    assert eng._staged("generate", lambda x: calls.append(x) or x, 7) == 7
    assert calls == [7]
    c = eng.metrics.snapshot()["counters"]
    assert c["stage.retries"] == 2 and c["stage.generate.retries"] == 2
    assert c["stage.generate.calls"] == 1
    assert "stage.retry_exhausted" not in c
    assert [e["call"] for e in inj.events] == [0, 1]


def test_stage_retry_budget_and_persistent_errors_propagate():
    inj = tfaults.FaultInjector(tfaults.FaultPlan((
        tfaults.Fault("stage_error", stage="insert", at=0, count=9),
        tfaults.Fault("stage_error", stage="prefill", transient=False))))
    eng = _stage_engine(inj, tfaults.RetryPolicy(max_attempts=3,
                                                 backoff_s=0.0))
    calls = []
    with pytest.raises(tfaults.InjectedFault, match="transient"):
        eng._staged("insert", calls.append, 1)
    with pytest.raises(tfaults.InjectedFault, match="persistent"):
        eng._staged("prefill", calls.append, 2)
    assert calls == []
    c = eng.metrics.snapshot()["counters"]
    assert c["stage.retries"] == 2 and c["stage.retry_exhausted"] == 1
    # without a retry policy a transient error propagates at once
    eng = _stage_engine(tfaults.FaultInjector(tfaults.FaultPlan((
        tfaults.Fault("stage_error", stage="generate"),))))
    with pytest.raises(tfaults.InjectedFault):
        eng._staged("generate", calls.append, 3)
    assert eng._staged("generate", calls.append, 4) is None
    assert calls == [4]


def test_unarmed_stage_is_a_plain_call():
    eng = _stage_engine()
    assert eng.faults is None and eng.retry is None
    assert eng._staged("generate", np.add, 1, 2) == 3
    assert eng._invoke("generate", np.add, (2, 3)) == 5
