"""Chaos suite of the PyTorch port: the invariants of ``tests/test_chaos.py``
under deterministic fault injection (``repro_torch.serve.faults``), on the
port's paged-overcommit engine at float32 on paper-edge smoke.

1. **no hangs** — every submitted request reaches a terminal state within
   a bounded wait, under benign AND lethal fault plans;
2. **no leaks** — the page allocator drains to zero live pages and passes
   ``assert_consistent()`` after every scenario;
3. **no blast radius** — streams whose requests were never faulted are
   token-identical to a fault-free run.

Plus the per-failure-mode scenarios: transient-retry identity, persistent
error containment, pool-dry eviction, deadline, cancel, the tokenize /
detok / scheduler crashes, the stuck-scheduler watchdog and leaked-thread
detection in ``close``.  The retry and pool-dry cases run the synchronous
``serve`` path, which is deterministic: their ``faults.events`` equal the
reference engine's on the same prompts."""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import Fault as JFault  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import RetryPolicy as JRetryPolicy  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve import (Fault, FaultPlan, InjectedFault,  # noqa: E402
                               Orchestrator, OrchestratorConfig, Request,
                               RetryPolicy, ServeConfig, ServingEngine,
                               StreamingRequest)
from test_torch_serve import smoke_pair  # noqa: E402

MAX_LEN = 64
POLICY = "paper_edge_p8"        # 2 real guard rungs (posit16 -> full)
RETRY = RetryPolicy(backoff_s=0.001, max_backoff_s=0.01)
SCFG = dict(max_batch=2, max_len=MAX_LEN, kv_layout="paged", page_size=8,
            page_overcommit=True)


@pytest.fixture(scope="module")
def smoke_model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n).tolist()
               for n in (4, 11, 7, 5, 9, 6)]
    return jc, tc, jp, tp, prompts


def _engine(model, **kw):
    """Paged-overcommit engine (the layout every fault kind can hit:
    pool_dry needs overcommit's evict-don't-raise semantics)."""
    _, tc, _, tp, _ = model
    kw.setdefault("policy", POLICY)
    return ServingEngine(tc, tp, ServeConfig(**SCFG), device="cpu", **kw)


def _requests(prompts, max_new, cls=Request):
    return [cls(uid=i, prompt=np.asarray(p, np.int32), max_new=max_new)
            for i, p in enumerate(prompts)]


_BASELINES = {}


def _baseline(model, n, max_new):
    """Fault-free greedy token streams of the first ``n`` prompts."""
    key = (n, max_new)
    if key not in _BASELINES:
        reqs = _requests(model[4][:n], max_new)
        _engine(model).serve(reqs)
        assert all(r.done and r.error is None for r in reqs)
        _BASELINES[key] = [list(r.out_tokens) for r in reqs]
    return _BASELINES[key]


def _assert_drained(eng):
    """Invariant 2: zero live pages + a consistent allocator."""
    assert eng.allocator.live_pages == 0
    eng.allocator.assert_consistent()


def _reference_events(model, specs, n, max_new):
    """The reference engine's synchronous serve under ``specs``: its
    streams and fired-fault events."""
    jc, _, jp, _, prompts = model
    plan = JFaultPlan(tuple(JFault(**d) for d in specs))
    eng = JServingEngine(jc, jp, JServeConfig(**SCFG), policy=POLICY,
                         faults=plan, retry=JRetryPolicy(
                             backoff_s=0.001, max_backoff_s=0.01))
    reqs = _requests(prompts[:n], max_new, JRequest)
    eng.serve(reqs)
    return [list(r.out_tokens) for r in reqs], eng.faults.events


# ---------------------------------------------------------------------------
# the headline invariants, over seeded random schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_chaos_invariants(smoke_model, seed):
    prompts = smoke_model[4]
    max_new = 10
    ref = _baseline(smoke_model, len(prompts), max_new)

    plan = FaultPlan.random(seed, n=6, rounds=25, slots=2)
    eng = _engine(smoke_model, faults=plan, retry=RETRY, guard=True)
    sreqs = [StreamingRequest(p, max_new=max_new) for p in prompts]
    with Orchestrator(eng, OrchestratorConfig()) as orch:
        for s in sreqs:
            assert orch.submit(s, timeout=60.0)
        for s in sreqs:                      # invariant 1: no hangs
            assert s.wait(120.0), "request never reached a terminal state"
    _assert_drained(eng)                     # invariant 2: no leaks
    # benign plans: every fault kind is recoverable, so no errors at all
    assert all(s.error is None for s in sreqs), [s.error for s in sreqs]
    assert all(len(s.out_tokens) == max_new for s in sreqs)
    # invariant 3: un-faulted streams are token-identical to fault-free
    poisoned = eng.faults.uids_poisoned
    clean = [i for i, s in enumerate(sreqs) if s._req.uid not in poisoned]
    assert clean, "seeded plan poisoned every stream; weaken the plan"
    for i in clean:
        assert sreqs[i].out_tokens == ref[i], \
            f"un-faulted stream {i} diverged from the fault-free run"
    if poisoned:     # poisoned streams recovered through the guard
        assert eng.metrics.snapshot()["counters"]["guard.fallbacks"] > 0


def test_seeded_lethal_chaos_terminates_everything(smoke_model):
    """Lethal plans (loop crashes, persistent errors): every submitted
    stream terminal, no leaks."""
    plan = FaultPlan.random(7, n=8, rounds=20, slots=2, lethal=True)
    eng = _engine(smoke_model, faults=plan, retry=RETRY, guard=True)
    orch = Orchestrator(eng, OrchestratorConfig())
    submitted = []
    for s in [StreamingRequest(p, max_new=10) for p in smoke_model[4]]:
        try:
            if orch.submit(s, timeout=60.0):
                submitted.append(s)
        except RuntimeError:
            break                            # containment beat us to it
    for s in submitted:
        assert s.wait(120.0), "request never reached a terminal state"
    try:
        orch.close()
    except RuntimeError:
        pass                                 # leaked-thread report is ok
    _assert_drained(eng)


# ---------------------------------------------------------------------------
# per-failure-mode scenarios
# ---------------------------------------------------------------------------

def test_transient_retry_token_identity(smoke_model):
    """Transient stage errors are absorbed by bounded retry and the output
    is bit-identical to the fault-free run; the fired faults equal the
    reference engine's."""
    specs = [dict(kind="stage_error", stage="generate", at=1, count=2),
             dict(kind="stage_error", stage="prefill", at=1),
             dict(kind="stage_error", stage="insert", at=2)]
    ref = _baseline(smoke_model, 4, 8)
    eng = _engine(smoke_model, faults=FaultPlan(tuple(
        Fault(**d) for d in specs)), retry=RETRY)
    reqs = _requests(smoke_model[4][:4], 8)
    eng.serve(reqs)
    assert [r.out_tokens for r in reqs] == ref
    c = eng.metrics.snapshot()["counters"]
    assert c["stage.retries"] >= 4 and c["faults.injected"] == 4
    _assert_drained(eng)
    j_streams, j_events = _reference_events(smoke_model, specs, 4, 8)
    assert eng.faults.events == j_events
    assert j_streams == ref


def test_persistent_stage_error_is_contained(smoke_model):
    """A non-transient stage failure kills the scheduler loop; containment
    finishes every stream with an error and the engine drains clean."""
    plan = FaultPlan((Fault("stage_error", stage="generate", at=2,
                            transient=False),))
    eng = _engine(smoke_model, faults=plan, retry=RETRY)
    orch = Orchestrator(eng, OrchestratorConfig())
    sreqs = [StreamingRequest(p, max_new=50) for p in smoke_model[4][:4]]
    submitted = [s for s in sreqs if orch.submit(s, timeout=60.0)]
    for s in submitted:
        assert s.wait(120.0)
    assert all(s.error for s in submitted)
    assert not orch.healthy
    assert isinstance(orch.worker_exc, InjectedFault)
    with pytest.raises(RuntimeError, match="unhealthy"):
        orch.submit(StreamingRequest(smoke_model[4][0]))
    orch.close()
    _assert_drained(eng)


def test_poison_quarantine_precision_fallback(smoke_model):
    """A NaN-poisoned slot is re-decoded up the ladder: the stream
    completes without error and the neighbour stays token-identical to
    the fault-free run."""
    ref = _baseline(smoke_model, 2, 10)
    plan = FaultPlan((Fault("poison_logits", at=3, slot=0,
                            fixed_by_level=2),))
    eng = _engine(smoke_model, faults=plan, retry=RETRY, guard=True)
    reqs = _requests(smoke_model[4][:2], 10)
    eng.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    c = eng.metrics.snapshot()["counters"]
    assert c["guard.nonfinite_rows"] == 1
    assert c["guard.fallbacks"] == 2         # rung 1 still NaN, rung 2 fixes
    assert c["guard.exhausted"] == 0
    (poisoned_uid,) = eng.faults.uids_poisoned
    assert eng.guard.level(poisoned_uid) == 2
    clean = [r for r in reqs if r.uid != poisoned_uid]
    assert [r.out_tokens for r in clean] == [ref[r.uid] for r in clean]
    _assert_drained(eng)


def test_pool_dry_fault_evicts_and_recovers(smoke_model):
    """An injected dry pool mid-growth evicts the newest sequence;
    recompute-on-readmit keeps every stream identical to fault-free, and
    the fired faults equal the reference engine's."""
    # alloc calls 0/1 are the two admissions, so call 2 is the first
    # mid-decode growth alloc: the eviction path
    specs = [dict(kind="pool_dry", at=2, count=2)]
    ref = _baseline(smoke_model, 4, 10)
    eng = _engine(smoke_model, faults=FaultPlan((Fault(**specs[0]),)),
                  retry=RETRY)
    reqs = _requests(smoke_model[4][:4], 10)
    stats = eng.serve(reqs)
    assert stats["evictions"] >= 1
    assert [r.out_tokens for r in reqs] == ref
    _assert_drained(eng)
    j_streams, j_events = _reference_events(smoke_model, specs, 4, 10)
    assert eng.faults.events == j_events
    assert j_streams == ref


def test_deadline_expiry_reclaims_slot(smoke_model):
    prompts = smoke_model[4]
    eng = _engine(smoke_model)
    orch = Orchestrator(eng, OrchestratorConfig(deadline_s=0.05))
    doomed = StreamingRequest(prompts[0], max_new=100_000)
    assert orch.submit(doomed)
    assert doomed.wait(60.0)
    assert doomed.error == "deadline"
    # the freed slot serves later requests normally (no deadline)
    ok = StreamingRequest(prompts[1], max_new=6, deadline_s=120.0)
    assert orch.submit(ok)
    assert ok.wait(60.0) and ok.error is None and len(ok.out_tokens) == 6
    assert orch.stats["deadline_expired"] == 1
    orch.close()
    _assert_drained(eng)


def test_cancel_mid_decode(smoke_model):
    eng = _engine(smoke_model)
    orch = Orchestrator(eng, OrchestratorConfig())
    s = StreamingRequest(smoke_model[4][0], max_new=100_000)
    assert orch.submit(s)
    while not s.out_tokens:                   # genuinely mid-decode
        time.sleep(0.005)
    s.cancel()
    assert s.wait(60.0)
    assert s.error == "cancelled" and s.cancelled
    assert 0 < len(s.out_tokens) < 100_000
    lc = s.lifecycle()
    assert "submit" in lc and "finish" in lc and "first_token" in lc
    assert orch.stats["cancelled"] == 1
    orch.close()
    _assert_drained(eng)


def test_detok_crash_containment(smoke_model):
    plan = FaultPlan((Fault("detok_crash", at=1),))
    eng = _engine(smoke_model, faults=plan)
    orch = Orchestrator(eng, OrchestratorConfig())
    sreqs = [StreamingRequest(p, max_new=30) for p in smoke_model[4][:4]]
    submitted = [s for s in sreqs if orch.submit(s, timeout=60.0)]
    for s in submitted:
        assert s.wait(120.0), "stream stranded behind a dead detokenizer"
    assert not orch.healthy
    h = orch.health()
    assert h["worker_exc"] and "detok" in h["error"]
    orch.close()
    _assert_drained(eng)


def test_tokenize_crash_containment(smoke_model):
    plan = FaultPlan((Fault("tokenize_crash", at=1),))
    eng = _engine(smoke_model, faults=plan)
    orch = Orchestrator(eng, OrchestratorConfig())
    sreqs = [StreamingRequest(p, max_new=8) for p in smoke_model[4][:4]]
    submitted = [s for s in sreqs if orch.submit(s, timeout=60.0)]
    for s in submitted:
        assert s.wait(120.0), "stream stranded after a tokenize crash"
    # the crash victim carries the tokenize error, the rest the
    # containment error — nobody hangs
    assert any("tokenize failed" in (s.error or "") for s in submitted)
    assert not orch.healthy
    orch.close()
    _assert_drained(eng)


def test_sched_crash_health_and_exit_propagation(smoke_model):
    plan = FaultPlan((Fault("sched_crash", at=3),))
    eng = _engine(smoke_model, faults=plan)
    with pytest.raises(RuntimeError, match="worker crashed") as ei:
        with Orchestrator(eng, OrchestratorConfig()) as orch:
            sreqs = [StreamingRequest(p, max_new=50)
                     for p in smoke_model[4][:4]]
            submitted = []
            for s in sreqs:
                try:
                    if orch.submit(s, timeout=60.0):
                        submitted.append(s)
                except RuntimeError:
                    break
            for s in submitted:
                assert s.wait(120.0)
            orch._sched.join(30.0)          # let the dying loop finish
            assert not orch._sched.is_alive()
            h = orch.health()
            assert not h["healthy"] and h["in_flight"] == 0
            assert h["threads"]["orch-scheduler"] is False
            assert set(h["threads"]) == {"orch-scheduler", "orch-detok"}
            assert h["engine"]["live_pages"] == 0
    assert isinstance(ei.value.__cause__, InjectedFault)
    _assert_drained(eng)


def test_watchdog_fails_stuck_scheduler(smoke_model):
    """A 2 s injected straggler against a 0.2 s watchdog: in-flight
    requests fail fast instead of hanging for the stage duration."""
    plan = FaultPlan((Fault("stage_delay", stage="generate", at=2,
                            delay_s=2.0),))
    eng = _engine(smoke_model, faults=plan)
    orch = Orchestrator(eng, OrchestratorConfig(watchdog_s=0.2))
    s = StreamingRequest(smoke_model[4][0], max_new=300)
    assert orch.submit(s)
    t0 = time.perf_counter()
    assert s.wait(60.0)
    assert time.perf_counter() - t0 < 1.9    # failed before the stall ended
    assert "watchdog" in s.error
    assert not orch.healthy
    assert orch.stats["watchdog_fired"] == 1
    orch.close()                             # straggler finishes inside 60s
    assert not orch._sched.is_alive() and not orch._wd.is_alive()
    _assert_drained(eng)


def test_close_raises_on_leaked_threads(smoke_model):
    plan = FaultPlan((Fault("stage_delay", stage="generate", at=2,
                            delay_s=3.0),))
    eng = _engine(smoke_model, faults=plan)
    orch = Orchestrator(eng, OrchestratorConfig())
    s = StreamingRequest(smoke_model[4][0], max_new=300)
    assert orch.submit(s)
    while not s.out_tokens:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match="leaked threads"):
        orch.close(timeout=0.2)
    # drain the straggler so it cannot bleed into other tests
    orch._sched.join(30.0)
    orch._detok.join(30.0)
    assert not orch._sched.is_alive() and not orch._detok.is_alive()
