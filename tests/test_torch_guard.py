"""The numeric guard of the PyTorch port vs the JAX package's, at float32 on
paper-edge smoke under ``paper_edge_p8`` (two real rungs: posit16, then
full precision).

``fallback_ladder`` equals the reference's for every preset.  A
``poison_logits`` fault with ``fixed_by_level=2`` gives the port and the
reference the same token streams, the same ``guard.*`` counters, the same
``level(uid)`` and the same ``faults.events`` on the synchronous ``serve``
path, in the ring and the paged layout (the paged one also with a posit8
KV pool).  A rung serves its own weights, hoisted from the raw parameters
under its policy: its replaced row equals
a ``decode_step`` at the rung's policy from the pre-round state, and not
one through the engine's posit8-hoisted weights.  Ladder exhaustion fails
one request only."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.transprecision import PRESETS as J_PRESETS  # noqa: E402
from repro.serve import FaultPlan as JFaultPlan  # noqa: E402
from repro.serve import Fault as JFault  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import RetryPolicy as JRetryPolicy  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import fallback_ladder as j_ladder  # noqa: E402
from repro_torch.core.transprecision import PRESETS  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve import (Fault, FaultPlan, Request,  # noqa: E402
                               RetryPolicy, ServeConfig, ServingEngine,
                               SpeculativeEngine, fallback_ladder)
from repro_torch.serve.guard import GuardConfig, pre_round  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402

POLICY = "paper_edge_p8"
LAYOUTS = {"ring": dict(max_batch=2, max_len=64),
           "paged": dict(max_batch=2, max_len=64, kv_layout="paged",
                         page_size=8, page_overcommit=True),
           "paged_posit8": dict(max_batch=2, max_len=64, kv_layout="paged",
                                page_size=8, page_overcommit=True,
                                kv_format="posit8")}
_ROLES = ("name", "attn_weights", "mlp_weights", "embed_weights",
          "activations", "kv_cache", "kv_format", "kv_layout",
          "kv_page_size", "packed_kv", "layer_overrides", "node_overrides")


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_fallback_ladder_equals_reference(preset):
    t, j = fallback_ladder(PRESETS[preset]), j_ladder(J_PRESETS[preset])
    assert [[getattr(r, k) for k in _ROLES] for r in t] \
        == [[getattr(r, k) for k in _ROLES] for r in j]
    assert len(t) >= 1


def test_fallback_ladder_shapes():
    ladder = fallback_ladder(PRESETS["paper_edge_p8"])
    assert len(ladder) == 2                  # posit16 rung, then full
    assert ladder[0].attn_weights == "posit16_2"
    assert ladder[1].attn_weights is None
    for rung in ladder:                      # KV settings never move
        assert rung.kv_format == PRESETS["paper_edge_p8"].kv_format
        assert rung.kv_layout == PRESETS["paper_edge_p8"].kv_layout
    (retry_rung,) = fallback_ladder(PRESETS["bf16"])
    assert retry_rung.attn_weights is None
    assert "guard_retry" in retry_rung.name


@pytest.fixture(scope="module")
def model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (4, 11, 7, 5, 9, 6)]
    return jc, tc, jp, tp, prompts


def _serve_both(model, layout, specs, max_new=10, n=2):
    """Serve ``n`` prompts through the reference's and the port's guarded
    engines with the fault ``specs``; returns [(engine, requests)] for
    (reference, port)."""
    jc, tc, jp, tp, prompts = model
    out = []
    for eng_cls, cfg_cls, req_cls, plan_cls, fault_cls, retry_cls, cfg, \
            params, kw in (
                (JServingEngine, JServeConfig, JRequest, JFaultPlan, JFault,
                 JRetryPolicy, jc, jp, {}),
                (ServingEngine, ServeConfig, Request, FaultPlan, Fault,
                 RetryPolicy, tc, tp, {"device": "cpu"})):
        plan = plan_cls(tuple(fault_cls(**d) for d in specs))
        eng = eng_cls(cfg, params, cfg_cls(**LAYOUTS[layout]),
                      policy=POLICY, faults=plan, guard=True,
                      retry=retry_cls(backoff_s=0.001, max_backoff_s=0.01),
                      **kw)
        reqs = [req_cls(uid=i, prompt=np.asarray(p, np.int32),
                        max_new=max_new) for i, p in enumerate(prompts[:n])]
        eng.serve(reqs)
        out.append((eng, reqs))
    return out


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def poisoned(request, model):
    spec = [dict(kind="poison_logits", at=3, slot=0, fixed_by_level=2),
            dict(kind="stage_error", stage="generate", at=5)]
    return request.param, _serve_both(model, request.param, spec)


def _guard_counters(eng):
    c = eng.metrics.snapshot()["counters"]
    return {k: int(v) for k, v in c.items() if k.startswith("guard.")}


def test_poisoned_streams_equal_reference(poisoned):
    _, ((je, jr), (te, tr)) = poisoned
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and r.error is None for r in tr)
    assert all(len(r.out_tokens) == 10 for r in tr)


def test_guard_counters_and_levels_equal_reference(poisoned):
    _, ((je, jr), (te, tr)) = poisoned
    assert _guard_counters(te) == _guard_counters(je) == {
        "guard.nonfinite_rows": 1, "guard.quarantined": 1,
        "guard.fallbacks": 2, "guard.exhausted": 0}
    (uid,) = te.faults.uids_poisoned
    assert te.faults.uids_poisoned == je.faults.uids_poisoned
    assert te.guard.level(uid) == je.guard.level(uid) == 2
    assert [te.guard.level(r.uid) for r in tr] \
        == [je.guard.level(r.uid) for r in jr]
    # both rungs were built; each serves its own hoisted weights
    assert sorted(te.guard._rungs) == [1, 2]
    c = te.metrics.snapshot()["counters"]
    assert c["stage.guard1.generate.calls"] == 1
    assert c["stage.guard2.generate.calls"] == 1
    if te.paged:
        assert te.allocator.live_pages == 0
        te.allocator.assert_consistent()


def test_sync_serve_fault_events_equal_reference(poisoned):
    _, ((je, _), (te, _)) = poisoned
    assert te.faults.events == je.faults.events
    kinds = [e["kind"] for e in te.faults.events]
    assert kinds == ["poison_logits", "stage_error"]
    c = te.metrics.snapshot()["counters"]
    assert c["stage.retries"] == 1 and c["faults.injected"] == 2


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("level", [1, 2])
def test_rung_row_equals_decode_step_at_rung_policy(model, layout, level):
    """The replaced row is a decode step at the rung's policy from the
    pre-round state, through the rung's own weights (the reference's
    per-call weight hook on the raw parameters gives the same values);
    the engine's posit8-hoisted weights would give another row."""
    _, tc, _, tp, prompts = model
    eng = ServingEngine(tc, tp, ServeConfig(**LAYOUTS[layout]),
                        policy=POLICY, device="cpu", guard=True)
    eng.add_requests([Request(uid=i, prompt=np.asarray(p), max_new=20)
                      for i, p in enumerate(prompts[:2])])
    for _ in range(3):
        eng.step()
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    eng.cache["tok"] = torch.from_numpy(eng.last_tok)
    prev = dict(eng.cache)
    kept = pre_round(prev)                 # an independent copy
    eng.cache, logits = eng.engine.generate(eng.params, eng.cache)
    logits = np.array(logits.float().numpy(), copy=True)
    first = logits[1].copy()
    logits[0] = np.nan
    eng.guard.check_round(prev, logits, active, {0: Fault(
        "poison_logits", fixed_by_level=level)})
    assert eng.guard.level(eng.slot_req[0].uid) == level
    np.testing.assert_array_equal(logits[1], first)   # neighbour untouched
    rung = eng.guard.ladder[level - 1]
    want, _ = serve_model.decode_step(tp, kept, kept["tok"], tc, rung)
    np.testing.assert_allclose(logits[0], want[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    hoisted, _ = serve_model.decode_step(eng.params, pre_round(prev),
                                         prev["tok"], tc,
                                         lm.weights_free(rung))
    assert float(np.abs(hoisted[0].numpy() - logits[0]).max()) > 1e-3
    # the main cache kept the original round: pos advanced once
    assert torch.equal(eng.cache["pos"][active], prev["pos"][active] + 1)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_ladder_exhaustion_fails_one_request(model, layout):
    _, tc, _, tp, prompts = model
    plan = FaultPlan((Fault("poison_logits", at=3, slot=0,
                            fixed_by_level=99),))
    eng = ServingEngine(tc, tp, ServeConfig(**LAYOUTS[layout]),
                        policy=POLICY, device="cpu", faults=plan,
                        guard=True)
    reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new=10)
            for i, p in enumerate(prompts[:2])]
    eng.serve(reqs)
    (uid,) = eng.faults.uids_poisoned
    bad = next(r for r in reqs if r.uid == uid)
    good = next(r for r in reqs if r.uid != uid)
    assert bad.done and "precision-fallback ladder" in bad.error
    assert good.done and good.error is None and len(good.out_tokens) == 10
    assert eng.metrics.snapshot()["counters"]["guard.exhausted"] == 1
    assert all(r is None for r in eng.slot_req)
    if eng.paged:
        assert eng.allocator.live_pages == 0
        eng.allocator.assert_consistent()


def test_guard_config_and_engines_without_a_guard(model):
    _, tc, _, tp, _ = model
    scfg = ServeConfig(max_batch=2, max_len=32)
    eng = ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu",
                        guard=GuardConfig(max_levels=1))
    assert len(eng.guard.ladder) == 1 and eng.raw_params is not None
    plain = ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu")
    assert plain.guard is None and plain.raw_params is None
    with pytest.raises(ValueError, match="at least one ladder level"):
        ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu",
                      guard=GuardConfig(ladder=()))
    with pytest.raises(ValueError, match="numeric guard"):
        SpeculativeEngine(tc, tp, scfg, device="cpu", guard=True)
    ladder = dataclasses.replace(PRESETS["bf16"], name="x")
    eng = ServingEngine(tc, tp, scfg, device="cpu",
                        guard=GuardConfig(ladder=(ladder,)))
    assert eng.guard.ladder == (ladder,)
