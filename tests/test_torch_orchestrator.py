"""The orchestrator of the PyTorch port: the invariants of
``tests/test_orchestrator.py`` on the port (backpressure, admission
timeouts, out-of-order completion, rejection, cancellation ordering,
lifecycle stamps, streaming-callback identity with the synchronous
``engine.serve`` loop), and the port's orchestrator against the JAX
package's at float32 on paper-edge smoke: equal streams in the ring and
paged layouts, and request-log lines with the reference's keys."""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import Orchestrator as JOrchestrator  # noqa: E402
from repro.serve import OrchestratorConfig as JOrchestratorConfig  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServingEngine as JServingEngine  # noqa: E402
from repro.serve import StreamingRequest as JStreamingRequest  # noqa: E402
from repro_torch.serve import (Orchestrator, OrchestratorConfig,  # noqa: E402
                               Request, ServeConfig, ServingEngine,
                               StreamingRequest)
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

MAX_LEN = 64
LAYOUTS = {"ring": {}, "paged": dict(kv_layout="paged", page_size=8,
                                     page_overcommit=True)}


@pytest.fixture(scope="module")
def smoke_model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n).tolist() for n in (4, 11, 7, 5)]
    return jc, tc, jp, tp, prompts


def _engine(model, max_batch=2, **kw):
    _, tc, _, tp, _ = model
    return ServingEngine(tc, tp, ServeConfig(max_batch=max_batch,
                                             max_len=MAX_LEN, **kw),
                         device="cpu")


def test_streams_and_callbacks_match_engine_serve(smoke_model):
    prompts = smoke_model[4]
    reqs = [Request(uid=i, prompt=np.asarray(p, np.int32), max_new=8)
            for i, p in enumerate(prompts)]
    _engine(smoke_model).serve(reqs)
    ref = [list(r.out_tokens) for r in reqs]

    got = {}

    def cb(sreq, ids, piece):
        got.setdefault(id(sreq), []).extend(ids)
        assert threading.current_thread().name == "orch-detok"
    with Orchestrator(_engine(smoke_model)) as orch:
        sreqs = [StreamingRequest(p, max_new=8, on_token=cb)
                 for p in prompts]
        for s in sreqs:
            assert orch.submit(s, timeout=60.0)
        for s in sreqs:
            assert s.wait(120.0)
    assert [s.out_tokens for s in sreqs] == ref
    assert [got[id(s)] for s in sreqs] == ref        # callback stream too
    for s in sreqs:
        assert s.error is None and s.ttft_s is not None
        assert len(s.token_t) == len(s.out_tokens)
        assert s.out_text                       # default byte detokenizer
    assert orch.stats["finished"] == len(sreqs)


def test_admission_timeout_backpressure(smoke_model):
    prompts = smoke_model[4]
    ocfg = OrchestratorConfig(max_queue=1)
    eng = _engine(smoke_model)
    # `a`'s decode ticks wait until `b`'s submit has returned: on a fast
    # host 32 smoke-model tokens take less than `b`'s 0.05 s timeout, and
    # `a` would finish and release its permit before `b` gave up
    b_tried = threading.Event()
    generate = eng.engine.generate

    def gated_generate(*args, **kw):
        assert b_tried.wait(60.0)
        return generate(*args, **kw)

    eng.engine.generate = gated_generate
    with Orchestrator(eng, ocfg) as orch:
        a = StreamingRequest(prompts[0], max_new=32)
        assert orch.submit(a, timeout=10.0)
        # the single in-flight permit is held until `a` finishes, so a
        # second submit must time out instead of growing the queue
        b = StreamingRequest(prompts[1], max_new=4)
        admitted = orch.submit(b, timeout=0.05)
        b_tried.set()
        assert not admitted
        assert orch.stats["admission_timeouts"] == 1
        assert a.wait(120.0)
        assert orch.submit(b, timeout=60.0)      # permit released
        assert b.wait(120.0)
    assert len(a.out_tokens) == 32 and len(b.out_tokens) == 4


def test_out_of_order_completion(smoke_model):
    prompts = smoke_model[4]
    with Orchestrator(_engine(smoke_model)) as orch:
        slow = StreamingRequest(prompts[0], max_new=48)
        fast = StreamingRequest(prompts[1], max_new=2)
        assert orch.submit(slow, timeout=30.0)
        assert orch.submit(fast, timeout=30.0)
        assert fast.wait(120.0)
        # submitted first, but still decoding when `fast` finished
        assert not slow.done
        assert slow.wait(120.0)
    assert len(fast.out_tokens) == 2 and len(slow.out_tokens) == 48


def test_never_admissible_request_is_rejected(smoke_model):
    with Orchestrator(_engine(smoke_model)) as orch:
        bad = StreamingRequest(list(range(MAX_LEN + 1)), max_new=4)
        assert orch.submit(bad, timeout=10.0)
        assert bad.wait(60.0)
    assert bad.error is not None and "max_len" in bad.error
    assert bad.out_tokens == []
    assert orch.stats["rejected"] == 1


def test_submit_after_close_raises(smoke_model):
    orch = Orchestrator(_engine(smoke_model))
    orch.close()
    with pytest.raises(RuntimeError, match="closed"):
        orch.submit(StreamingRequest(smoke_model[4][0]))


def test_text_prompt_roundtrip(smoke_model):
    with Orchestrator(_engine(smoke_model)) as orch:
        s = StreamingRequest("hello edge", max_new=4)
        assert orch.submit(s, timeout=30.0)
        assert s.wait(120.0)
    assert len(s.out_tokens) == 4
    assert len(s.out_text) > 0


def test_cancel_before_admission_and_after_finish(smoke_model):
    """A cancel set before the scheduler ever sees the request terminates
    it without engine work; a cancel after the stream finished is a
    no-op (the first terminal transition wins)."""
    prompts = smoke_model[4]
    with Orchestrator(_engine(smoke_model), OrchestratorConfig()) as orch:
        early = StreamingRequest(prompts[0], max_new=8)
        early.cancel()                       # cancelled while queued
        assert orch.submit(early, timeout=30.0)
        assert early.wait(60.0)
        assert early.error == "cancelled" and early.out_tokens == []

        done = StreamingRequest(prompts[1], max_new=4)
        assert orch.submit(done, timeout=30.0)
        assert done.wait(120.0)
        assert done.error is None
        done.cancel()                        # post-terminal: no-op
        assert done.error is None and len(done.out_tokens) == 4
    assert done.error is None


def test_lifecycle_stamps_on_every_terminal_path(smoke_model):
    """Every terminal path — finished, rejected, cancelled — carries
    monotonic submit/finish stamps; richer paths add the middle ones."""
    prompts = smoke_model[4]
    with Orchestrator(_engine(smoke_model), OrchestratorConfig()) as orch:
        ok = StreamingRequest(prompts[0], max_new=4)
        rej = StreamingRequest(list(range(MAX_LEN + 1)), max_new=4)
        can = StreamingRequest(prompts[1], max_new=8)
        can.cancel()
        for s in (ok, rej, can):
            assert orch.submit(s, timeout=30.0)
        for s in (ok, rej, can):
            assert s.wait(120.0)
    full = ok.lifecycle()
    assert list(full) == ["submit", "admit", "prefill_done",
                          "insert_done", "first_token", "finish"]
    assert list(full.values()) == sorted(full.values())
    d = ok.lifecycle_deltas()
    assert d["total_s"] >= d["ttft_s"] >= d["queue_wait_s"] >= 0
    for s in (rej, can):                      # terminal without decode
        lc = s.lifecycle()
        assert "submit" in lc and "finish" in lc
        assert lc["finish"] >= lc["submit"]
        assert "first_token" not in lc


def test_wait_vs_error_vs_done_ordering(smoke_model):
    """``wait`` returning True implies the terminal fields are already
    readable: done is set last, after error/out_tokens/finish_t."""
    eng = _engine(smoke_model, **LAYOUTS["paged"])
    with Orchestrator(eng, OrchestratorConfig(deadline_s=0.05)) as orch:
        s = StreamingRequest(smoke_model[4][0], max_new=100_000)
        assert orch.submit(s, timeout=30.0)
        assert s.wait(60.0)
        assert s.done and s.error == "deadline" and s.finish_t > 0
        assert s.lifecycle()["finish"] >= s.lifecycle()["submit"]
    assert eng.allocator.live_pages == 0


def _orchestrate(orch_cls, ocfg_cls, sreq_cls, eng, prompts, log):
    with orch_cls(eng, ocfg_cls(request_log=log)) as orch:
        sreqs = [sreq_cls(p, max_new=8) for p in prompts]
        for s in sreqs:
            assert orch.submit(s, timeout=60.0)
        for s in sreqs:
            assert s.wait(120.0)
    with open(log) as f:
        lines = [json.loads(line) for line in f]
    return sreqs, lines, orch.health()


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def both(request, smoke_model, tmp_path_factory):
    """The reference's and the port's orchestrators over the same prompts
    at float32, each writing a request log."""
    jc, tc, jp, tp, prompts = smoke_model
    tmp = tmp_path_factory.mktemp(f"reqlog_{request.param}")
    scfg = dict(max_batch=2, max_len=MAX_LEN, **LAYOUTS[request.param])
    jeng = JServingEngine(jc, jp, JServeConfig(**scfg),
                          policy="paper_edge_p8")
    teng = ServingEngine(tc, tp, ServeConfig(**scfg),
                         policy="paper_edge_p8", device="cpu")
    j = _orchestrate(JOrchestrator, JOrchestratorConfig, JStreamingRequest,
                     jeng, prompts, str(tmp / "j.jsonl"))
    t = _orchestrate(Orchestrator, OrchestratorConfig, StreamingRequest,
                     teng, prompts, str(tmp / "t.jsonl"))
    return j, t, teng


def test_orchestrator_streams_equal_reference(both):
    (jsr, _, jh), (tsr, _, th), eng = both
    assert [s.out_tokens for s in tsr] == [s.out_tokens for s in jsr]
    assert [s.out_text for s in tsr] == [s.out_text for s in jsr]
    assert all(s.error is None for s in tsr)
    assert th["counters"] == {k: v for k, v in jh["counters"].items()}
    assert th["engine"] == jh["engine"]
    if eng.paged:
        assert eng.allocator.live_pages == 0
        eng.allocator.assert_consistent()


def test_request_log_keys_equal_reference(both):
    (_, jl, _), (_, tl, _), _ = both
    assert len(tl) == len(jl) == 4
    for t, j in zip(tl, jl):
        assert list(t) == list(j)
        assert list(t["lifecycle"]) == list(j["lifecycle"])
        assert list(t["deltas"]) == list(j["deltas"])
        assert (t["uid"], t["error"], t["n_prompt"], t["n_tokens"]) \
            == (j["uid"], j["error"], j["n_prompt"], j["n_tokens"])
