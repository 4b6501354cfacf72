"""``SpeculativeEngine`` of the PyTorch port vs its own baseline greedy and
the JAX package's ``SpeculativeEngine``, on paper-edge smoke (the
reference's params through the weight bridge), CPU.

* At ``benchmarks/bench_speculative.py``'s shape (max_batch 2, max_len 64,
  page 8, 4 requests of 4-12 prompt tokens, max_new 10, posit8 KV, BF16
  target, gamma 2 and 4), float32: streams token-identical to the port's
  baseline and to the reference's speculative engine, and every count
  (decode steps, draft steps, drafts proposed and accepted) equal to the
  reference's, in both layouts (the paged ones in
  ``test_torch_speculative_paged.py``, on this file's helpers).
* The same at the bench's bf16 (``test_torch_speculative_bf16.py``, on
  this file's helpers): streams identical and target steps equal; the
  draft counts may part where the two frameworks round a bf16 draft
  logit differently at a near tie, and the test finds that step and
  holds it to be one.
* Across KV formats and layouts (port only): streams equal to baseline,
  fewer target steps than decode tokens, no page leak.
* EOS truncation, rejection of a non-greedy request, of gamma 0 and of an
  unsupported config; paged rollback keeps exactly the committed pages
  and scrubs the rest; ``kv_cache_bytes`` include the draft ring, equal to
  the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.speculative import SpeculativeEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

COUNTS = ("decode_steps", "spec_rounds", "draft_steps", "drafts_proposed",
          "drafts_accepted", "tokens", "prefills")
# bench_speculative.py's shape
BENCH = dict(max_batch=2, max_len=64, kv_format="posit8", page_size=8)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(dtype_name):
        if dtype_name not in cache:
            cache[dtype_name] = smoke_pair(dtype_name)
        return cache[dtype_name]
    return get


def _bench_requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 13))),
                max_new=10) for i in range(4)]


def _draft_log(eng, to_numpy):
    """Record every draft step's input tokens, positions, output tokens and
    top-two logits (over the vocab) of ``eng``."""
    log, gen = [], eng.draft_engine.generate

    def logged(params, state):
        tok_in, pos = to_numpy(state["tok"]).ravel(), to_numpy(state["pos"])
        state, logits = gen(params, state)
        top2 = np.sort(to_numpy(logits)[:, : eng.cfg.vocab], -1)[:, -2:]
        log.append((tok_in.tolist(), pos.tolist(),
                    to_numpy(state["tok"]).ravel().tolist(), top2))
        return state, logits
    eng.draft_engine.generate = logged
    return log


def _serve_three(pairs, dtype_name, layout, gamma):
    """(port spec, port baseline, reference spec): (streams, stats, engine,
    draft log) each, at the bench's shape."""
    jc, tc, jp, tp = pairs(dtype_name)
    kw = dict(BENCH, kv_layout=layout)
    base = ServingEngine(tc, tp, ServeConfig(**kw), device="cpu")
    spec = SpeculativeEngine(tc, tp, ServeConfig(**kw), gamma=gamma,
                             device="cpu")
    ref = JSpeculative(jc, jp, JServeConfig(**kw), gamma=gamma)
    out = []
    for eng, req_cls, to_numpy in (
            (spec, Request, lambda t: t.float().numpy()),
            (base, Request, None),
            (ref, JRequest, lambda a: np.asarray(a).astype(np.float32))):
        log = _draft_log(eng, to_numpy) if to_numpy else None
        reqs = _bench_requests(req_cls, tc.vocab)
        stats = eng.serve(reqs)
        assert all(r.done and len(r.out_tokens) == 10 for r in reqs)
        out.append(([r.out_tokens for r in reqs], stats, eng, log))
    if layout == "paged":
        assert spec.allocator.live_pages == 0
        spec.allocator.assert_consistent()
    return out


def check_bench_f32(pairs, layout, gamma):
    """Streams and every count of the port's speculative engine equal the
    reference's and the baseline's streams at the bench's shape."""
    (s_out, s, _, _), (b_out, _, _, _), (r_out, r, _, _) = _serve_three(
        pairs, "float32", layout, gamma)
    assert s_out == b_out == r_out
    for key in COUNTS:
        assert s[key] == r[key], key
    decode_tokens = s["tokens"] - s["prefills"]
    assert s["decode_steps"] < decode_tokens
    assert 0 < s["drafts_accepted"] <= s["drafts_proposed"]


# the paged layout: test_torch_speculative_paged.py
@pytest.mark.parametrize("layout", ["ring"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_bench_shape_f32_matches_reference(pairs, layout, gamma):
    check_bench_f32(pairs, layout, gamma)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("kv_format", ["f32", "posit16", "posit4"])
def test_streams_identical_to_baseline(pairs, layout, kv_format):
    """Continuous batching with slot reuse over 3 prompts, float32."""
    _, tc, _, tp = pairs("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (4, 11, 7)]
    scfg = ServeConfig(max_batch=2, max_len=48, kv_format=kv_format,
                       kv_layout=layout, page_size=4)
    base = ServingEngine(tc, tp, scfg, device="cpu")
    reqs_b = [Request(uid=i, prompt=p, max_new=5)
              for i, p in enumerate(prompts)]
    base.serve(reqs_b)
    spec = SpeculativeEngine(tc, tp, scfg, gamma=3, device="cpu")
    reqs_s = [Request(uid=i, prompt=p, max_new=5)
              for i, p in enumerate(prompts)]
    stats = spec.serve(reqs_s)
    assert [r.out_tokens for r in reqs_s] == [r.out_tokens for r in reqs_b]
    assert stats["decode_steps"] < stats["tokens"] - stats["prefills"]
    assert spec.metrics.counter("stage.verify.calls").value == \
        stats["decode_steps"]
    assert spec.metrics.counter("stage.draft.generate.calls").value == \
        stats["draft_steps"]
    if layout == "paged":
        assert spec.allocator.live_pages == 0
        spec.allocator.assert_consistent()


def test_eos_truncation_and_cap(pairs):
    """EOS inside an accepted draft run (the EOS id is a token that the
    EOS-free baseline emits mid-stream), and streams that run into the
    cache cap (the chunk shrinks), stop exactly where baseline stops."""
    _, tc, _, tp = pairs("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (4, 11, 7)]

    def serve(eng, max_new):
        reqs = [Request(uid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        return [r.out_tokens for r in reqs]

    free = serve(ServingEngine(tc, tp, ServeConfig(
        max_batch=2, max_len=48, kv_format="f32"), device="cpu"), 8)
    eos = free[1][4]
    for scfg, max_new in ((ServeConfig(max_batch=2, max_len=48,
                                       kv_format="f32", eos_id=eos), 8),
                          (ServeConfig(max_batch=2, max_len=18,
                                       kv_format="posit8"), 12)):
        base = serve(ServingEngine(tc, tp, scfg, device="cpu"), max_new)
        spec = serve(SpeculativeEngine(tc, tp, scfg, gamma=3, device="cpu"),
                     max_new)
        assert spec == base
        assert any(len(o) < max_new for o in base)
        if scfg.eos_id is not None:
            assert base[1][-1] == eos


def test_rejections(pairs):
    _, tc, _, tp = pairs("float32")
    prompt = np.arange(5)
    eng = SpeculativeEngine(tc, tp, ServeConfig(max_batch=1, max_len=32),
                            gamma=2, device="cpu")
    hot = Request(uid=0, prompt=prompt, max_new=4, temperature=0.7)
    with pytest.raises(ValueError, match="greedy-only"):
        eng.add_request(hot)
    stats = eng.serve([hot])                 # queue path: rejected cleanly
    assert hot.done and hot.error is not None and stats["rejected"] == 1
    long = Request(uid=1, prompt=np.arange(31), max_new=2)
    with pytest.raises(ValueError, match="max_len - 2"):
        eng.add_request(long)
    # an explicit temperature=0 opts back in under a hot engine default
    eng2 = SpeculativeEngine(tc, tp, ServeConfig(max_batch=1, max_len=32,
                                                 temperature=0.9),
                             gamma=2, device="cpu")
    cold = Request(uid=2, prompt=prompt, max_new=3, temperature=0.0)
    eng2.serve([cold])
    assert cold.done and len(cold.out_tokens) == 3 and cold.error is None
    scfg = ServeConfig(max_batch=1, max_len=32)
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeEngine(tc, tp, scfg, gamma=0, device="cpu")
    with pytest.raises(ValueError, match="numeric guard"):
        SpeculativeEngine(tc, tp, scfg, guard=True, device="cpu")
    windowed = dataclasses.replace(tc)
    object.__setattr__(windowed, "window", 8)
    with pytest.raises(ValueError, match="sliding-window"):
        SpeculativeEngine(windowed, tp, scfg, device="cpu")


def test_paged_rollback_frees_orphans_and_scrubs(pairs):
    """After rounds with rejections the slot holds exactly the committed
    length's pages (orphans back in the pool), its committed rows equal a
    never-drafted cache's bit for bit, and rolled-back rows in its last
    page hold init values."""
    _, tc, _, tp = pairs("float32")
    ps = 4
    prompt = np.random.default_rng(0).integers(0, tc.vocab, 4)
    scfg = ServeConfig(max_batch=1, max_len=32, kv_format="posit8",
                       kv_layout="paged", page_size=ps)
    eng = SpeculativeEngine(tc, tp, scfg, gamma=3, device="cpu")
    req = Request(uid=0, prompt=prompt, max_new=12)
    eng.add_request(req)
    while not req.done and len(req.out_tokens) < 8:
        eng.step()
    assert eng.stats["drafts_accepted"] < eng.stats["drafts_proposed"]
    n = int(eng.slot_pos[0])
    pages = eng.slot_pages[0].pages
    assert len(pages) == -(-n // ps)
    assert eng.allocator.live_pages == len(pages)
    eng.allocator.assert_consistent()
    # the never-drafted cache: prefill the prompt, decode the committed
    # tokens one at a time
    _, ref = tsm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]}, tc,
                         32, eng.engine.policy)
    for t in req.out_tokens[:-1]:
        _, ref = tsm.decode_step(tp, ref, torch.tensor([[t]]), tc,
                                 eng.engine.policy)
    for name, leaf in eng.cache["blocks"][0].items():
        for layer in range(leaf.shape[0]):
            got = tpkv.gather_pages(leaf[layer], eng.cache["page_table"],
                                    ps)[0]
            want = tpkv.gather_pages(ref["blocks"][0][name][layer],
                                     ref["page_table"], ps)[0]
            assert torch.equal(got[:n], want[:n]), (name, layer)
            init = 1.0 if name.endswith("_scale") else 0
            assert bool((got[n: len(pages) * ps] == init).all()), name
    eng.serve([])
    assert eng.allocator.live_pages == 0


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_kv_bytes_include_draft_ring(pairs, layout):
    jc, tc, jp, tp = pairs("float32")
    kw = dict(max_batch=2, max_len=32, kv_format="posit8", kv_layout=layout,
              page_size=4)
    base = ServingEngine(tc, tp, ServeConfig(**kw), device="cpu")
    spec = SpeculativeEngine(tc, tp, ServeConfig(**kw), gamma=2,
                             device="cpu")
    ref = JSpeculative(jc, jp, JServeConfig(**kw), gamma=2)
    draft = spec._draft_kv_bytes()
    assert draft == ref._draft_kv_bytes() > 0
    assert spec.kv_cache_bytes() == base.kv_cache_bytes() + draft
    assert spec.kv_cache_bytes() == ref.kv_cache_bytes()
    assert spec.kv_cache_live_bytes() == ref.kv_cache_live_bytes() >= draft
    assert spec.kv_cache_peak_live_bytes() == ref.kv_cache_peak_live_bytes()
    assert spec.stats["kv_cache_bytes"] == spec.kv_cache_bytes()
    # the draft serves its own copy of the weights, quantized under the
    # draft policy; the target's stay as they were
    assert not torch.equal(spec.draft_params["blocks"][0]["wq"],
                           spec.params["blocks"][0]["wq"])
    assert torch.equal(spec.params["blocks"][0]["wq"],
                       base.params["blocks"][0]["wq"])
