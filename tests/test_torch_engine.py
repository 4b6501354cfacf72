"""ServingEngine of the PyTorch port vs the JAX package's: greedy streams
token-identical at float32 on paper-edge smoke, ring layout, for every KV
format (f32, posit16, posit8, posit4), under the paper_edge_p8 weight
policy (the port hoists weight quantization; the reference re-quantizes
at every call).  The posit8 and posit4 streams are in
``test_torch_engine_posit.py``, on this file's helpers."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.fixture(scope="module")
def model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, int(rng.integers(4, 20)))
               for _ in range(4)]
    return jc, tc, jp, tp, prompts


def check_streams(model, kv_format):
    """Both engines serve ``model``'s prompts (8 new tokens each, 2 slots):
    streams and stats equal."""
    jc, tc, jp, tp, prompts = model
    je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=64,
                                             kv_format=kv_format),
                        policy="paper_edge_p8")
    jr = [JRequest(uid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    js = je.serve(jr)
    te = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=64,
                                           kv_format=kv_format),
                       policy="paper_edge_p8", device="cpu")
    tr = [Request(uid=i, prompt=p, max_new=8) for i, p in enumerate(prompts)]
    ts = te.serve(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(len(r.out_tokens) == 8 and r.done for r in tr)
    for key in ("prefills", "decode_steps", "tokens", "kv_cache_bytes"):
        assert ts[key] == js[key], key


# posit8 and posit4: test_torch_engine_posit.py
@pytest.mark.parametrize("kv_format", ["f32", "posit16"])
def test_greedy_streams_token_identical(model, kv_format):
    check_streams(model, kv_format)


def test_engine_stages_and_tracing(model):
    """Driving the three stages by hand: insert lands the bucket-width
    prefix at ring rows [0, bucket) of its slot and sets pos; generate
    advances pos and tok; an enabled tracer records paired stage spans."""
    _, tc, _, tp, prompts = model
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=64,
                                            kv_format="posit8"),
                        policy="paper_edge_p8", device="cpu")
    eng.tracer.enable()
    api = eng.engine
    assert api.bucket_for(5) == 16 and api.bucket_for(17) == 32
    assert api.bucket_for(1000) == 64
    p = prompts[0]
    w = api.bucket_for(len(p))
    padded = np.zeros((1, w), np.int64)
    padded[0, :len(p)] = p
    prefix = api.prefill(eng.params, torch.from_numpy(padded),
                         torch.tensor([len(p)]))
    state = api.insert(prefix, eng.cache, slot=1)
    blk, pblk = state["blocks"][0], prefix["cache"]["blocks"][0]
    assert pblk["k"].shape[2] == w
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(blk[name][:, 1, :w], pblk[name][:, 0])
    assert int(state["pos"][1]) == len(p) and int(state["pos"][0]) == 0
    state, logits = api.generate(eng.params, state)
    assert tuple(logits.shape) == (2, tc.vocab_pad)
    assert int(state["pos"][1]) == len(p) + 1
    assert int(state["tok"][1, 0]) == int(logits[1, :tc.vocab].argmax())
    names = eng.tracer.self_times()
    for stage in ("prefill", "insert", "generate"):
        assert names[f"{stage}.dispatch"]["count"] == 1
        assert names[f"{stage}.device"]["count"] == 1
        assert eng.metrics.counter(f"stage.{stage}.calls").value == 1


def test_temperature_sampling_uses_engine_rng(model):
    _, tc, _, tp, prompts = model
    outs = []
    for _ in range(2):
        eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=64,
                                                temperature=1.0, seed=3),
                            device="cpu")
        reqs = [Request(uid=i, prompt=p, max_new=4)
                for i, p in enumerate(prompts[:2])]
        eng.serve(reqs)
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
    assert all(0 <= t < tc.vocab for r in outs[0] for t in r)


def test_rejects_prompts_at_max_len(model):
    _, tc, _, tp, _ = model
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=32),
                        device="cpu")
    r = Request(uid=0, prompt=np.zeros(32, np.int64), max_new=2)
    stats = eng.serve([r])
    assert r.done and r.error and stats["rejected"] == 1
