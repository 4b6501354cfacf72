"""Serving the hybrid family (recurrentgemma smoke: rec, rec, local attn
and a recurrent tail block; a 16-token window) through the port against
the reference, from the same seeded weights.

* At float32, ring, ``paper_edge_p8`` with its posit8 KV format, prompts
  of 5, 12, 30 and 40 tokens (the last two wrap the 16-row ring): the
  prefill's logits (atol 1e-5), ring codes and scales (bit-exact), ``h``
  and ``conv`` equal the reference's, and so does a decode that wraps the
  ring; greedy streams from ``ServingEngine.serve`` are token-identical
  to the reference's engine.  At bf16 the prefill's and two decode steps'
  logits are within 1/32 of their largest magnitude.
* What the reference refuses is refused, with its own failure pinned
  beside each: the paged layout, the speculative engine, bucketed
  (``true_len``) prefill and a prefill over packed recurrent weights.
* The numeric guard re-decodes a poisoned row from the pre-round state
  (the recurrent states of ``blocks`` and ``tail`` included) to the
  unpoisoned step's logits exactly; a one-slot orchestrator streams what
  ``serve()`` does; hoisted weights serve the per-call hook's tokens; the
  launcher serves the arch; the KV kernels' contracts pass recurrentgemma
  at full width (hd 256, 16 query heads per KV head).

The reference's engine is built once per module (it compiles each
prompt length).  The bf16 case and the packed-weights refusal are in
``test_torch_hybrid_serve_bf16.py``, on this file's helpers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve import (Fault, FaultPlan, Orchestrator,  # noqa: E402
                               Request, ServeConfig, ServingEngine,
                               SpeculativeEngine, StreamingRequest)
from repro_torch.serve.engine import check_kv_kernels  # noqa: E402
from test_torch_rglru import hybrid_pair  # noqa: E402
from test_torch_serve import _codes, jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "recurrentgemma-9b"
POLICY = "paper_edge_p8"
MAX_LEN = 64
LENS = (5, 12, 30, 40)          # 30 and 40 wrap the 16-row window
# the reference's prefill, traced (its refusals raise while tracing)
_J_PREFILL = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.fixture(scope="module")
def f32():
    return hybrid_pair("float32")


@pytest.fixture(scope="module")
def ref_streams(f32):
    """The reference's greedy streams (one engine per module)."""
    jc, tc, jp, _ = f32
    je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                             kv_format="posit8"),
                        policy=POLICY)
    reqs = [JRequest(uid=i, prompt=p, max_new=6)
            for i, p in enumerate(_prompts(tc.vocab))]
    je.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs], je


def _engine(model, policy=POLICY, **kw):
    _, tc, _, tp = model
    scfg = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    scfg.update(kw.pop("scfg", {}))
    return ServingEngine(tc, tp, ServeConfig(**scfg), policy=policy,
                         device="cpu", **kw)


def _serve(eng, vocab, max_new=6, lens=LENS):
    reqs = [Request(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(vocab, lens))]
    stats = eng.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs], stats


def _cache_parts(cache):
    """{path: leaf} of a cache's blocks and tail (port or reference)."""
    out = {}
    for part in ("blocks", "tail"):
        for i, blk in enumerate(cache.get(part, ())):
            for k, v in blk.items():
                out[f"{part}/{i}/{k}"] = v
    return out


def _same_cache(tc_, jc_, atol=1e-5):
    """Codes and scales bit-exact, ``h`` and ``conv`` within atol."""
    t, j = _cache_parts(tc_), _cache_parts(jc_)
    assert set(t) == set(j)
    for name, leaf in t.items():
        ref = j[name]
        assert tuple(leaf.shape) == tuple(ref.shape), name
        if name.endswith(("/k", "/v")):
            np.testing.assert_array_equal(_codes(leaf), _codes(ref),
                                          err_msg=name)
        elif name.endswith("_scale"):
            np.testing.assert_array_equal(_f32(leaf), _f32(ref),
                                          err_msg=name)
        else:
            np.testing.assert_allclose(_f32(leaf), _f32(ref), rtol=0,
                                       atol=atol, err_msg=name)


@pytest.mark.parametrize("s", [12, 40])
def test_prefill_and_wrapping_decode_equal_reference(f32, ref_streams, s):
    """The engines' stages on one served prompt: the prefill's logits,
    its W-wide posit8 ring (codes and scales), ``h`` and ``conv``, then
    decode steps that carry the ring past its end (a 12-token prompt's
    ring wraps in decode, a 40-token one's in the prefill), each step's
    logits and the caches after them.  The reference's stages are the
    fixture engine's, compiled for these shapes when it served."""
    jc, tc, jp, tp = f32
    je, te = ref_streams[1].engine, _engine(f32)
    prompt = _prompts(tc.vocab)[LENS.index(s)][None]
    jpre = je.prefill(ref_streams[1].params, jnp.asarray(prompt, jnp.int32))
    tpre = te.engine.prefill(te.params, torch.from_numpy(prompt))
    np.testing.assert_allclose(_f32(tpre["logits"]), _f32(jpre["logits"]),
                               rtol=0, atol=1e-5)
    assert tpre["cache"]["blocks"][2]["k"].shape[2] == tc.window  # W = 16
    _same_cache(tpre["cache"], jpre["cache"])
    jstate = je.insert(jpre, je.init_decode_state(), 0)
    tstate = te.engine.insert(tpre, te.engine.init_decode_state(), 0)
    for _ in range(22 - s % 16):        # past the ring's end
        before = tstate["blocks"]
        tstate, tl = te.engine.generate(te.params, tstate)
        assert tstate["blocks"] is not before       # rec state rebound
        jstate, jl = je.generate(ref_streams[1].params, jstate)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=1e-5)
    _same_cache(tstate, jstate)
    assert int(tstate["pos"][0]) == int(jstate["pos"][0]) > tc.window


def test_greedy_streams_equal_reference(f32, ref_streams):
    eng = _engine(f32)
    assert not eng.engine.bucketed
    streams, stats = _serve(eng, f32[1].vocab)
    assert streams == ref_streams[0]
    je = ref_streams[1]
    assert stats["kv_cache_bytes"] == eng.kv_cache_bytes() \
        == je.kv_cache_bytes()
    # one attention layer: 2 slots x 16 rows x (16 codes + 4 scale bytes),
    # K and V
    assert eng.kv_cache_bytes() == 2 * 2 * 16 * (16 + 4)
    assert stats["prefills"] == len(LENS)       # one exact-length each
    assert set(eng.cache["tail"][0]) == {"h", "conv"}
    assert eng.cache["tail"][0]["h"].dtype == torch.float32


def test_insert_copies_the_tail(f32):
    _, tc, _, tp = f32
    api = _engine(f32).engine
    prefix = api.prefill(lm.hoist_weight_quant(tp, get_policy(POLICY)),
                         torch.from_numpy(_prompts(tc.vocab, (30,))[0][None]))
    state = api.insert(prefix, api.init_decode_state(), 1)
    for dst, src in zip(state["tail"], prefix["cache"]["tail"]):
        for k in dst:
            assert torch.equal(dst[k][1], src[k][0]), k
            assert not dst[k][0].any(), k
    for dst, src in zip(state["blocks"], prefix["cache"]["blocks"]):
        for k in dst:
            assert torch.equal(dst[k][:, 1], src[k][:, 0]), k
    assert int(state["pos"][1]) == 30


def test_paged_refused_as_reference(f32):
    jc, tc, jp, tp = f32
    with pytest.raises(ValueError, match="sliding-window"):
        _engine(f32, scfg=dict(kv_layout="paged", page_size=8))
    with pytest.raises(ValueError, match="sliding-window"):
        JServingEngine(jc, jp, JServeConfig(
            max_batch=2, max_len=MAX_LEN, kv_format="posit8",
            kv_layout="paged", page_size=8), policy=POLICY)
    pol = dataclasses.replace(get_policy(POLICY), kv_layout="paged")
    with pytest.raises(ValueError, match="sliding-window"):
        serve_model.init_cache(tc, 1, MAX_LEN, policy=pol, device="cpu")


def test_speculative_refused_as_reference(f32):
    jc, tc, jp, tp = f32
    scfg = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    with pytest.raises(ValueError, match="attention-only"):
        SpeculativeEngine(tc, tp, ServeConfig(**scfg), policy=POLICY,
                          device="cpu")
    with pytest.raises(ValueError, match="decoder-only attention stack"):
        JSpeculative(jc, jp, JServeConfig(**scfg), policy=POLICY)
    with pytest.raises(ValueError, match="attention-only"):
        serve_model.verify_step(tp, serve_model.init_cache(
            tc, 1, 16, device="cpu"), torch.zeros((1, 2), dtype=torch.long),
            tc)


def test_bucketed_prefill_refused_as_reference(f32):
    jc, tc, jp, tp = f32
    tokens = _prompts(tc.vocab, (16, 16))
    with pytest.raises(ValueError, match="bucketed prefill"):
        serve_model.prefill(tp, {"tokens": torch.from_numpy(
            np.stack(tokens))}, tc, MAX_LEN, true_len=[9, 16])
    with pytest.raises(ValueError, match="bucketed prefill"):
        _J_PREFILL(jp, {"tokens": jnp.asarray(np.stack(tokens))}, jc,
                   MAX_LEN, j_get_policy("bf16"),
                   true_len=jnp.asarray([9, 16]))
    with pytest.raises(ValueError, match="exact length"):
        _engine(f32).engine.prefill(tp, np.stack(tokens), [9, 16])


def test_guard_redecodes_from_the_pre_round_state(f32):
    """Full-precision policy ("bf16": no weight format), so the ladder's
    one rung serves the base precision: a poisoned row's re-decode equals
    the unpoisoned step's logits bit for bit; a decode from the
    post-round recurrent state would not."""
    _, tc, _, _ = f32
    eng = _engine(f32, policy="bf16", guard=True)
    assert len(eng.guard.ladder) == 1
    for i, p in enumerate(_prompts(tc.vocab)[2:]):   # both wrap the ring
        assert eng.add_request(Request(uid=i, prompt=p, max_new=20))
    for _ in range(3):
        eng.step()
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    assert active == [0, 1]
    eng.cache["tok"] = torch.from_numpy(eng.last_tok)
    prev = dict(eng.cache)
    eng.cache, logits = eng.engine.generate(eng.params, eng.cache)
    assert eng.cache["tail"] is not prev["tail"]
    clean = logits.numpy().copy()
    host = clean.copy()
    host[0] = np.nan
    eng.guard.check_round(prev, host, active, {0: Fault(
        "poison_logits", fixed_by_level=1)})
    assert eng.guard.level(eng.slot_req[0].uid) == 1
    np.testing.assert_array_equal(host, clean)
    post = serve_model.decode_step(eng.params, dict(eng.cache),
                                   prev["tok"], tc)[0].numpy()
    assert np.abs(post[0] - clean[0]).max() > 1e-3


def test_poisoned_serve_streams_equal_fault_free(f32):
    _, tc, _, _ = f32
    clean, _ = _serve(_engine(f32, policy="bf16"), tc.vocab)
    plan = FaultPlan((Fault("poison_logits", at=3, slot=0,
                            fixed_by_level=1),))
    eng = _engine(f32, policy="bf16", guard=True, faults=plan)
    streams, _ = _serve(eng, tc.vocab)
    assert streams == clean
    c = eng.metrics.snapshot()["counters"]
    assert c["guard.quarantined"] == 1 and c["guard.fallbacks"] == 1


def test_one_slot_orchestrator_streams_equal_serve(f32):
    _, tc, _, _ = f32
    ref, _ = _serve(_engine(f32, scfg=dict(max_batch=1)), tc.vocab,
                    max_new=5)
    with Orchestrator(_engine(f32, scfg=dict(max_batch=1))) as orch:
        sreqs = [StreamingRequest(p.tolist(), max_new=5)
                 for p in _prompts(tc.vocab)]
        for s in sreqs:
            assert orch.submit(s, timeout=60.0)
        for s in sreqs:
            assert s.wait(120.0)
    assert [s.out_tokens for s in sreqs] == ref
    assert all(s.error is None for s in sreqs)


def test_hoisted_serving_equals_the_per_call_hook(f32):
    """``hoist_weight_quant`` quantizes the attention weights and every
    block's MLP (the tail's whole), and leaves wx, wy, w_out, the conv
    taps and the RG-LRU raw (the reference's serving path hooks none of
    them); the hoisted weights served hook-free give the per-call hook's
    logits."""
    _, tc, _, tp = f32
    policy = get_policy(POLICY)
    hoisted = lm.hoist_weight_quant(tp, policy)
    q = lambda w: policy.quantize_weight(w, "mlp_weights")  # noqa: E731
    for part in ("blocks", "tail"):
        for blk, raw in zip(hoisted[part], tp[part]):
            if "rglru" not in blk:
                continue
            for name, leaf in blk.items():
                if name in ("wi", "wo_mlp"):
                    want = (q(raw[name]) if part == "tail" else torch.stack(
                        [q(w) for w in raw[name]]))
                    assert torch.equal(leaf, want), name
                    assert not torch.equal(leaf, raw[name]), name
                else:
                    assert leaf is raw[name], name
    tokens = torch.from_numpy(_prompts(tc.vocab, (30,))[0][None])
    free = lm.weights_free(policy, tc.tie_embed)
    a, ca = serve_model.prefill(tp, {"tokens": tokens}, tc, MAX_LEN, policy)
    b, cb = serve_model.prefill(hoisted, {"tokens": tokens}, tc, MAX_LEN,
                                free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    tok = a[:, :tc.vocab].argmax(-1)[:, None]
    a, _ = serve_model.decode_step(tp, ca, tok, tc, policy)
    b, _ = serve_model.decode_step(hoisted, cb, tok, tc, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("kv_format", ["posit16", "posit8", "posit4"])
def test_kv_kernel_check_passes_recurrentgemma(kv_format):
    """Full width: hd 256 (512-B posit16 code rows, K4's limit; 512-B
    bf16 append rows, K3's 32 lanes) and 16 query heads per KV head over
    a 2048-row ring pass both kernels' contracts."""
    pol = dataclasses.replace(get_policy(POLICY), kv_format=kv_format)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (256, 16)
    check_kv_kernels(cfg, pol, 4096)


def test_serve_launcher_serves_recurrentgemma():
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b``
    (smoke, the CPU) serves the ring with the energy table; the paged
    layout and the speculative engine are refused."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
            "--max-new", "3", "--batch", "2", "--max-len", "64"]
    out = launch_serve.main(argv + ["--energy"])
    assert all(r.done and r.error is None and len(r.out_tokens) == 3
               for r in out["requests"])
    assert out["stats"]["kv_cache_bytes"] > 0
    assert set(out["energy"]["stages"]) == {"prefill", "insert", "generate"}
    with pytest.raises(ValueError, match="sliding-window"):
        launch_serve.main(argv + ["--kv-layout", "paged"])
    with pytest.raises(ValueError, match="attention-only"):
        launch_serve.main(argv + ["--speculative"])
