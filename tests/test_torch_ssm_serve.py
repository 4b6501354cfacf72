"""Serving the SSM family (mamba2 smoke) through the port's engine against
the reference's, from the same seeded weights.

* Greedy streams token-identical to the reference's at float32 (ring,
  posit8 KV format, ``paper_edge_p8``), one prompt exactly 2 x
  ``ssm_chunk`` long (the inter-chunk scan); at bf16 the prefill's and
  two decode steps' logits within 1/32 of their largest magnitude.
* What the reference cannot do is refused: a prompt that breaks the
  chunked scan's ``s % chunk`` rule (``AssertionError``, as the
  reference's), the paged layout at construction (the reference's own
  failure at its first admission is pinned beside it), and the
  speculative engine.
* The numeric guard re-decodes a poisoned row from the pre-round state:
  under the full-precision policy its one rung is the base precision, so
  the replaced row equals the unpoisoned step's logits exactly, and every
  stream equals a fault-free run's.
* A one-slot orchestrator streams what ``serve()`` does; hoisted weights
  serve the per-call hook's tokens; the bf16 bridge keeps the SSM's f32
  leaves bit-equal; the KV kernels' contracts pass a stack with no
  attention block.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.kernels.kv_cache import append_geometry  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve import (Fault, FaultPlan, Orchestrator,  # noqa: E402
                               Request, ServeConfig, ServingEngine,
                               SpeculativeEngine, StreamingRequest)
from repro_torch.serve.engine import check_kv_kernels  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "mamba2-2.7b"
POLICY = "paper_edge_p8"
MAX_LEN = 128
LENS = (5, 12, 64, 20)        # 64 = 2 x ssm_chunk: two chunks


def ssm_pair(dtype_name):
    """(jax cfg, torch cfg, jax params, torch params) of mamba2 smoke at
    ``dtype_name``, with seeded random A_log, D and dt_bias (the init's
    zeros and ones would leave those terms untested)."""
    jc = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                             dtype_name=dtype_name)
    tc = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                             dtype_name=dtype_name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    rng = np.random.default_rng(7)
    blk = dict(jp["blocks"][0])
    for k, lo, hi in (("A_log", -1.0, 1.0), ("D", 0.5, 1.5),
                      ("dt_bias", -1.0, 0.5)):
        blk[k] = jnp.asarray(rng.uniform(lo, hi, blk[k].shape), jnp.float32)
    jp = dict(jp, blocks=(blk,))
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    return jc, tc, jp, tp


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


@pytest.fixture(scope="module")
def f32():
    return ssm_pair("float32")


@pytest.fixture(scope="module")
def ref_streams(f32):
    """The reference's greedy streams (one jitted engine per module)."""
    jc, tc, jp, _ = f32
    je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                             kv_format="posit8"),
                        policy=POLICY)
    reqs = [JRequest(uid=i, prompt=p, max_new=6)
            for i, p in enumerate(_prompts(tc.vocab))]
    je.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs], je


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


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


def test_greedy_streams_equal_reference(f32, ref_streams):
    eng = _engine(f32)
    assert not eng.engine.bucketed
    streams, stats = _serve(eng, f32[1].vocab)
    assert streams == ref_streams[0]
    assert stats["kv_cache_bytes"] == 0 == eng.kv_cache_bytes()
    assert stats["prefills"] == len(LENS)       # one exact-length each
    blk = eng.cache["blocks"][0]
    assert set(blk) == {"state", "conv"}
    assert blk["state"].dtype == torch.float32


def test_bf16_logits_within_tolerance():
    """bf16: the prefill's logits and two decode steps' (each engine from
    its own state) within 1/32 of the reference's largest magnitude."""
    jc, tc, jp, tp = ssm_pair("bfloat16")
    je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                             kv_format="posit8"),
                        policy=POLICY)
    te = _engine((jc, tc, jp, tp))
    prompt = _prompts(tc.vocab, (64,))[0][None]
    logits = []
    for eng, tokens in ((je, jnp.asarray(prompt, jnp.int32)),
                        (te, torch.from_numpy(prompt))):
        api = eng.engine
        prefix = api.prefill(eng.params, tokens)
        state = api.insert(prefix, api.init_decode_state(), 1)
        got = [_f32(prefix["logits"][0])]
        for _ in range(2):
            state, lg = api.generate(eng.params, state)
            got.append(_f32(lg[1]))
        logits.append(got)
    for j, t in zip(*logits):
        np.testing.assert_allclose(t, j, rtol=0, atol=np.abs(j).max() / 32)


def test_ragged_prompt_refused_as_reference(f32, ref_streams):
    """40 tokens: neither at most the 32-token chunk nor a multiple of it."""
    _, tc, _, _ = f32
    prompt = _prompts(tc.vocab, (40,))[0]
    with pytest.raises(AssertionError, match="40, 32"):
        _engine(f32).serve([Request(uid=0, prompt=prompt, max_new=2)])
    je = ref_streams[1]
    with pytest.raises(AssertionError, match="40, 32"):
        je.serve([JRequest(uid=9, prompt=prompt, max_new=2)])


def test_paged_refused_at_construction(f32):
    jc, tc, jp, tp = f32
    with pytest.raises(ValueError, match="no attention block"):
        _engine(f32, scfg=dict(kv_layout="paged", page_size=8))
    # the reference builds the engine and fails at its first admission:
    # it reads the conv state's K-1 rows as the prefix's bucket width
    je = JServingEngine(jc, jp, JServeConfig(
        max_batch=2, max_len=MAX_LEN, kv_format="posit8",
        kv_layout="paged", page_size=8), policy=POLICY)
    with pytest.raises(ValueError, match="could not broadcast"):
        je.serve([JRequest(uid=0, prompt=_prompts(tc.vocab, (5,))[0],
                           max_new=2)])


def test_speculative_refused(f32):
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


def test_guard_redecodes_from_the_pre_round_state(f32):
    """Full-precision policy ("bf16": no weight format), so the ladder's
    one rung serves the base precision: a poisoned row's re-decode equals
    the unpoisoned step's logits bit for bit; a decode from the
    post-round state would not."""
    _, tc, _, _ = f32
    eng = _engine(f32, policy="bf16", guard=True)
    assert len(eng.guard.ladder) == 1
    for i, p in enumerate(_prompts(tc.vocab)[:2]):   # exact-length
        assert eng.add_request(Request(uid=i, prompt=p, max_new=20))
    for _ in range(3):
        eng.step()
    active = [i for i, r in enumerate(eng.slot_req) if r is not None]
    assert active == [0, 1]
    eng.cache["tok"] = torch.from_numpy(eng.last_tok)
    prev = dict(eng.cache)
    eng.cache, logits = eng.engine.generate(eng.params, eng.cache)
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
    """``hoist_weight_quant`` quantizes every layer's in_proj and out_proj
    under the mlp_weights role and leaves the rest raw; the hoisted
    weights served hook-free give the per-call hook's logits."""
    _, tc, _, tp = f32
    policy = get_policy(POLICY)
    hoisted = lm.hoist_weight_quant(tp, policy)
    q = lambda w: policy.quantize_weight(w, "mlp_weights")  # noqa: E731
    for name, leaf in hoisted["blocks"][0].items():
        raw = tp["blocks"][0][name]
        if name in ("in_proj", "out_proj"):
            for i in range(tc.n_layers):
                assert torch.equal(leaf[i], q(raw[i])), name
            assert not torch.equal(leaf, raw), name
        else:
            assert leaf is raw, name
    tokens = torch.from_numpy(_prompts(tc.vocab, (16,))[0][None])
    free = lm.weights_free(policy, tc.tie_embed)
    a, ca = serve_model.prefill(tp, {"tokens": tokens}, tc, 32, policy)
    b, cb = serve_model.prefill(hoisted, {"tokens": tokens}, tc, 32, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    tok = a[:, :tc.vocab].argmax(-1)[:, None]
    a, _ = serve_model.decode_step(tp, ca, tok, tc, policy)
    b, _ = serve_model.decode_step(hoisted, cb, tok, tc, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_bf16_bridge_keeps_the_f32_leaves():
    """A bf16 conversion rounds the weights and keeps A_log, D, dt_bias,
    norm_scale and ln bit-equal to the reference's float32."""
    jc, tc, jp, _ = ssm_pair("bfloat16")
    rng = np.random.default_rng(3)
    blk = dict(jp["blocks"][0])
    for k in ("A_log", "D", "dt_bias", "norm_scale", "ln"):
        blk[k] = jnp.asarray(rng.standard_normal(blk[k].shape), jnp.float32)
    tp = params_from_numpy(jax_params_to_numpy(dict(jp, blocks=(blk,))),
                           "cpu", torch.bfloat16)
    for k in ("A_log", "D", "dt_bias", "norm_scale", "ln"):
        t = tp["blocks"][0][k]
        assert t.dtype == torch.float32, k
        np.testing.assert_array_equal(t.numpy(), np.asarray(blk[k]))
    for k in ("in_proj", "conv_w", "out_proj"):
        assert tp["blocks"][0][k].dtype == torch.bfloat16, k


@pytest.mark.parametrize("kv_format", ["posit16", "posit8", "posit4"])
def test_kv_kernel_check_passes_an_attention_free_stack(kv_format):
    """mamba2's unused head dim (2560) would break K3's lane groups, but
    an attention-free stack runs no KV kernel; paper-edge's contracts are
    checked as before."""
    pol = dataclasses.replace(get_policy(POLICY), kv_format=kv_format)
    cfg = tconfigs.get_config(ARCH)
    with pytest.raises(ValueError):
        append_geometry("ServingEngine", cfg.head_dim, cfg.dtype)
    check_kv_kernels(cfg, pol, 1024)
    edge = dataclasses.replace(tconfigs.get_config("paper-edge", smoke=True),
                               d_head=48)
    with pytest.raises(ValueError, match="head dim"):
        check_kv_kernels(edge, pol, 64)


def test_serve_launcher_serves_mamba2():
    """``python -m repro_torch.launch.serve --arch mamba2-2.7b`` (smoke,
    the CPU) serves the ring layout with the energy table; the paged
    layout is refused."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
            "--max-new", "3", "--batch", "2", "--max-len", "64"]
    out = launch_serve.main(argv + ["--energy"])
    assert all(r.done and r.error is None and len(r.out_tokens) == 3
               for r in out["requests"])
    assert out["stats"]["kv_cache_bytes"] == 0
    assert set(out["energy"]["stages"]) == {"prefill", "insert", "generate"}
    with pytest.raises(ValueError, match="no attention block"):
        launch_serve.main(argv + ["--kv-layout", "paged"])
