"""Serving the vlm family (qwen2-vl smoke: M-RoPE, tied embeddings)
through the port against the reference, from the same seeded weights.

* At float32, ``paper_edge_p8`` with its posit8 KV format, max batch 2:
  greedy streams from ``ServingEngine.serve`` are token-identical to the
  reference's engine in the ring and the paged layout, with equal
  ``kv_cache_bytes``; the engine prefills each prompt at its exact length
  (the reference does not bucket vlm).
* A patch-embedding prompt (``prefill({"embeds": ...})``, ring) and decode
  steps fed by ``embeds`` and then by tokens: logits within atol 1e-5 of
  the reference's, ring codes and scales bit-exact.  A bucketed
  (``true_len``) prefill of ``embeds`` is refused beside the reference's
  refusal; of tokens it is allowed and gives each row's exact-length
  logits.
* The numeric guard re-decodes a poisoned row from the pre-round state to
  the unpoisoned step's logits; hoisted weights serve the per-call hook's
  tokens; the launcher serves the arch with its energy table; the KV
  kernels' contracts pass qwen2-vl at full width (hd 128, 6 query heads
  per KV head).

The reference's engines are built once per module.
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
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve import (Fault, Request, ServeConfig,  # noqa: E402
                               ServingEngine)
from repro_torch.serve.engine import check_kv_kernels  # noqa: E402
from test_torch_serve import _codes  # noqa: E402
from test_torch_vlm import family_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "qwen2-vl-2b"
POLICY = "paper_edge_p8"
MAX_LEN = 64
# one prompt length (the reference compiles a prefill per length); the
# third request joins when a slot frees, at other positions
LENS = (7, 7, 7)
_J_PREFILL = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))
_J_DECODE = jax.jit(jsm.decode_step, static_argnums=(3, 4))


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n) for n in lens]


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _scfg(layout, **kw):
    return dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
                kv_layout=layout, page_size=8, **kw)


@pytest.fixture(scope="module")
def f32():
    return family_pair(ARCH)


@pytest.fixture(scope="module")
def ref_streams(f32):
    """The reference's greedy streams and engines, per layout."""
    jc, tc, jp, _ = f32
    out = {}
    for layout in ("ring", "paged"):
        je = JServingEngine(jc, jp, JServeConfig(**_scfg(layout)),
                            policy=POLICY)
        reqs = [JRequest(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(_prompts(tc.vocab))]
        je.serve(reqs)
        assert all(r.done and r.error is None for r in reqs)
        out[layout] = ([r.out_tokens for r in reqs], je)
    return out


def _engine(model, policy=POLICY, layout="ring", **kw):
    _, tc, _, tp = model
    return ServingEngine(tc, tp, ServeConfig(**_scfg(layout)), policy=policy,
                         device="cpu", **kw)


def _serve(eng, vocab, max_new=6, lens=LENS):
    reqs = [Request(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(_prompts(vocab, lens))]
    stats = eng.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs], stats


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_greedy_streams_equal_reference(f32, ref_streams, layout):
    eng = _engine(f32, layout=layout)
    assert not eng.engine.bucketed
    streams, stats = _serve(eng, f32[1].vocab)
    want, je = ref_streams[layout]
    assert streams == want
    assert stats["kv_cache_bytes"] == eng.kv_cache_bytes() \
        == je.kv_cache_bytes()
    assert stats["prefills"] == len(LENS)       # one exact-length each


def test_embeds_prefill_and_decode_equal_reference(f32):
    """Ring, posit8 KV, the per-call weight hook: an 11-row patch-
    embedding prompt for 2 slots, two decode steps fed by embeds, then two
    by the greedy tokens."""
    jc, tc, jp, tp = f32
    jpol = dataclasses.replace(j_get_policy(POLICY), kv_format="posit8")
    tpol = dataclasses.replace(get_policy(POLICY), kv_format="posit8")
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((2, 11, tc.d_model)).astype(np.float32)
    jl, jcache = _J_PREFILL(jp, {"embeds": jnp.asarray(emb)}, jc, MAX_LEN,
                            jpol)
    tl, tcache = serve_model.prefill(tp, {"embeds": torch.from_numpy(emb)},
                                     tc, MAX_LEN, tpol)
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=1e-5)
    for step in range(4):
        if step < 2:
            e = rng.standard_normal((2, 1, tc.d_model)).astype(np.float32)
            jl, jcache = _J_DECODE(jp, jcache, None, jc, jpol,
                                   embeds=jnp.asarray(e))
            tl, tcache = serve_model.decode_step(
                tp, tcache, None, tc, tpol, embeds=torch.from_numpy(e))
        else:
            tok = np.asarray(jl)[:, :tc.vocab].argmax(-1)[:, None]
            jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(tok, jnp.int32),
                                   jc, jpol)
            tl, tcache = serve_model.decode_step(
                tp, tcache, torch.from_numpy(tok), tc, tpol)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=1e-5)
    assert int(tcache["pos"]) == int(jcache["pos"]) == 15
    for tb, jb in zip(tcache["blocks"], jcache["blocks"]):
        assert set(tb) == set(jb) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            np.testing.assert_array_equal(_codes(tb[name]), _codes(jb[name]))
            np.testing.assert_array_equal(_f32(tb[name + "_scale"]),
                                          _f32(jb[name + "_scale"]))


def test_bucketed_prefill_of_embeds_refused_as_reference(f32):
    """``true_len`` with ``embeds`` raises on both sides; with tokens the
    port's bucketed prefill gives each row its exact-length logits."""
    jc, tc, jp, tp = f32
    emb = np.zeros((2, 8, tc.d_model), np.float32)
    with pytest.raises(ValueError, match="bucketed prefill"):
        serve_model.prefill(tp, {"embeds": torch.from_numpy(emb)}, tc,
                            MAX_LEN, true_len=[5, 8])
    with pytest.raises(ValueError, match="bucketed prefill"):
        _J_PREFILL(jp, {"embeds": jnp.asarray(emb)}, jc, MAX_LEN,
                   j_get_policy("bf16"), true_len=jnp.asarray([5, 8]))
    p5, p8 = _prompts(tc.vocab, (5, 8), seed=2)
    pad = np.zeros((2, 8), np.int64)
    pad[0, :5], pad[1] = p5, p8
    got, _ = serve_model.prefill(tp, {"tokens": torch.from_numpy(pad)}, tc,
                                 MAX_LEN, true_len=[5, 8])
    for row, p in enumerate((p5, p8)):
        want, _ = serve_model.prefill(tp, {"tokens": torch.from_numpy(
            p[None])}, tc, MAX_LEN)
        torch.testing.assert_close(got[row], want[0], rtol=0, atol=1e-6)


def test_guard_redecodes_from_the_pre_round_state(f32):
    """Full-precision policy ("bf16"), so the ladder's one rung serves the
    base precision: a poisoned row's re-decode equals the unpoisoned
    step's logits bit for bit (the guard's clone of the pre-round K/V
    rows)."""
    _, tc, _, _ = f32
    eng = _engine(f32, policy="bf16", guard=True)
    assert len(eng.guard.ladder) == 1
    for i, p in enumerate(_prompts(tc.vocab)[:2]):
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


def test_hoisted_serving_equals_the_per_call_hook(f32):
    """``hoist_weight_quant`` quantizes the attention and MLP weights and
    leaves the tied table raw (its rows are quantized at lookup); served
    hook-free the hoisted weights give the per-call hook's logits, from
    embeds and from tokens."""
    _, tc, _, tp = f32
    policy = get_policy(POLICY)
    hoisted = lm.hoist_weight_quant(tp, policy)
    assert hoisted["embed"] is tp["embed"]
    assert not torch.equal(hoisted["blocks"][0]["wq"], tp["blocks"][0]["wq"])
    free = lm.weights_free(policy, tc.tie_embed)
    emb = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 9, tc.d_model)).astype(np.float32))
    a, ca = serve_model.prefill(tp, {"embeds": emb}, tc, MAX_LEN, policy)
    b, cb = serve_model.prefill(hoisted, {"embeds": emb}, tc, MAX_LEN, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    tok = a[:, :tc.vocab].argmax(-1)[:, None]
    a, _ = serve_model.decode_step(tp, ca, tok, tc, policy)
    b, _ = serve_model.decode_step(hoisted, cb, tok, tc, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("kv_format", ["posit16", "posit8", "posit4"])
def test_kv_kernel_check_passes_qwen2_vl(kv_format):
    """Full width: hd 128 (256-B bf16 append rows, 16 lanes) and 6 query
    heads per KV head over 2 KV heads and a 1024-row ring pass both
    kernels' contracts."""
    pol = dataclasses.replace(get_policy(POLICY), kv_format=kv_format)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.head_dim, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads) \
        == (128, 2, 6)
    check_kv_kernels(cfg, pol, 1024)


def test_serve_launcher_serves_qwen2_vl():
    """``python -m repro_torch.launch.serve --arch qwen2-vl-2b`` (smoke,
    the CPU) serves the ring and the paged layout and the speculative
    engine, with the energy table."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--device", "cpu", "--arch", ARCH, "--requests", "3",
            "--max-new", "3", "--batch", "2", "--max-len", "64"]
    outs = [launch_serve.main(argv + extra) for extra in (
        ["--energy"], ["--kv-layout", "paged"], ["--speculative"])]
    for out in outs:
        assert all(r.done and r.error is None and len(r.out_tokens) == 3
                   for r in out["requests"])
    assert set(outs[0]["energy"]["stages"]) == {"prefill", "insert",
                                                "generate"}
