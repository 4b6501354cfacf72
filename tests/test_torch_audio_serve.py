"""Serving the audio family (whisper smoke) through the port against the
reference, from the same seeded weights and frames.

* At float32, ``paper_edge_p8`` with a posit8 KV format, ring and paged:
  ``prefill({"tokens", "frames"})`` of two clips with 4-token decoder
  prompts, then 8 greedy ``decode_step`` calls.  The prefill's logits and
  every step's within atol 1e-5 of the reference's, the greedy streams
  token-identical, ``memory`` and the cross K/V ``xk``/``xv`` within rtol
  1e-6, atol 1e-6 (two encoder layers of f32 rounding on O(1) values),
  the self K/V codes and scales bit-exact.  An engine's
  ``kv_cache_bytes`` (cross K/V counted, unpaged) equals the reference's.
* What the reference cannot serve, the port refuses with a clear error,
  the reference's own failure pinned beside each: an engine's first
  admission (``ValueError`` naming frames; the reference's
  ``KeyError: 'frames'``), the speculative engine, a bucketed
  (``true_len``) prefill, and a prefill over ``pack_params`` weights (the
  reference's fails in its layer scan: its packing keeps no layer axis in
  ``enc_blocks``' scales); a decode step over the packed weights serves
  the logits of their decoded values.
* Hoisted weights serve the per-call hook's logits; the launcher exits
  with the engine's error; the KV kernels' contracts pass whisper at full
  width (hd 64, 20 KV heads, MHA).

The reference's prefill and decode are jitted once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.core.transprecision import pack_params as j_pack_params  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.transprecision import get_policy, pack_params  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve import (Request, ServeConfig, ServingEngine,  # noqa: E402
                               SpeculativeEngine)
from repro_torch.serve.engine import check_kv_kernels  # noqa: E402
from test_torch_serve import _codes  # noqa: E402
from test_torch_vlm import _np, family_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "whisper-large-v3"
POLICY = "paper_edge_p8"
MAX_LEN = 32
_J_PREFILL = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))
_J_DECODE = jax.jit(jsm.decode_step, static_argnums=(3, 4))


def _policies(layout):
    kw = dict(kv_format="posit8", kv_layout=layout, kv_page_size=8)
    return (dataclasses.replace(j_get_policy(POLICY), **kw),
            dataclasses.replace(get_policy(POLICY), **kw))


def _inputs(cfg, b=2, s=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (b, s)),
            rng.standard_normal((b, cfg.enc_seq, cfg.d_model)).astype(
                np.float32))


@pytest.fixture(scope="module")
def f32():
    return family_pair(ARCH)


def _kv(cache):
    return {f"{i}/{k}": v for i, blk in enumerate(cache["blocks"])
            for k, v in blk.items()}


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_prefill_and_greedy_decode_equal_reference(f32, layout):
    jc, tc, jp, tp = f32
    jpol, tpol = _policies(layout)
    toks, frames = _inputs(tc)
    jl, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                 "frames": jnp.asarray(frames)}, jc,
                            MAX_LEN, jpol)
    tl, tcache = serve_model.prefill(
        tp, {"tokens": torch.from_numpy(toks), "frames":
             torch.from_numpy(frames)}, tc, MAX_LEN, tpol)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=1e-5)
    assert tcache["memory"].dtype == torch.float32
    np.testing.assert_allclose(_np(tcache["memory"]), _np(jcache["memory"]),
                               rtol=1e-6, atol=1e-6)
    t_kv, j_kv = _kv(tcache), _kv(jcache)
    assert set(t_kv) == set(j_kv)
    for name, leaf in t_kv.items():
        assert tuple(leaf.shape) == tuple(j_kv[name].shape), name
        if name.endswith(("xk", "xv")):     # O(1) values: 1e-6 each way
            np.testing.assert_allclose(_np(leaf), _np(j_kv[name]),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    streams = ([], [])
    for _ in range(8):
        jt = np.asarray(jl)[:, :tc.vocab].argmax(-1)[:, None]
        tt = tl[:, :tc.vocab].argmax(-1)[:, None]
        streams[0].append(jt[:, 0].tolist())
        streams[1].append(tt[:, 0].tolist())
        jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(jt, jnp.int32), jc,
                               jpol)
        tl, tcache = serve_model.decode_step(tp, tcache, tt, tc, tpol)
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=1e-5)
    assert streams[1] == streams[0]
    t_kv, j_kv = _kv(tcache), _kv(jcache)
    for name in ("0/k", "0/v"):                 # (P, ...) stacked
        np.testing.assert_array_equal(_codes(t_kv[name]), _codes(j_kv[name]))
        np.testing.assert_array_equal(_np(t_kv[name + "_scale"]),
                                      _np(j_kv[name + "_scale"]))


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_engine_kv_bytes_equal_and_admission_refused(f32, layout):
    """An engine builds in each layout and counts the reference's KV
    bytes (self K/V codes and scales plus the unpaged cross K/V); its
    first admission raises ``ValueError`` naming frames, the reference's
    ``KeyError: 'frames'``."""
    jc, tc, jp, tp = f32
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
              kv_layout=layout, page_size=8)
    je = JServingEngine(jc, jp, JServeConfig(**kw), policy=POLICY)
    te = ServingEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                       device="cpu")
    cross = 2 * tc.n_layers * 2 * tc.enc_seq * tc.n_kv_heads \
        * tc.head_dim * 4                         # xk + xv, float32
    assert te.kv_cache_bytes() == je.kv_cache_bytes() > cross
    assert te.kv_cache_live_bytes() == je.kv_cache_live_bytes()
    assert set(te.cache["blocks"][0]) >= {"xk", "xv"}
    assert tuple(te.cache["memory"].shape) == (2, tc.enc_seq, tc.d_model)
    prompt = np.arange(4)
    with pytest.raises(ValueError, match="frames"):
        te.serve([Request(uid=0, prompt=prompt, max_new=2)])
    with pytest.raises(KeyError, match="frames"):
        je.serve([JRequest(uid=0, prompt=prompt, max_new=2)])


def test_speculative_and_bucketed_prefill_refused_as_reference(f32):
    jc, tc, jp, tp = f32
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    with pytest.raises(ValueError, match="encoder-decoder"):
        SpeculativeEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                          device="cpu")
    with pytest.raises(ValueError, match="decoder-only attention stack"):
        JSpeculative(jc, jp, JServeConfig(**kw), policy=POLICY)
    with pytest.raises(ValueError, match="encoder-decoder"):
        serve_model.verify_step(tp, serve_model.init_cache(
            tc, 1, 16, device="cpu"), torch.zeros((1, 2), dtype=torch.long),
            tc)
    toks, frames = _inputs(tc)
    with pytest.raises(ValueError, match="bucketed prefill"):
        serve_model.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "frames": torch.from_numpy(frames)}, tc,
                            MAX_LEN, true_len=[3, 4])
    with pytest.raises(ValueError, match="bucketed prefill"):
        _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                        "frames": jnp.asarray(frames)}, jc, MAX_LEN,
                   j_get_policy("bf16"), true_len=jnp.asarray([3, 4]))


def test_packed_prefill_refused_as_reference(f32):
    """``pack_params`` (``paper_edge_p8``) packs the encoder and the cross
    weights as the reference does (``enc_blocks``' input-major scales one
    row across their layers); a prefill over them raises ``ValueError``
    on both sides, while a decode step over the packed weights serves the
    logits of their decoded values (served with the weight roles off; the
    untied embedding keeps its role, its rows quantized at lookup)."""
    jc, tc, jp, tp = f32
    jpol, tpol = j_get_policy(POLICY), get_policy(POLICY)
    tpk = pack_params(tp, tpol)
    assert isinstance(tpk["blocks"][0]["wq_x"], QuantizedTensor)
    assert tuple(tpk["enc_blocks"][0]["wq"].scale.shape) == (1, 1, 64)
    assert tuple(tpk["enc_blocks"][0]["wo"].scale.shape) == (1, 64, 1)
    assert tuple(tpk["blocks"][0]["wq"].scale.shape) == (2, 1, 64)
    toks, frames = _inputs(tc)
    with pytest.raises(ValueError, match="packed"):
        serve_model.prefill(tpk, {"tokens": torch.from_numpy(toks),
                                  "frames": torch.from_numpy(frames)}, tc,
                            MAX_LEN, tpol)
    with pytest.raises(ValueError, match="leading axis"):
        jsm.prefill(jax.jit(j_pack_params, static_argnums=(1,))(jp, jpol),
                    {"tokens": jnp.asarray(toks, jnp.int32),
                     "frames": jnp.asarray(frames)}, jc, MAX_LEN, jpol)

    def decoded(node):
        if isinstance(node, dict):
            return {k: decoded(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(decoded(v) for v in node)
        return (node.dequantize(torch.bfloat16)
                if isinstance(node, QuantizedTensor) else node)

    logits = []
    hook_off = dataclasses.replace(tpol, attn_weights=None,
                                   mlp_weights=None)
    for params, pol in ((tpk, tpol), (decoded(tpk), hook_off)):
        cache = serve_model.init_cache(tc, 2, MAX_LEN, policy=pol,
                                       device="cpu")
        for blk in cache["blocks"]:
            for name in ("xk", "xv"):
                blk[name].normal_(generator=torch.Generator().manual_seed(3))
        logits.append(serve_model.decode_step(
            params, cache, torch.from_numpy(toks[:, :1]), tc, pol)[0])
    assert torch.isfinite(logits[0]).all()
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)


def test_hoisted_serving_equals_the_per_call_hook(f32):
    _, tc, _, tp = f32
    policy = get_policy(POLICY)
    hoisted = lm.hoist_weight_quant(tp, policy)
    free = lm.weights_free(policy, tc.tie_embed)
    toks, frames = _inputs(tc, seed=1)
    batch = {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}
    a, ca = serve_model.prefill(tp, batch, tc, MAX_LEN, policy)
    b, cb = serve_model.prefill(hoisted, batch, tc, MAX_LEN, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)
    torch.testing.assert_close(cb["memory"], ca["memory"], rtol=0, atol=0)
    tok = a[:, :tc.vocab].argmax(-1)[:, None]
    a, _ = serve_model.decode_step(tp, ca, tok, tc, policy)
    b, _ = serve_model.decode_step(hoisted, cb, tok, tc, free)
    torch.testing.assert_close(b, a, rtol=0, atol=0)


@pytest.mark.parametrize("kv_format", ["posit16", "posit8", "posit4"])
def test_kv_kernel_check_passes_whisper(kv_format):
    """Full width: hd 64 (128-B bf16 append rows, 8 lanes), one query
    head per KV head over 20 KV heads and a 448-row ring pass both
    kernels' contracts."""
    pol = dataclasses.replace(get_policy(POLICY), kv_format=kv_format)
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.head_dim, cfg.n_kv_heads, cfg.n_heads) == (64, 20, 20)
    check_kv_kernels(cfg, pol, 448)


def test_serve_launcher_refuses_whisper():
    from repro_torch.launch import serve as launch_serve
    with pytest.raises(ValueError, match="frames"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--requests",
                           "2", "--max-new", "2", "--batch", "2",
                           "--max-len", "32"])
