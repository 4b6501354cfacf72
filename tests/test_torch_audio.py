"""The audio family (whisper smoke: a 2-layer encoder over 24 frames,
cross-attention in each of the 2 decoder blocks, MHA, gelu) in the port
against the reference, from the same seeded numpy inputs and weights.

* ``sinusoid_positions`` (numpy float64, cast to f32) and the pipeline's
  ``frames`` (``default_rng(seed + 13 + step)``) equal the reference's bit
  for bit.
* The encoder (``encode_audio``: frames plus the sinusoid in the model's
  dtype, non-causal blocks without RoPE, ``enc_norm``) and ``forward`` /
  ``loss_fn``: float32 within rtol 1e-5, atol 1e-5 of the reference's;
  bf16 within 1/32 of the largest magnitude.
* Remat "dots" and "none" give "full"'s loss bit for bit and its
  gradients within 1e-6 (the encoder's and the cross-attention's too).
* ``hoist_weight_quant`` quantizes every encoder layer's attention and MLP
  weights, each layer's slice on its own, and leaves the cross-attention
  weights raw (the reference's paths hook none of them).

The reference's forward, loss and encoder are jitted once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.transprecision import BF16, get_policy  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from test_torch_vlm import _np, family_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "whisper-large-v3"
_J_FORWARD = jax.jit(jlm.forward, static_argnums=(2,))
_J_LOSS = jax.jit(jlm.loss_fn, static_argnums=(2,))
_J_ENCODE = jax.jit(jlm._encode_audio, static_argnums=(2, 3))


@pytest.mark.parametrize("seq,dim", [(24, 64), (1500, 1280), (7, 10)])
def test_sinusoid_positions_equal_reference(seq, dim):
    got = tcommon.sinusoid_positions(seq, dim)
    want = np.asarray(jcommon.sinusoid_positions(seq, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == (seq, dim)
    np.testing.assert_array_equal(got.numpy(), want)


def test_pipeline_frames_equal_reference():
    tc = tconfigs.get_config(ARCH, smoke=True)
    jc = jconfigs.get_config(ARCH, smoke=True)
    tpipe = make_pipeline(tc, global_batch=2, seq_len=8, seed=4,
                          device="cpu")
    jpipe = j_make_pipeline(jc, global_batch=2, seq_len=8, seed=4)
    for step in (0, 3):
        got, want = tpipe.global_batch(step), jpipe.global_batch(step)
        assert set(got) == set(want) == {"tokens", "labels", "frames"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    batch = tpipe(2)
    assert batch["frames"].dtype == torch.float32
    assert tuple(batch["frames"].shape) == (2, tc.enc_seq, tc.d_model)
    assert batch["tokens"].dtype == torch.int64


@pytest.fixture(scope="module")
def models():
    return {d: family_pair(ARCH, d) for d in ("float32", "bfloat16")}


def _batch(cfg, seed=0, b=2, s=10):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[1, -3:] = -1
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "labels": labels,
            "frames": rng.standard_normal((b, cfg.enc_seq, cfg.d_model))
            .astype(np.float32)}


def _to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_forward_and_loss_match_reference(models, dtype):
    jc, tc, jp, tp = models[dtype]
    batch = _batch(tc)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmem = _J_ENCODE(jp, jb["frames"], jc, jlm.BF16)
    jl, _ = _J_FORWARD(jp, jb, jc)
    jloss, _ = _J_LOSS(jp, jb, jc)
    tb = _to_torch(batch)
    with torch.no_grad():
        tmem = tlm.encode_audio(tp, tb["frames"], tc, BF16)
        tl, _ = tlm.forward(tp, tb, tc)
        tloss, _ = tlm.loss_fn(tp, tb, tc)
    assert tmem.dtype == tc.dtype
    for got, want in ((tmem, jmem), (tl, jl)):
        want = _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_allclose(_np(got), want, rtol=0,
                                       atol=np.abs(want).max() / 32)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-2)


def test_remat_modes(models):
    """"dots" and "none" against "full": equal loss bit for bit, every
    gradient within 1e-6 (the encoder's and the cross-attention's
    included)."""
    _, tc, _, tp = models["float32"]
    batch = _to_torch(_batch(tc, seed=1))
    out = {}
    for remat in ("full", "dots", "none"):
        cfg = dataclasses.replace(tc, remat=remat)
        params = jax.tree_util.tree_map(
            lambda t: t.detach().clone().requires_grad_(), tp)
        loss, _ = tlm.loss_fn(params, batch, cfg)
        loss.backward()
        out[remat] = (float(loss.detach()), [
            t.grad for t in jax.tree_util.tree_leaves(params)])
    for remat in ("dots", "none"):
        assert out[remat][0] == out["full"][0], remat
        for a, b in zip(out[remat][1], out["full"][1]):
            assert a is not None
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_hoist_quantizes_the_encoder_and_leaves_cross_weights_raw(models):
    _, tc, _, tp = models["float32"]
    policy = get_policy("paper_edge_p8")
    hoisted = tlm.hoist_weight_quant(tp, policy)
    q = {"attn_weights": lambda w: policy.quantize_weight(w, "attn_weights"),
         "mlp_weights": lambda w: policy.quantize_weight(w, "mlp_weights")}
    roles = {"wq": "attn_weights", "wk": "attn_weights",
             "wv": "attn_weights", "wo": "attn_weights",
             "wi": "mlp_weights", "wo_mlp": "mlp_weights"}
    enc, raw = hoisted["enc_blocks"][0], tp["enc_blocks"][0]
    assert set(enc) == set(raw)
    for name, leaf in enc.items():
        if name in roles:
            want = torch.stack([q[roles[name]](w) for w in raw[name]])
            assert torch.equal(leaf, want), name
            assert not torch.equal(leaf, raw[name]), name
        else:
            assert leaf is raw[name], name
    dec, raw_dec = hoisted["blocks"][0], tp["blocks"][0]
    for name in ("ln_x", "wq_x", "wk_x", "wv_x", "wo_x"):
        assert dec[name] is raw_dec[name], name
    assert not torch.equal(dec["wq"], raw_dec["wq"])
    assert hoisted["enc_norm"] is tp["enc_norm"]
