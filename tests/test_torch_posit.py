"""Posit codec of the PyTorch port vs the JAX package, bit for bit.

Every 8-bit and 16-bit code through both decoders; float32 sweeps (normal
values at three scales, subnormals, +-0, +-inf, NaN and random bit
patterns) through both encoders; the kernels' plain versions against the
reference's tile functions and its Pallas kernels in interpret mode.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import posit as jposit  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.kernels.posit_decode import decode_tile as j_decode_tile  # noqa: E402
from repro.kernels.posit_decode import posit_decode as j_posit_decode  # noqa: E402
from repro.kernels.posit_encode import encode_tile as j_encode_tile  # noqa: E402
from repro.kernels.posit_encode import posit_encode as j_posit_encode  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import posit as tposit  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.posit_decode import decode_tile, posit_decode  # noqa: E402
from repro_torch.kernels.posit_encode import encode_tile, posit_encode  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

CODE_FMTS = ["posit4_1", "posit8_0", "posit8_1", "posit8_2", "posit16_0",
             "posit16_1", "posit16_2"]


def _codes(name):
    """Every code of the format: numpy in the reference's storage dtype and
    torch in the port's (int16 holds the posit16 bit patterns)."""
    fmt = jformats.get(name)
    c = np.arange(1 << fmt.bits).astype(fmt.np_storage_dtype)
    t = torch.from_numpy(c.view(np.int16) if fmt.bits == 16 else c.copy())
    return c, t


def _sweep():
    rng = np.random.default_rng(0)
    normal = rng.normal(0, 1, 4096).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        1.4e-45, -1.17e-38, 1.18e-38, 3.4e38, -3.4e38,
                        2.0 ** -126, 2.0 ** -127], np.float32)
    pats = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    return np.concatenate([normal, normal * 1e-8, normal * 1e8, special,
                           pats])


def _assert_same_floats(want, got):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  want[~nan].view(np.uint32))


def _assert_same_codes(want, got, bits):
    m = (1 << bits) - 1
    np.testing.assert_array_equal(
        np.asarray(got.numpy()).astype(np.int64) & m,
        np.asarray(want).astype(np.int64) & m)


@pytest.mark.parametrize("name", CODE_FMTS)
def test_decode_to_f32_every_code(name):
    c, t = _codes(name)
    _assert_same_floats(jposit.decode_to_f32(c, jformats.get(name)),
                        tposit.decode_to_f32(t, tformats.get(name)))
    _assert_same_floats(jposit.decode_to_f32(c, jformats.get(name)),
                        tref.posit_decode_ref(t, tformats.get(name)))


@pytest.mark.parametrize("name", CODE_FMTS)
def test_decode_tile_every_code(name):
    c, t = _codes(name)
    fmt_j, fmt_t = jformats.get(name), tformats.get(name)
    want = j_decode_tile(jnp.asarray(c), fmt_j)
    _assert_same_floats(want, decode_tile(t, fmt_t))
    _assert_same_floats(want, posit_decode(t, fmt_t))      # CPU: plain path
    pallas = j_posit_decode(jnp.asarray(c.reshape(-1, 256) if c.size > 256
                                        else c[None]), fmt_j, interpret=True)
    _assert_same_floats(np.asarray(pallas).reshape(-1), decode_tile(t, fmt_t))


@pytest.mark.parametrize("name", CODE_FMTS)
def test_encode_f32_sweep_normalises_subnormals(name):
    x = _sweep()
    fmt_j, fmt_t = jformats.get(name), tformats.get(name)
    want = jposit.encode_f32(x, fmt_j)
    _assert_same_codes(want, tposit.encode_f32(torch.from_numpy(x), fmt_t),
                       fmt_t.bits)
    _assert_same_codes(want, tref.posit_encode_ref(torch.from_numpy(x),
                                                   fmt_t), fmt_t.bits)


@pytest.mark.parametrize("name", CODE_FMTS)
def test_encode_tile_sweep_flushes_subnormals(name):
    x = _sweep()
    fmt_j, fmt_t = jformats.get(name), tformats.get(name)
    want = j_encode_tile(jnp.asarray(x), fmt_j)
    got = encode_tile(torch.from_numpy(x), fmt_t)
    assert got.dtype == fmt_t.storage_dtype
    _assert_same_codes(want, got, fmt_t.bits)
    _assert_same_codes(want, posit_encode(torch.from_numpy(x), fmt_t),
                       fmt_t.bits)
    n = x.size - x.size % 256
    pallas = j_posit_encode(jnp.asarray(x[:n].reshape(-1, 256)), fmt_j,
                            interpret=True)
    _assert_same_codes(np.asarray(pallas).reshape(-1),
                       encode_tile(torch.from_numpy(x[:n]), fmt_t),
                       fmt_t.bits)


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2", "int8"])
@pytest.mark.parametrize("axis", [None, (0,)])
def test_quantize_dequantize_fake_quant(name, axis):
    """Weight scales round (exp2(round(log2 mean of nonzero |w|))); codes,
    scales and the fake-quantized values are bit-exact at weight-like
    magnitudes."""
    rng = np.random.default_rng(1)
    w = (rng.normal(0, 0.03, (48, 24)) * (rng.random((48, 24)) > 0.1)
         ).astype(np.float32)
    jq = jquant.quantize(w, name, axis=axis)
    tq = tquant.quantize(torch.from_numpy(w), name, axis=axis)
    bits = tq.fmt.bits
    _assert_same_codes(jq.data, tq.data, bits)
    _assert_same_floats(jq.scale, tq.scale)
    _assert_same_floats(jquant.dequantize(jq), tquant.dequantize(tq))
    _assert_same_floats(jquant.fake_quant(w, name, axis),
                        tquant.fake_quant(torch.from_numpy(w), name, axis))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2"])
@pytest.mark.parametrize("shape,axis", [((48, 24), (0,)),
                                        ((5, 12, 16), (0, 1)),
                                        ((24, 48), None)])
def test_fake_quant_in_blocks_equals_whole(monkeypatch, name, shape, axis):
    """The fake-quant codes the scaled tensor a block of elements at a
    time, with the whole tensor's scale: bit-equal to the one-shot round
    trip ``dequantize(quantize(...))``, in one block and in many, for a
    transposed view too (the tied head)."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.normal(0, 0.03, shape).astype(
        np.float32)).to(torch.bfloat16)
    for x in (w, w.transpose(0, -1)):
        whole = tquant.dequantize(tquant.quantize(x, name, axis), x.dtype)
        assert torch.equal(tquant.fake_quant(x, name, axis), whole)
        monkeypatch.setattr(tquant, "_FAKE_QUANT_BLOCK", 100)
        blocked = tquant.fake_quant(x, name, axis)
        monkeypatch.undo()
        assert blocked.dtype == whole.dtype and blocked.shape == whole.shape
        assert torch.equal(blocked, whole)


def test_fake_quant_straight_through_gradient():
    x = torch.linspace(-2, 2, 17, requires_grad=True)
    g = torch.arange(17.0)
    tquant.fake_quant(x, "posit8_2").backward(g)
    assert torch.equal(x.grad, g)


def test_posit32_decode_encode_random():
    """n=32: decode rounds the fraction RNE into 23 bits; codes are int32
    in the port and uint32 in the reference (same bits)."""
    rng = np.random.default_rng(2)
    c = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64).astype(np.uint32)
    fj, ft = jformats.get("posit32_2"), tformats.get("posit32_2")
    _assert_same_floats(jposit.decode_to_f32(c, fj),
                        tposit.decode_to_f32(torch.from_numpy(c.view(
                            np.int32)), ft))
    x = _sweep()
    got = tposit.encode_f32(torch.from_numpy(x), ft)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(jposit.encode_f32(x, fj)))
