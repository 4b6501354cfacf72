"""The arithmetic of the branch-free posit encoder, checked on the CPU.

``posit::encode<N, ES>`` (``src/repro_torch/csrc/posit_codec.cuh``), the
write path of K2, K3 and K5, takes one straight-line path for every input:
the regime k = t >> ES of the total exponent t is clamped to [-(N-1), N-2];
the head 10 (k >= 0) or 01 (k < 0), the ES exponent bits and the 23
fraction bits sit in the high half of a 64-bit word, which an arithmetic
shift right by k (or -k - 1) turns into regime, terminator, exponent and
fraction; the body is the word's top N - 1 bits after one add of
(half - 1) + lsb below the cut; one clamp to [1, 2^(N-1) - 1]; the sign by
two's complement; zero (and flushed subnormals) and NaR by selects.
``encode_model`` runs exactly those integer steps in numpy and is held bit
for bit to the port's ``encode_tile`` and the reference's
``repro.kernels.posit_encode.encode_tile`` for every format the kernels
are built for: every sign and biased exponent, the rounding ties of every
regime length with one ulp either side and all-zero / all-one bits below
the guard, the special values and 2^16 random bit patterns.  K2's wire
mode (``normalize``: a nonzero subnormal gives +-minpos) is held to
``core.posit.encode_f32`` of both packages on the same inputs and on 2^16
random subnormals.  ``test_kernel_on_one_exponent_band`` and
``test_wire_mode_kernel_on_subnormals`` need the GPU (marker ``cuda``);
the machine with the GPU has no JAX, so the JAX imports are optional and
only the card tests run there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.core import posit as jposit
    from repro.kernels import posit_encode as jenc
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core.posit import encode_f32  # noqa: E402
from repro_torch.kernels.posit_encode import encode_tile  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FORMATS = ["posit4_1", "posit8_0", "posit8_1", "posit8_2", "posit16_0",
           "posit16_1", "posit16_2"]
U64 = np.uint64
N_INPUTS = 1 << 17


def encode_model(x, n: int, es: int, bias: int, normalize: bool = False):
    """float32 array -> posit codes (uint64), by the CUDA encoder's steps;
    ``normalize`` is K2's wire mode (``kNormalize``)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(U64)
    s = bits >> U64(31)
    exp_raw = ((bits >> U64(23)) & U64(0xFF)).astype(np.int64)
    t = exp_raw - 127 - bias
    k = np.clip(t >> es, -(n - 1), n - 2)          # arithmetic shift
    ef = ((t & ((1 << es) - 1)).astype(U64) << U64(23)) | (
        bits & U64(0x7FFFFF))                       # exponent, fraction
    neg = k >> 63                                   # -1 for k < 0
    hi = ((2 + neg).astype(U64) << U64(30)) | (ef << U64(7 - es))
    word = ((hi << U64(32)).view(np.int64) >> (k ^ neg)).view(U64)
    cut = 65 - n                                    # bits below the body
    lsb = (word >> U64(cut)) & U64(1)
    body = (word + U64((1 << (cut - 1)) - 1) + lsb) >> U64(cut)
    body = np.clip(body, U64(1), U64((1 << (n - 1)) - 1))
    neg_s = (U64(0) - s) & U64(0xFFFFFFFF)          # 0u - s
    code = ((body ^ neg_s) + s) & U64((1 << n) - 1)
    tiny = U64(0)
    if normalize:                                   # +-minpos
        tiny = np.where((bits << U64(1)) & U64(0xFFFFFFFF) == 0, U64(0),
                        ((U64(1) ^ neg_s) + s) & U64((1 << n) - 1))
    return np.where(exp_raw == 255, U64(1 << (n - 1)),
                    np.where(exp_raw == 0, tiny, code))


def _rounding_cases(n: int, es: int, bias: int, rng):
    """Bit patterns at every regime length: for each total exponent t the
    regime leaves avail = N - 1 - (regime + terminator) body bits, so the
    guard is exponent bit or fraction bit avail - ES; around it, the tie
    (with kept lsb 0 and 1), one ulp either side, and all-zero / all-one
    fraction bits below the guard (guard 0 and 1)."""
    pats = []
    span = (n + 1) << es
    for t in range(-span, span + 1):
        exp_raw = t + 127 + bias
        if not 1 <= exp_raw <= 254:
            continue
        k = t >> es
        w0 = k + 2 if k >= 0 else 1 - k
        g = 22 - (n - 1 - w0 - es)          # guard's fraction bit, if any
        fracs = {0, 1, 0x7FFFFF, 0x7FFFFE, 0x400000}
        if 0 <= g <= 22:
            tie, below = 1 << g, (1 << g) - 1
            up = int(rng.integers(0, 1 << 23)) & ~((tie << 1) - 1)
            for hi in (0, tie << 1, up):    # kept lsb 0 / 1, random above
                for f in (tie, tie - 1, tie + 1, below, tie | below):
                    fracs.add((hi | f) & 0x7FFFFF)
        for f in fracs:
            for s in (0, 1):
                pats.append((s << 31) | (exp_raw << 23) | f)
    return np.asarray(pats, np.uint32)


def _inputs(n: int, es: int, bias: int):
    rng = np.random.default_rng(n * 10 + es)
    exps = np.arange(256, dtype=np.uint32) << 23
    fracs = np.asarray([0, 1, 0x400000, 0x3FFFFF, 0x7FFFFF]
                       + list(rng.integers(0, 1 << 23, 3)), np.uint32)
    every_exp = (exps[:, None] | fracs[None, :]).reshape(-1)
    special = np.asarray([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                          1.4e-45, -1.17e-38, 1.18e-38, 3.4e38, -3.4e38],
                         np.float32).view(np.uint32)
    pats = np.concatenate([every_exp, every_exp | np.uint32(1 << 31),
                           _rounding_cases(n, es, bias, rng), special])
    # at least 2^16 random patterns, to one length for every format (the
    # reference's eager ops then compile once)
    randoms = rng.integers(0, 1 << 32, N_INPUTS - len(pats),
                           dtype=np.uint64).astype(np.uint32)
    assert len(randoms) >= 1 << 16
    return np.concatenate([pats, randoms]).view(np.float32)


def _codes(a):
    a = np.asarray(a)
    return (a.view(np.uint16) if a.dtype == np.int16 else a).astype(U64)


@pytest.mark.parametrize("name", FORMATS)
def test_model_matches_port_and_reference(name):
    ft, fj = tformats.get(name), jformats.get(name)
    x = _inputs(ft.bits, ft.es, ft.bias)
    got = encode_model(x, ft.bits, ft.es, ft.bias)
    np.testing.assert_array_equal(
        got, _codes(encode_tile(torch.from_numpy(x.copy()), ft).numpy()))
    np.testing.assert_array_equal(
        got, _codes(jenc.encode_tile(jnp.asarray(x), fj)))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_1", "posit4_1"])
@pytest.mark.parametrize("bias", [-5, 3])
def test_model_with_a_format_bias(name, bias):
    """The exponent bias moves every regime boundary: ties and saturation
    must move with it."""
    import dataclasses
    ft = dataclasses.replace(tformats.get(name), bias=bias)
    x = _inputs(ft.bits, ft.es, bias)
    np.testing.assert_array_equal(
        encode_model(x, ft.bits, ft.es, bias),
        _codes(encode_tile(torch.from_numpy(x.copy()), ft).numpy()))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2"])
def test_model_saturates_and_flushes(name):
    """maxpos and minpos (never 0 or NaR) far outside the dynamic range;
    0 for zeros and subnormals of both signs; NaR for inf and NaN."""
    ft = tformats.get(name)
    n = ft.bits
    maxpos, nar = (1 << (n - 1)) - 1, 1 << (n - 1)
    x = np.asarray([3.4e38, -3.4e38, 1.2e-38, -1.2e-38, 0.0, -0.0, 1e-40,
                    -1e-45, np.inf, -np.inf, np.nan], np.float32)
    got = encode_model(x, n, ft.es, ft.bias)
    neg = (1 << n) - 1                      # two's complement of 1
    np.testing.assert_array_equal(
        got, np.asarray([maxpos, (1 << n) - maxpos, 1, neg, 0, 0, 0, 0, nar,
                         nar, nar], U64))


def _subnormals(count, seed):
    rng = np.random.default_rng(seed)
    mag = rng.integers(1, 1 << 23, count, dtype=np.uint64).astype(np.uint32)
    sign = rng.integers(0, 2, count, dtype=np.uint64).astype(np.uint32)
    return (mag | (sign << np.uint32(31))).view(np.float32)


@pytest.mark.parametrize("name", FORMATS)
def test_wire_mode_model_matches_encode_f32(name):
    """``posit::encode<N, ES, true>``: the encoder's steps with +-minpos
    for a nonzero subnormal are ``encode_f32`` (which normalises the
    subnormal, then saturates its regime) on every input."""
    ft, fj = tformats.get(name), jformats.get(name)
    x = np.concatenate([_inputs(ft.bits, ft.es, ft.bias),
                        _subnormals(1 << 16, ft.bits)])
    got = encode_model(x, ft.bits, ft.es, ft.bias, normalize=True)
    np.testing.assert_array_equal(
        got, _codes(encode_f32(torch.from_numpy(x.copy()), ft).numpy()))
    np.testing.assert_array_equal(
        got, _codes(jposit.encode_f32(jnp.asarray(x), fj)))
    sub = (x.view(np.uint32) & 0x7F800000) == 0
    assert sub.sum() > 1 << 16
    flush = encode_model(x, ft.bits, ft.es, ft.bias)
    np.testing.assert_array_equal(got[~sub], flush[~sub])


@pytest.mark.parametrize("bias", [-90, -93, 8])
def test_wire_mode_refuses_a_bias_that_unsaturates_subnormals(bias):
    """At posit16_2, k = (-127 - bias) >> 2 reaches -(n - 1) = -15 for
    bias >= -70: -90 and -93 would make some subnormals representable
    and raise; 8 is accepted and equals ``encode_f32``."""
    import dataclasses
    from repro_torch.kernels.posit_encode import posit_encode
    ft = dataclasses.replace(tformats.get("posit16_2"), bias=bias)
    x = torch.from_numpy(_subnormals(4096, 1))
    if bias < -70:
        with pytest.raises(ValueError, match="representable"):
            posit_encode(x, ft, subnormals="normalize")
    else:
        np.testing.assert_array_equal(
            encode_model(x.numpy(), 16, 2, bias, normalize=True),
            _codes(posit_encode(x, ft, subnormals="normalize").numpy()))
        assert torch.equal(posit_encode(x, ft, subnormals="normalize"),
                           encode_f32(x, ft))


@pytest.mark.cuda
def test_wire_mode_kernel_on_subnormals():
    """K2's wire mode against ``encode_f32`` on the card, for every built
    format: every float32 subnormal of both signs (2^24 - 2 values and the
    two zeros), then 2^20 random bit patterns, also as a view off a
    16-byte boundary with a ragged tail.  One launch per call; the flush
    mode still gives 0 for every subnormal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.posit_encode import posit_encode
    dev = torch.device("cuda")
    pats = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    pats = (pats & 0x7FFFFF) | ((pats >> 23) << 31)
    sub = torch.where(pats >= 1 << 31, pats - (1 << 32), pats).to(
        torch.int32).view(torch.float32)
    rng = np.random.default_rng(7)
    rnd = torch.from_numpy(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
                           .astype(np.uint32).view(np.float32)).to(dev)
    for name in FORMATS:
        ft = tformats.get(name)
        for xin in (sub, rnd, rnd[1:], rnd[3:-2]):
            before = LAUNCHES["posit_encode"]
            got = posit_encode(xin, ft, subnormals="normalize")
            assert LAUNCHES["posit_encode"] == before + 1
            assert torch.equal(got, encode_f32(xin, ft)), name
        assert not posit_encode(sub, ft).any(), name


@pytest.mark.cuda
def test_kernel_on_one_exponent_band():
    """K2 on every float32 of the binade [1, 2) and its negative (2^24
    values, so every fraction bit pattern) against the plain version on
    the card, for every built format; then a view that starts 4 bytes
    past a 16-byte boundary and a length that is not a multiple of 4 (the
    kernel's scalar head and tail).  One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.posit_encode import posit_encode
    dev = torch.device("cuda")
    pats = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    pats = (pats & 0x7FFFFF) | (127 << 23) | ((pats >> 23) << 31)
    x = torch.where(pats >= 1 << 31, pats - (1 << 32), pats).to(
        torch.int32).view(torch.float32)
    for name in FORMATS:
        ft = tformats.get(name)
        for xin in (x, x[1:], x[3:-2]):
            before = LAUNCHES["posit_encode"]
            got = posit_encode(xin, ft)
            assert LAUNCHES["posit_encode"] == before + 1
            assert torch.equal(got, encode_tile(xin, ft)), name
