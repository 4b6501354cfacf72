"""The arithmetic of the branch-free posit decoder, checked on the CPU.

``posit::decode<N, ES>`` and its run-time-es form ``posit::decode_es<N>``
(``src/repro_torch/csrc/posit_codec.cuh``), the read path of K1, K4, K6
and K7, take one straight-line path for every code: the code is shifted to
the top of a 32-bit word (sign at bit 31, bits above N dropped); |code| by
the arithmetic sign mask; one more shift left-aligns the N - 1 body bits;
the regime run r is the count of leading zeros of the body XOR its own
arithmetic sign mask, k = r - 1 or -r; a left shift by r + 1 that gives 0
at 32 or more leaves exponent then fraction at the top; the exponent is the
top ES bits (0 for ES = 0), the fraction goes to the mantissa with one
shift; a zero body (only 0 and NaR) selects +0 or the quiet NaN at the end.
``decode_model`` runs exactly those integer steps in numpy and is held bit
for bit to the port's ``decode_tile`` and the reference's
``repro.kernels.posit_decode.decode_tile`` (both Algorithm 1's threshold
compares) on every code of every format the kernels are built for, to
float32 and to bfloat16. ``test_kernel_on_every_code`` needs the GPU
(marker ``cuda``); the machine with the GPU has no JAX, so the JAX imports
are optional and only the card test runs there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.kernels import posit_decode as jdec
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels.posit_decode import decode_tile  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FORMATS = ["posit4_1", "posit8_0", "posit8_1", "posit8_2", "posit16_0",
           "posit16_1", "posit16_2"]
U64 = np.uint64
M32 = U64(0xFFFFFFFF)
QNAN = 0x7FC00000


def _clz32(v):
    """Leading zeros of 32-bit words (32 for 0), exactly: frexp of the
    (exact) float64 gives the bit length."""
    return 32 - np.frexp(v.astype(np.float64))[1].astype(np.int64)


def _run_and_body(codes, n: int):
    """The decoder's first steps: (x, sign mask, body, regime run r)."""
    c = np.asarray(codes).astype(np.int64).astype(U64) & M32
    x = (c << U64(32 - n)) & M32                    # sign at bit 31
    sx = np.where(x >> U64(31) == 1, M32, U64(0))   # arithmetic sign mask
    body = ((((x ^ sx) - sx) & M32) << U64(1)) & M32
    lead_mask = np.where(body >> U64(31) == 1, M32, U64(0))
    return x, sx, body, _clz32(body ^ lead_mask)


def decode_model(codes, n: int, es: int, bias: int = 0):
    """posit codes (any integer dtype; bits above n ignored) -> float32 bit
    patterns (uint32), by the CUDA decoder's steps; ``es`` may vary as in
    ``decode_es``."""
    x, sx, body, r = _run_and_body(codes, n)
    k = np.where(body >> U64(31) == 1, r - 1, -r)
    # shf.l.clamp: a shift of 32 or more gives 0
    rest = (body << np.minimum(r + 1, 32).astype(U64)) & M32
    e = rest >> U64(32 - es)                        # 0 for es = 0
    t = k * (1 << es) + e.astype(np.int64) + bias
    v = ((x & U64(0x80000000)) | ((t + 127).astype(U64) << U64(23))
         | (((rest << U64(es)) & M32) >> U64(9)))
    return np.where(body == 0, sx & U64(QNAN), v).astype(np.uint32)


def bf16_rn(bits):
    """float32 bit patterns -> bfloat16 bit patterns, round to nearest even
    (NaN stays NaN), as ``__float2bfloat16_rn``."""
    b = bits.astype(U64)
    rounded = ((b + U64(0x7FFF) + ((b >> U64(16)) & U64(1))) >> U64(16))
    nan = (b & U64(0x7FFFFFFF)) > U64(0x7F800000)
    return np.where(nan, U64(0x7FC0), rounded).astype(np.uint16)


def all_codes(n: int):
    """Every code of an n-bit format in its storage dtype; n <= 8 as every
    uint8, so the bits above n (ignored by both decoders) vary too."""
    if n == 16:
        return np.arange(-(1 << 15), 1 << 15).astype(np.int16)
    return np.arange(256, dtype=np.uint8)


def _assert_bits(got, want):
    """Same bit patterns, NaN exactly where the other has NaN (uint32 f32
    bits or uint16 bf16 bits)."""
    exp_mask, frac_mask = ((0x7F800000, 0x7FFFFF) if got.dtype == np.uint32
                           else (0x7F80, 0x7F))

    def nan(a):
        return ((a & exp_mask) == exp_mask) & ((a & frac_mask) != 0)
    np.testing.assert_array_equal(nan(got), nan(want))
    keep = ~nan(want)
    np.testing.assert_array_equal(got[keep], want[keep])


def _bits(a):
    """float32 / bfloat16 (numpy, JAX or torch) -> their bit patterns."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int32 if a.dtype == torch.float32
                   else torch.int16).numpy()
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype.itemsize == 4 else np.uint16)


@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", FORMATS)
def test_model_matches_port_and_reference(name, out):
    ft, fj = tformats.get(name), jformats.get(name)
    codes = all_codes(ft.bits)
    got = decode_model(codes, ft.bits, ft.es, ft.bias)
    if out == "bfloat16":
        got = bf16_rn(got)
    port = decode_tile(torch.from_numpy(codes), ft, getattr(torch, out))
    _assert_bits(got, _bits(port))
    ref = jdec.decode_tile(jnp.asarray(codes), fj, getattr(jnp, out))
    _assert_bits(got, _bits(np.asarray(ref)))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_1", "posit4_1"])
@pytest.mark.parametrize("bias", [-5, 3])
def test_model_with_a_format_bias(name, bias):
    """The exponent bias shifts every total exponent; K7 and the KV kernels
    pass it at run time."""
    ft = dataclasses.replace(tformats.get(name), bias=bias)
    fj = dataclasses.replace(jformats.get(name), bias=bias)
    codes = all_codes(ft.bits)
    got = decode_model(codes, ft.bits, ft.es, bias)
    _assert_bits(got, _bits(decode_tile(torch.from_numpy(codes), ft)))
    _assert_bits(got, _bits(np.asarray(jdec.decode_tile(jnp.asarray(codes),
                                                        fj))))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2"])
def test_model_special_and_extreme_codes(name):
    """0 -> +0 (bits 0), NaR -> the quiet NaN 0x7FC00000, +-1, maxpos and
    minpos of both signs (posit(n, es) spans useed^(n-2), useed =
    2^(2^es))."""
    ft = tformats.get(name)
    n, es = ft.bits, ft.es
    top = (n - 2) << es                          # log2 of maxpos
    one, maxpos = 1 << (n - 2), (1 << (n - 1)) - 1
    codes = np.asarray([0, 1 << (n - 1), one, (1 << n) - one, maxpos, 1,
                        (1 << n) - 1], np.int64)
    want = np.asarray([0.0, np.nan, 1.0, -1.0, 2.0 ** top, 2.0 ** -top,
                       -(2.0 ** -top)], np.float32).view(np.uint32).copy()
    want[1] = QNAN
    np.testing.assert_array_equal(decode_model(codes, n, es), want)


@pytest.mark.parametrize("name", FORMATS)
def test_regime_run_needs_no_clamp(name):
    """The count of leading zeros is at most n - 1 for every code but 0
    and NaR (their body is 0: 32 leading zeros, and the select at the end
    discards what follows), so the decoder clamps nothing; and the shift
    by r + 1 reaches 32 or more only there."""
    ft = tformats.get(name)
    codes = all_codes(ft.bits)
    _, _, body, r = _run_and_body(codes, ft.bits)
    u = np.asarray(codes).astype(np.int64) & ((1 << ft.bits) - 1)
    special = (u == 0) | (u == 1 << (ft.bits - 1))
    np.testing.assert_array_equal(body == 0, special)
    assert (r[~special] <= ft.bits - 1).all()
    assert (r[special] == 32).all()


@pytest.mark.cuda
def test_kernel_on_every_code():
    """K1 on every code of every built format against the plain version
    on the card, to float32 and bfloat16, followed by 2^18 + 37 random
    codes (many CTAs, every load slot of a thread), as a whole array and
    as views that start 1, 3 and 15 codes past a 16-byte boundary with
    lengths that are not a multiple of 16 (the kernel's scalar head and
    tail, and the value-by-value store).  One launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.posit_decode import posit_decode
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for name in FORMATS:
        ft = tformats.get(name)
        every = torch.from_numpy(all_codes(ft.bits))
        n_extra = (1 << 18) + 37
        extra = torch.randint(0, 1 << 16, (n_extra,), generator=gen).to(
            torch.int16) if ft.bits == 16 else torch.randint(
                0, 256, (n_extra,), generator=gen).to(torch.uint8)
        c = torch.cat([every, extra]).to(dev)
        for cin in (c, c[1:], c[3:-2], c[15:]):
            for out in (torch.float32, torch.bfloat16):
                before = LAUNCHES["posit_decode"]
                got = posit_decode(cin, ft, out_dtype=out)
                assert LAUNCHES["posit_decode"] == before + 1
                want = decode_tile(cin, ft, out)
                _assert_bits(_bits(got.cpu()), _bits(want.cpu()))
