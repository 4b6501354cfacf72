"""The arithmetic of K7's two CUDA paths, checked on the CPU.

The tensor-core path computes the f32 product ``x @ decode(W)`` as a sum of
bf16 x bf16 products: every finite posit of n <= 8 is exactly one bf16,
every finite posit16 the sum of two (w0 = RNE(w), w1 = w - w0), and an f32
x the sum of three (x0 = RNE(x), x1 = RNE(x - x0), x2 = x - x0 - x1), so
each product is exact in f32 and only the order of the f32 sums differs.
These tests pin those facts on every code and on f32 values across
2^-60..2^60, then hold a plain model of each path -- the split product,
promoted into an f32 sum every 64 of K as the kernel does, and the split-K
sum of ``split_k_splits`` chunks in split order -- to the port's
``posit_matmul_plain`` and to the reference's Pallas ``posit_matmul`` (in
interpret mode) within rtol 2e-5 / atol 2e-4, the reference's own
tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import posit as jposit  # noqa: E402
from repro.kernels import posit_matmul as jpm  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels.posit_decode import decode_tile  # noqa: E402
from repro_torch.kernels.posit_matmul import (  # noqa: E402
    posit_matmul_plain, scale_row, split_k_splits)
from test_torch_decoder import decode_model  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

RTOL, ATOL = 2e-5, 2e-4
FORMATS = ["posit4_1", "posit8_0", "posit8_1", "posit8_2", "posit16_0",
           "posit16_1", "posit16_2"]
KSTEP = 64                  # the tensor-core path's K step (promotion)
# (x dtype, compute dtype) as the kernels take them
DTYPES = [("float32", "float32"), ("bfloat16", "float32"),
          ("float32", "bfloat16")]


def bf16(t):
    """Round f32 to the nearest-even bf16, back in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def pieces(t, n):
    """The n bf16 pieces (each held in f32) of f32 ``t``: RNE of what the
    earlier pieces left."""
    out = []
    for _ in range(n):
        p = bf16(t)
        out.append(p)
        t = t - p
    return out


def all_codes(fmt):
    codes = torch.arange(1 << fmt.bits, dtype=torch.int64)
    if fmt.bits == 16:
        codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes)
        return codes.to(torch.int16)
    return codes.to(torch.uint8)


def w_pieces(fmt, compute_dtype):
    return 1 if fmt.bits <= 8 or compute_dtype == torch.bfloat16 else 2


def x_pieces(x, compute_dtype):
    return 1 if (x.dtype == torch.bfloat16
                 or compute_dtype == torch.bfloat16) else 3


def split_product_model(x, codes, fmt, scale, compute_dtype):
    """The tensor-core path: sum over 64-K steps, each the sum over its
    16-K slices of every (x piece, W piece) product in f32."""
    w = decode_tile(codes, fmt)
    xf = x.to(torch.float32)
    xs = pieces(xf, x_pieces(x, compute_dtype))
    ws = pieces(w, w_pieces(fmt, compute_dtype))
    m, k = xf.shape
    acc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
    for k0 in range(0, k, KSTEP):
        step = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + KSTEP, k), 16):
            sl = slice(k1, min(k1 + 16, k))
            for xp in xs:
                for wp in ws:
                    step += xp[:, sl] @ wp[sl]
        acc += step
    return acc * scale_row(scale, w.shape[1], "cpu")


def split_k_model(x, codes, fmt, scale, compute_dtype):
    """The split-K path: f32 partial products over ``split_k_splits``
    chunks of K (operands rounded to bf16 first at bf16 compute), summed
    in split order, times the scale."""
    m, k = x.shape
    n = codes.shape[1]
    w = decode_tile(codes, fmt)
    xf = x.to(torch.float32)
    if compute_dtype == torch.bfloat16:
        w, xf = bf16(w), bf16(xf)
    splits = split_k_splits(m, k, n, codes.element_size())
    chunk = -(-k // splits) if k else 0
    total = torch.zeros((m, n), dtype=torch.float32)
    for s in range(splits):
        sl = slice(s * chunk, min((s + 1) * chunk, k))
        total = total + xf[:, sl] @ w[sl]
    return total * scale_row(scale, n, "cpu")


@pytest.mark.parametrize("name", FORMATS)
def test_every_code_is_exact_in_its_bf16_pieces(name):
    """n <= 8: one bf16 holds every finite value; n = 16: two do, with
    the remainder itself a bf16.  NaR stays NaN in the first piece."""
    fmt = tformats.get(name)
    w = decode_tile(all_codes(fmt), fmt)
    finite = torch.isfinite(w)
    assert int((~finite).sum()) == 1          # NaR only
    w = w[finite]
    if fmt.bits <= 8:
        assert torch.equal(bf16(w), w)
    else:
        w0 = bf16(w)
        assert not torch.equal(w0, w)          # one piece is not enough
        w1 = w - w0
        assert torch.equal(bf16(w1), w1)
        assert torch.equal(w0.double() + w1.double(), w.double())
    nar = decode_tile(all_codes(fmt), fmt)[1 << (fmt.bits - 1)]
    assert torch.isnan(bf16(nar.reshape(1))).all()


@pytest.mark.parametrize("lo,hi", [(-60, -20), (-20, 20), (20, 60)],
                         ids=str)
def test_f32_is_exact_in_three_bf16_pieces(lo, hi):
    """Normal f32 of any mantissa over 2^lo..2^hi, both signs: the third
    piece is exactly a bf16 and the three sum to x exactly."""
    rng = np.random.default_rng([lo + 64, hi + 64])
    n = 1 << 16
    bits = ((rng.integers(0, 2, n).astype(np.uint32) << 31)
            | ((rng.integers(lo, hi + 1, n) + 127).astype(np.uint32) << 23)
            | rng.integers(0, 1 << 23, n).astype(np.uint32))
    x = torch.from_numpy(bits.view(np.float32))
    x0, x1, x2 = pieces(x, 3)
    assert torch.equal(bf16(x2), x2)
    assert torch.equal(x0.double() + x1.double() + x2.double(), x.double())
    # two pieces would not do: 16 bits of mantissa are not 24
    assert not torch.equal((x0 + x1).double(), x.double())


def _case(rng, m, n, k, name, xdtype):
    fmt_j, fmt_t = jformats.get(name), tformats.get(name)
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    codes = np.array(jposit.encode_f32(w, fmt_j))
    codes[k // 2, n // 2] = 1 << (fmt_t.bits - 1)            # NaR
    tcodes = torch.from_numpy(codes.view(np.int16) if codes.dtype == np.uint16
                              else codes)
    jx = jnp.asarray(rng.normal(0, 1, (m, k)).astype(np.float32),
                     getattr(jnp, xdtype))
    tx = torch.from_numpy(np.array(jx, np.float32)).to(getattr(torch,
                                                               xdtype))
    scale = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    return fmt_j, fmt_t, codes, tcodes, jx, tx, scale


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2", "posit4_1"])
@pytest.mark.parametrize("mnk", [(40, 48, 200), (33, 17, 47), (1, 200, 7)],
                         ids=str)
@pytest.mark.parametrize("xdtype,cdtype", DTYPES)
def test_path_models_vs_plain_and_jax(name, mnk, xdtype, cdtype):
    """Both paths' models against the port's plain version and the
    reference's Pallas kernel, NaR column NaN in all four."""
    m, n, k = mnk
    rng = np.random.default_rng(m * 31 + n + k)
    fmt_j, fmt_t, codes, tcodes, jx, tx, scale = _case(rng, m, n, k, name,
                                                       xdtype)
    cd = getattr(torch, cdtype)
    sc = torch.from_numpy(scale)
    plain = posit_matmul_plain(tx, tcodes, fmt_t, sc, compute_dtype=cd)
    jax_out = np.asarray(jpm.posit_matmul(
        jx, codes, fmt_j, jnp.asarray(scale), blocks=(32, 32, 16),
        compute_dtype=getattr(jnp, cdtype), interpret=True))
    for model in (split_product_model, split_k_model):
        got = model(tx, tcodes, fmt_t, sc, cd)
        assert torch.isnan(got[:, n // 2]).all()
        assert not torch.isnan(got[:, :n // 2]).any()
        for want in (plain.numpy(), jax_out):
            np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("m,k,n,bytes_,want", [
    (8, 768, 4096, 1, 48), (8, 768, 32000, 2, 17), (1, 7, 200, 1, 1),
    (64, 768, 4096, 1, 17), (8192, 100, 4095, 1, 1),
    (8192, 5000, 4096, 1, 5), (8, 0, 16, 1, 1), (0, 768, 16, 1, 48)],
    ids=str)
def test_split_k_splits(m, k, n, bytes_, want):
    """Four CTAs per SM where K allows (at least 16 of K per split), at
    most 1024 of K per split, and no split left empty."""
    s = split_k_splits(m, k, n, bytes_)
    assert s == want
    if k:
        chunk = -(-k // s)
        assert chunk <= 1024 and (s - 1) * chunk < k


@pytest.mark.parametrize("name", ["posit16_0", "posit16_1", "posit16_2"])
def test_posit16_clz_decode_is_bit_exact(name):
    """The tensor-core and split-K paths decode 16-bit codes with the
    codec's branch-free decoder in its run-time-es form
    (``posit::decode_es<16>`` in csrc/posit_codec.cuh, the regime's run
    length from the leading zeros of the left-aligned body), modelled step
    for step by ``test_torch_decoder.decode_model``: on every code, equal
    bits to ``decode_tile`` (Algorithm 1's threshold compares), NaN exactly
    at NaR."""
    fmt = tformats.get(name)
    codes = all_codes(fmt)
    want = decode_tile(codes, fmt).numpy()
    got = decode_model(codes.numpy(), 16, fmt.es, fmt.bias).view(np.float32)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(got[keep].view(np.uint32),
                                  want[keep].view(np.uint32))
