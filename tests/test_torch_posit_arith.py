"""The port's exact posit arithmetic (``repro_torch.core.posit``'s compute
mode) and its oracle (``repro_torch.core.posit_ref``) vs the JAX package.

* ``mul`` / ``add`` / ``sub`` over every pair of P(8,0), P(8,1) and
  P(8,2): bit-exact to ``repro.core.posit`` and to the port's oracle; 2^16
  seeded pairs of P(16,1) and P(16,2) bit-exact to the reference.
* ``thermometer_decode`` (V, r, K) on every 8- and 16-bit code and
  ``regime_lut`` equal to the reference's; the count of leading zeros
  ``add`` normalises with held on every value below 2^20.
* ``dot_exact`` / ``matmul_exact`` at (4, 33) x (33, 5) bit-exact (and one
  entry against the oracle's sequential chain); ``fma_f32`` within 0 ulp;
  ``quant.quantization_mse`` within 1e-6 relative.

The oracle's all-pairs tables come from its own decode (``to_fraction``)
and encode (``encode_fraction``), memoised by the exact result value (one
memo per oracle and format, which ``add`` and ``sub`` share: they meet the
same values), which is how its ``add``/``mul``/``sub`` are defined; a
seeded sample of pairs holds the tables to those functions themselves.
The reference's ``mul``/``add``/``sub``/``fma_f32`` run eagerly: their
primitives compile once and serve every format.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import formats as jformats  # noqa: E402
from repro.core import posit as jposit  # noqa: E402
from repro.core import posit_ref as j_ref  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import posit as tposit  # noqa: E402
from repro_torch.core import posit_ref  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402

P8 = ["posit8_0", "posit8_1", "posit8_2"]
OPS = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
       "sub": lambda x, y: x - y}
A8 = np.repeat(np.arange(256), 256).astype(np.uint8)
B8 = np.tile(np.arange(256), 256).astype(np.uint8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Elementwise int64 work on 2^16 codes: torch's thread pool costs
    more than it gives under a loaded pytest worker (100x here)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref(op):
    """The reference's ``op``, eager: each primitive compiles once for
    every format (a jit per format and op compiled ~30 % longer)."""
    return getattr(jposit, op)


def _to_torch(codes, fmt):
    """Reference codes (numpy, uint8/uint16) -> the port's storage."""
    return torch.from_numpy(codes.view(np.int16) if fmt.bits == 16
                            else codes.copy())


def _to_np(codes, fmt):
    out = codes.numpy()
    return out.view(np.uint16) if fmt.bits == 16 else out


@functools.cache
def _encode_memo(ref, n, es):
    """exact value -> the oracle's code, shared by its tables."""
    return {}


@functools.cache
def _oracle(ref, op, n, es):
    """The oracle ``ref`` (the port's or the reference's posit_ref) on
    every pair of P(n, es), as a (2^n * 2^n,) table in A8/B8 order."""
    vals = [ref.to_fraction(c, n, es) for c in range(1 << n)]
    memo = _encode_memo(ref, n, es)
    out = np.empty(1 << (2 * n), np.int64)
    i = 0
    for x in vals:
        for y in vals:
            v = None if x is None or y is None else OPS[op](x, y)
            if v not in memo:
                memo[v] = ref.encode_fraction(v, n, es)
            out[i] = memo[v]
            i += 1
    return out


@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("name", P8)
def test_p8_exhaustive_equals_reference_and_oracle(name, op):
    jf, tf = jformats.get(name), tformats.get(name)
    want = np.asarray(_ref(op)(A8, B8, jf))
    got = _to_np(getattr(tposit, op)(torch.from_numpy(A8),
                                     torch.from_numpy(B8), tf), tf)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    table = _oracle(posit_ref, op, 8, tf.es)
    np.testing.assert_array_equal(got.astype(np.int64), table)
    # the memoised table is the oracle's own op on a sample of pairs
    idx = np.random.default_rng(7).integers(0, 1 << 16, 512)
    fn = getattr(posit_ref, op)
    assert [fn(int(A8[i]), int(B8[i]), 8, tf.es) for i in idx] == \
        table[idx].tolist()


@pytest.mark.parametrize("name", ["posit16_1", "posit16_2"])
def test_p16_sampled_pairs_equal_reference(name):
    jf, tf = jformats.get(name), tformats.get(name)
    rng = np.random.default_rng(16 + tf.es)
    a = rng.integers(0, 1 << 16, 1 << 16).astype(np.uint16)
    b = rng.integers(0, 1 << 16, 1 << 16).astype(np.uint16)
    b[:64], a[64:128] = 0, 0x8000           # zeros and NaR on both sides
    for op in sorted(OPS):
        want = np.asarray(_ref(op)(a, b, jf))
        got = getattr(tposit, op)(_to_torch(a, tf), _to_torch(b, tf), tf)
        assert got.dtype == torch.int16
        np.testing.assert_array_equal(_to_np(got, tf), want, err_msg=op)


@pytest.mark.parametrize("op", ["add", "mul"])
def test_oracle_equals_reference_oracle_p82(op):
    """The port's copy of the oracle against the reference's on every
    P(8,2) pair, and on a sample through both packages' own ops."""
    np.testing.assert_array_equal(_oracle(posit_ref, op, 8, 2),
                                  _oracle(j_ref, op, 8, 2))
    idx = np.random.default_rng(3).integers(0, 1 << 16, 256)
    for i in idx:
        a, b = int(A8[i]), int(B8[i])
        assert getattr(posit_ref, op)(a, b, 8, 2) == \
            getattr(j_ref, op)(a, b, 8, 2)


@pytest.mark.parametrize("bits", [8, 16])
def test_thermometer_decode_equals_reference(bits):
    jf = jformats.get(f"posit{bits}_2")
    tf = tformats.get(f"posit{bits}_2")
    codes = np.arange(1 << bits).astype(jf.np_storage_dtype)
    jv, jr, jk = (np.asarray(t) for t in jax.jit(
        jposit.thermometer_decode, static_argnums=1)(codes, jf))
    tv, tr, tk = tposit.thermometer_decode(_to_torch(codes, tf), tf)
    assert tv.shape == (1 << bits, bits - 1)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tr.numpy(), jr)
    np.testing.assert_array_equal(tk.numpy(), jk)
    # the LUT indexed by the popcount gives K on the lead=1 plane
    lut = tposit.regime_lut(tf)
    np.testing.assert_array_equal(lut.numpy(), jposit.regime_lut(jf))
    lead = (codes.astype(np.int64) >> (bits - 2)) & 1
    np.testing.assert_array_equal(lut[tr].numpy()[lead == 1],
                                  tk.numpy()[lead == 1])
    # Algorithm 1's compares give the run that _regime_run counts
    body = codes.astype(np.int64) & ((1 << (bits - 1)) - 1)
    t_val = np.where(lead == 1, body, ~body & ((1 << (bits - 1)) - 1))
    np.testing.assert_array_equal(
        tposit._regime_run(torch.from_numpy(t_val), bits).numpy(), tr)


def test_bit_length_exhaustive_below_2_20():
    """``add``'s leading-zero count (torch has no clz) on every value it
    can meet, and past it."""
    x = np.arange(1 << 20)
    want = np.array([int(v).bit_length() for v in x.tolist()])
    np.testing.assert_array_equal(
        tposit._bit_length(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("name", ["posit8_2", "posit16_1"])
def test_dot_and_matmul_exact_equal_reference(name):
    jf, tf = jformats.get(name), tformats.get(name)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 1 << tf.bits, (4, 33)).astype(jf.np_storage_dtype)
    b = rng.integers(0, 1 << tf.bits, (33, 5)).astype(jf.np_storage_dtype)
    a[0, 3] = 1 << (tf.bits - 1)            # a NaR poisons row 0
    want = np.asarray(jax.jit(jposit.matmul_exact, static_argnums=2)(
        a, b, jf))
    got = tposit.matmul_exact(_to_torch(a, tf), _to_torch(b, tf), tf)
    np.testing.assert_array_equal(_to_np(got, tf), want)
    # dot_exact of rows 1, 2 with columns 0, 1: the reference's matmul_exact
    # is its dot_exact over every (row, column) pair
    got_dot = tposit.dot_exact(_to_torch(a[1:3], tf),
                               _to_torch(np.ascontiguousarray(b.T[:2]), tf),
                               tf)
    np.testing.assert_array_equal(_to_np(got_dot, tf),
                                  want[[1, 2], [0, 1]])
    # the oracle's sequential chain, rounded at every step, from code 0
    acc = 0
    for k in range(33):
        acc = posit_ref.add(acc, posit_ref.mul(int(a[2, k]), int(b[k, 4]),
                                               tf.bits, tf.es),
                            tf.bits, tf.es)
    assert int(_to_np(got, tf)[2, 4]) == acc


def test_exact_arithmetic_refuses_n_above_16():
    p32 = tformats.get("posit32_2")
    x = torch.zeros(3, dtype=torch.int32)
    for fn in (tposit.mul, tposit.add, tposit.sub):
        with pytest.raises(NotImplementedError, match="n<=16"):
            fn(x, x, p32)
    with pytest.raises(NotImplementedError, match="n<=16"):
        tposit.dot_exact(x[None], x[None], p32)


def test_fma_f32_zero_ulp():
    jf, tf = jformats.get("posit8_2"), tformats.get("posit8_2")
    rng = np.random.default_rng(9)
    acc = rng.normal(0, 4, 1 << 16).astype(np.float32)
    want = np.asarray(_ref("fma_f32")(acc, A8, B8, jf))
    got = tposit.fma_f32(torch.from_numpy(acc), torch.from_numpy(A8),
                         torch.from_numpy(B8), tf).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("fmt", ["posit8_2", "int8", "fp8_e4m3"])
def test_quantization_mse_equals_reference(fmt, axis):
    """Weight-like magnitudes (the reference's ``exp2`` is exact there;
    ROADMAP fault 4); the mean's reduction order differs."""
    x = np.random.default_rng(11).normal(0, 0.05, (64, 96)).astype(
        np.float32)
    want = float(jax.jit(jquant.quantization_mse, static_argnums=(1, 2))(
        x, fmt, axis))
    got = tquant.quantization_mse(torch.from_numpy(x), fmt, axis=axis)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert float(got) == pytest.approx(want, rel=1e-6)
    assert want > 0
