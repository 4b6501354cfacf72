"""K7 posit_matmul of the PyTorch port vs the JAX package.

The port's plain path (CPU tensors), ``qt_matmul``, ``qt_decode`` and
``quantize_2d`` against the reference's Pallas ``posit_matmul`` (and
codec kernels) in interpret mode, on the same seeded numpy inputs, within
rtol 2e-5 / atol 2e-4 (the reference's own tolerance: f32 accumulation
order) on weights encoded from N(0, 1).  The scale contract raises
``ValueError`` before any launch.  ``test_kernel_matches_plain_on_card``
needs the GPU (marker ``cuda``) and holds the CUDA kernel to the plain
version there; the machine with the GPU has no JAX, so the JAX imports are
optional and the parity tests skip without them.  The format x shape x
dtype grid, the padding edges and the random-shape property test are in
``test_torch_posit_matmul_{grid,shapes}.py``, on this file's helpers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ops import (posit_matmul, qt_decode,  # noqa: E402
                                     qt_matmul, quantize_2d)
from repro_torch.kernels.posit_matmul import posit_matmul_plain  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.core import posit as jposit
    from repro.core import quant as jquant
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None

RTOL, ATOL = 2e-5, 2e-4
FMTS = ["posit8_0", "posit8_2", "posit16_2"]


@pytest.fixture
def jax_ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _t(a):
    """numpy -> torch; uint16 codes keep their bits as int16."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _x(rng, m, k, xdtype):
    """x in JAX and torch: bf16 rounds once (in JAX), torch gets its bits."""
    jx = jnp.asarray(rng.normal(0, 1, (m, k)).astype(np.float32), xdtype)
    tx = torch.from_numpy(np.array(jx, np.float32))
    return jx, tx.to(torch.bfloat16) if xdtype == jnp.bfloat16 else tx


def _codes(rng, k, n, name):
    w = rng.normal(0, 1, (k, n)).astype(np.float32)
    return np.array(jposit.encode_f32(w, jformats.get(name)))


def _jmm(jx, codes, name, scale=None, **kw):
    return np.asarray(jops.posit_matmul(jx, codes, jformats.get(name), scale,
                                        blocks=(32, 32, 16), interpret=True,
                                        **kw))


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2"])
def test_compute_dtype_bf16_vs_jax(jax_ref, name):
    """compute_dtype=bfloat16 rounds both operands to bf16 before the
    f32-accumulated product, in both packages."""
    rng = np.random.default_rng(4)
    jx, tx = _x(rng, 40, 72, jnp.float32)
    codes = _codes(rng, 72, 24, name)
    got = posit_matmul(tx, _t(codes), tformats.get(name),
                       compute_dtype=torch.bfloat16)
    want = _jmm(jx, codes, name, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_qt_matmul_with_scale_vs_jax(jax_ref):
    """A (1, N) per-output-channel pow2 scale from ``quantize(axis=0)``."""
    rng = np.random.default_rng(3)
    jx, tx = _x(rng, 32, 64, jnp.float32)
    w = rng.normal(0, 0.02, (64, 24)).astype(np.float32)
    jq = jquant.quantize(jnp.asarray(w), jformats.POSIT8_2, axis=0)
    assert jq.scale.shape == (1, 24)
    tq = QuantizedTensor(_t(jq.data), _t(jq.scale), tformats.POSIT8_2)
    got = qt_matmul(tx, tq)
    want = np.asarray(jops.qt_matmul(jx, jq, blocks=(16, 16, 16),
                                     interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    full = tx.numpy() @ w       # the quantized product approximates f32
    rel = np.linalg.norm(got.numpy() - full) / np.linalg.norm(full)
    assert rel < 0.05, rel


def test_scale_contract_vs_jax(jax_ref):
    """Scalar, (1,), (1, 1), (N,) and (1, N) scales agree with the
    reference; (N, 1) and (N-1,) raise ValueError naming the scale."""
    rng = np.random.default_rng(8)
    m, k, n = 16, 32, 24
    jx, tx = _x(rng, m, k, jnp.float32)
    codes = _codes(rng, k, n, "posit8_2")
    fmt = tformats.POSIT8_2
    sv = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    for s in (np.float32(2.0), np.full((1,), 2.0, np.float32),
              np.full((1, 1), 2.0, np.float32), sv, sv.reshape(1, n)):
        got = posit_matmul(tx, _t(codes), fmt, torch.from_numpy(np.array(s)))
        want = _jmm(jx, codes, "posit8_2", jnp.asarray(s))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    for bad in (sv.reshape(n, 1), np.ones(n - 1, np.float32)):
        with pytest.raises(ValueError, match="scale"):
            posit_matmul(tx, _t(codes), fmt, torch.from_numpy(bad))
        with pytest.raises(ValueError, match="scale"):
            _jmm(jx, codes, "posit8_2", jnp.asarray(bad))


def test_nar_poisons_its_column(jax_ref):
    """A NaR weight decodes to NaN and makes its whole column NaN (no
    nan_to_num), in both packages and in the oracle; code 0 gives 0."""
    rng = np.random.default_rng(9)
    jx, tx = _x(rng, 12, 20, jnp.float32)
    codes = _codes(rng, 20, 10, "posit8_2")
    codes[5, 3] = 0x80                          # NaR
    codes[:, 7] = 0                             # zero column
    got = posit_matmul(tx, _t(codes), tformats.POSIT8_2).numpy()
    want = _jmm(jx, codes, "posit8_2")
    oracle = tref.posit_matmul_ref(tx, _t(codes), tformats.POSIT8_2).numpy()
    for out in (got, want, oracle):
        assert np.isnan(out[:, 3]).all()
        assert np.isfinite(np.delete(out, 3, axis=1)).all()
        assert (out[:, 7] == 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_matmul_ref_vs_jax_ref(jax_ref):
    rng = np.random.default_rng(10)
    jx, tx = _x(rng, 20, 30, jnp.float32)
    codes = _codes(rng, 30, 9, "posit16_2")
    scale = rng.uniform(0.5, 2.0, (9,)).astype(np.float32)
    got = tref.posit_matmul_ref(tx, _t(codes), tformats.POSIT16_2,
                                torch.from_numpy(scale))
    want = jref.posit_matmul_ref(jx, codes, jformats.POSIT16_2,
                                 jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", ["posit8_2", "posit16_2"])
def test_quantize_2d_and_qt_decode_vs_jax(jax_ref, name):
    """``quantize_2d`` codes bit-exact (K2's plain version, subnormals
    flushed); ``qt_decode`` of a scaled tensor equal, NaR -> NaN."""
    rng = np.random.default_rng(11)
    x = (rng.normal(0, 1, (24, 40)) * np.exp2(rng.uniform(-6, 6, (24, 1)))
         ).astype(np.float32)
    x[0, :4] = [0.0, 1e-40, np.inf, np.nan]
    jq = jops.quantize_2d(jnp.asarray(x), name, interpret=True)
    tq = quantize_2d(torch.from_numpy(x), name)
    assert tq.scale is None
    np.testing.assert_array_equal(_t(jq.data).numpy(), tq.data.numpy())
    scale = np.float32(0.25)
    jd = jops.qt_decode(jquant.QuantizedTensor(jq.data, jnp.asarray(scale),
                                               jformats.get(name)),
                        interpret=True)
    td = qt_decode(QuantizedTensor(tq.data, torch.tensor(scale),
                                   tformats.get(name)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert np.isnan(td.numpy()[0, 2:4]).all()


def test_posit_storage_and_format_errors():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="posit storage"):
        qt_matmul(x, QuantizedTensor(torch.zeros(8, 4, dtype=torch.int8),
                                     None, tformats.get("int8")))
    with pytest.raises(ValueError, match="n <= 16"):
        posit_matmul(x, torch.zeros(8, 4, dtype=torch.int32),
                     tformats.get("posit32_2"))
    with pytest.raises(ValueError, match="x \\(M, K\\)"):
        posit_matmul(x, torch.zeros(5, 4, dtype=torch.uint8),
                     tformats.POSIT8_2)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernels against their plain version on the card, TF32 off:
    formats, ragged shapes, f32/bf16 x, bf16 compute, every scale form,
    a NaR column, both paths (the wrapper's choice, split-K forced, and
    the tensor-core path forced where TMA can load the operands: M on
    both sides of the crossover, K short of a 64-step, K % 64 <= 32), and
    the scale errors raised before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import posit_matmul as pmm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    xo = pmm.SKINNY_MAX_M
    for name in ("posit8_0", "posit8_1", "posit8_2", "posit16_2"):
        fmt = tformats.get(name)
        for m, n, k in ((16, 16, 16), (100, 60, 130), (33, 17, 47),
                        (1, 200, 7), (8, 256, 64), (xo, 512, 136),
                        (xo + 1, 512, 136), (200, 64, 40), (300, 384, 200),
                        (4, 4096, 768)):
            w = torch.from_numpy(rng.normal(0, 1, (k, n)).astype(np.float32))
            codes = tref.posit.encode_f32(w, fmt).to(dev)
            codes[k // 2, n // 2] = 0x80 if fmt.bits == 8 else -0x8000
            x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(
                np.float32)).to(dev)
            sv = torch.from_numpy(rng.uniform(0.5, 2, n).astype(
                np.float32)).to(dev)
            for scale in (None, 2.0, sv, sv[None]):
                for xd, cd in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.float32),
                               (torch.float32, torch.bfloat16)):
                    paths = [None, "split_k"]
                    if pmm.tensor_core_ok(x.to(xd), codes):
                        paths.append("tensor_core")
                    for path in paths:
                        before = LAUNCHES["posit_matmul"]
                        got = posit_matmul(x.to(xd), codes, fmt, scale,
                                           compute_dtype=cd, path=path)
                        assert LAUNCHES["posit_matmul"] == before + 1
                        want = posit_matmul_plain(x.to(xd), codes, fmt,
                                                  scale, compute_dtype=cd)
                        torch.testing.assert_close(got, want, rtol=RTOL,
                                                   atol=ATOL, equal_nan=True)
                        assert torch.isnan(got[:, n // 2]).all()
            if not pmm.tensor_core_ok(x, codes):
                with pytest.raises(ValueError, match="tensor-core"):
                    posit_matmul(x, codes, fmt, path="tensor_core")
            before = LAUNCHES["posit_matmul"]
            for bad in (sv[:, None], sv[1:]):
                if bad.shape in ((1,), (1, 1)):
                    continue
                with pytest.raises(ValueError, match="scale"):
                    posit_matmul(x, codes, fmt, bad)
            assert LAUNCHES["posit_matmul"] == before
