"""K7 posit_matmul of the PyTorch port vs the JAX package's Pallas
``posit_matmul`` in interpret mode on a grid of formats (posit8_0,
posit8_2, posit16_2), shapes and x dtypes, and at padding edges (shapes
off the block multiples), within rtol 2e-5 / atol 2e-4;
split from ``tests/test_torch_posit_matmul.py`` (its helpers and
tolerances) so that the driver's ``--dist loadfile`` spreads the
reference's interpret-mode runs.  Skips where the JAX package is not
installed (the GPU machine)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels.ops import posit_matmul  # noqa: E402
from test_torch_posit_matmul import (  # noqa: E402,F401
    ATOL, FMTS, RTOL, _codes, _jmm, _t, _x, jax_ref, jnp)
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("name", FMTS)
@pytest.mark.parametrize("mnk", [(16, 16, 16), (64, 48, 32), (100, 60, 130)],
                         ids=str)
@pytest.mark.parametrize("xdtype", ["float32", "bfloat16"])
def test_posit_matmul_vs_jax(jax_ref, name, mnk, xdtype):
    m, n, k = mnk
    rng = np.random.default_rng(2)
    jx, tx = _x(rng, m, k, getattr(jnp, xdtype))
    codes = _codes(rng, k, n, name)
    got = posit_matmul(tx, _t(codes), tformats.get(name))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), _jmm(jx, codes, name),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mnk", [(33, 17, 47), (65, 129, 31), (1, 200, 7)],
                         ids=str)
def test_padding_edges_vs_jax(jax_ref, mnk):
    """Ragged M/N/K with an (N,) scale."""
    m, n, k = mnk
    rng = np.random.default_rng(7)
    jx, tx = _x(rng, m, k, jnp.float32)
    codes = _codes(rng, k, n, "posit8_2")
    scale = rng.uniform(0.5, 2.0, (n,)).astype(np.float32)
    got = posit_matmul(tx, _t(codes), tformats.POSIT8_2, torch.from_numpy(
        scale))
    want = _jmm(jx, codes, "posit8_2", jnp.asarray(scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
