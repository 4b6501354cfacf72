"""K7 posit_matmul of the PyTorch port vs the JAX package's Pallas
``posit_matmul`` in interpret mode on random shapes: any (m, n, k) up to
80 and any es of posit8 (five hypothesis examples, each shape's own
seeded inputs) within rtol 2e-5 / atol 2e-4; split from
``tests/test_torch_posit_matmul.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's interpret-mode
runs.  Skips where the JAX package is not installed (the GPU
machine)."""
import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # offline CI: vendored deterministic fallback
    from _propcheck import given, settings, strategies as st

from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels.ops import posit_matmul  # noqa: E402
from test_torch_posit_matmul import (  # noqa: E402,F401
    _codes, _jmm, _t, _x, ATOL, jnp, RTOL)
from _torch_threads import torch_threads  # noqa: E402,F401


@settings(max_examples=5, deadline=None)
@given(st.integers(1, 80), st.integers(1, 80), st.integers(1, 80),
       st.sampled_from([0, 1, 2]))
def test_shape_property_vs_jax(m, n, k, es):
    """Any (m, n, k), any es of posit8: port == reference within the
    accumulation tolerance."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")
    name = f"posit8_{es}"
    rng = np.random.default_rng(m * 83 + n * 7 + k)
    jx, tx = _x(rng, m, k, jnp.float32)
    codes = _codes(rng, k, n, name)
    got = posit_matmul(tx, _t(codes), tformats.get(name))
    np.testing.assert_allclose(got.numpy(), _jmm(jx, codes, name),
                               rtol=RTOL, atol=ATOL)
