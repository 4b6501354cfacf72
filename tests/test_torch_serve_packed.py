"""Serving model of the PyTorch port vs the JAX package on paper-edge
smoke, split from ``tests/test_torch_serve.py`` (its helpers and
tolerances) so that the driver's ``--dist loadfile`` spreads the
reference's compiles: prefill and decode over posit-packed weights at
float32 (logits within rtol 1e-4, atol 1e-5; codes and scales as there),
and the port's bf16 against the reference's bf16 by a logit
tolerance."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_serve import (  # noqa: E402,F401
    _check_cache_f32, _f32, _run_both)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_prefill_decode_packed_weights_f32():
    """serve_posit8: pack_params QuantizedTensor leaves through the bridge,
    decoded on load in both packages."""
    for jl, tl, jcache, tcache in _run_both("float32", None, steps=1,
                                            policy="serve_posit8",
                                            pack=True):
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=1e-5)
        _check_cache_f32(jcache, tcache, "posit8")


def test_prefill_decode_bf16_matches_reference_bf16():
    """bf16 rounds at other places in the two frameworks: logits agree to
    within 0.1 absolute on a logit scale of ~1 (a few bf16 ulps)."""
    for jl, tl, _, _ in _run_both("bfloat16", "posit8"):
        assert tl.dtype == torch.bfloat16
        d = np.abs(_f32(tl) - _f32(jl))
        assert d.max() < 0.1, d.max()
        assert np.abs(_f32(jl)).max() > 0.5      # the scale the bound assumes
