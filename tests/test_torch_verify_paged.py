"""``verify_step`` of the PyTorch port against the JAX package's in the
paged layout (B = 2, T = 4, after a bucketed prefill and one decode
step, posit8 / posit16 / f32 KV, paper-edge smoke at float32 under
``paper_edge_p8`` weights), split from ``tests/test_torch_verify.py``
(its helpers and tolerances) so that the driver's ``--dist loadfile``
spreads the reference's compiles."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")      # the GPU machine has no JAX

from test_torch_verify import check_verify, pair  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("layout", ["paged"])
@pytest.mark.parametrize("kv_format", ["posit8", "posit16", "f32"])
def test_verify_step_matches_reference(pair, layout, kv_format):  # noqa: F811
    check_verify(pair, layout, kv_format)
