"""``SpeculativeEngine`` of the PyTorch port vs its baseline greedy and
the JAX package's at ``benchmarks/bench_speculative.py``'s shape in the
paged layout (float32, gamma 2 and 4): streams token-identical and every
count equal to the reference's; split from
``tests/test_torch_speculative.py`` (its helpers) so that the driver's
``--dist loadfile`` spreads the reference's compiles."""
import pytest

pytest.importorskip("torch")

from test_torch_speculative import check_bench_f32, pairs  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("layout", ["paged"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_bench_shape_f32_matches_reference(pairs, layout, gamma):  # noqa: F811
    check_bench_f32(pairs, layout, gamma)
