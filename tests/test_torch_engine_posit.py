"""ServingEngine of the PyTorch port vs the JAX package's: greedy streams
token-identical at float32 on paper-edge smoke, ring layout, posit8 and
posit4 KV, under the paper_edge_p8 weight policy; split from
``tests/test_torch_engine.py`` (its helpers) so that the driver's
``--dist loadfile`` spreads the reference's compiles."""
import pytest

pytest.importorskip("torch")

from test_torch_engine import check_streams, model  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("kv_format", ["posit8", "posit4"])
def test_greedy_streams_token_identical(model, kv_format):  # noqa: F811
    check_streams(model, kv_format)
