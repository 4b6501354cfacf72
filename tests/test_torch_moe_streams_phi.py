"""MoE serving through the port against the reference, split from
``tests/test_torch_moe_serve.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles: the
phi3.5-moe smoke config's ``ServingEngine`` greedy streams
token-identical at float32 (ring; 5 prompts of 3-14 tokens over 2
slots, the engine stats equal)."""
import pytest

pytest.importorskip("torch")

from test_torch_moe_serve import ARCH, check_streams, pair  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("arch,layout", [("phi3.5-moe-42b-a6.6b", "ring")])
def test_engine_streams_token_identical(arch, layout, pair):
    check_streams(arch, layout, pair)
