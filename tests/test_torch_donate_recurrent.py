"""The donated ``generate`` over the recurrent smoke stacks (mamba2, the
SSM family; recurrentgemma, the hybrid family) on the CPU, at float32
under ``paper_edge_p8`` with a posit8 KV format: a donating
``ServingEngine``'s greedy streams, whose recurrent leaves alternate
between the engine's two fixed sets, equal a non-donating one's and the
reference's ``ServingEngine``'s.  Every prompt has one length (a multiple
of mamba2's SSD chunk), so each reference engine compiles one
exact-length prefill."""
import pytest

pytest.importorskip("torch")

from test_torch_donate_families import check_streams  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def test_ssm_streams():
    check_streams("mamba2-2.7b", "ring", lens=(32, 32, 32))


def test_hybrid_streams():
    check_streams("recurrentgemma-9b", "ring")
