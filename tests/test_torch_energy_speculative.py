"""Modeled energy per token of the speculative engine (gamma 2, ring
posit8, paper-edge smoke at float32) against ``repro.obs.energy``'s on
the same weights: the draft and verify stages priced, per-stage MACs
exactly equal, modeled bytes within 0.1 %, pJ per call and J/token
within rel 1e-3, equal calls; split from ``tests/test_torch_energy.py``
(its helpers and tolerances) so that the driver's ``--dist loadfile``
spreads the reference's compiles."""
import pytest

pytest.importorskip("torch")

from test_torch_energy import check_accountant, pair  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("case", ["speculative_ring"])
def test_accountant_matches_reference(pair, case):  # noqa: F811
    check_accountant(pair, case)
