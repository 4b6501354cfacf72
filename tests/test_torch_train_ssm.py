"""Two MIXED_TC train steps of the mamba2 smoke config in the port against
the reference's, under remat "dots" and the posit16 gradient wire:
``test_torch_train_families.py``'s checks and tolerances, one family a
file (the driver's ``--dist loadfile`` spreads the reference's compiles,
~30 s a family)."""
import pytest

pytest.importorskip("torch")

import test_torch_train_families as fam  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

HERE = ["ssm"]


@pytest.mark.parametrize("family", HERE)
def test_losses_equal_reference(family):
    fam.check_losses(family)


@pytest.mark.parametrize("family", HERE)
def test_params_and_master_equal_reference(family):
    fam.check_params_and_master(family)


@pytest.mark.parametrize("family", HERE)
def test_moments_equal_reference(family):
    fam.check_moments(family)


@pytest.mark.parametrize("family", HERE)
def test_wire_residual_equals_reference(family):
    fam.check_wire_residual(family)
