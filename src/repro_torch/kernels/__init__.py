"""Hand-written CUDA kernels for Hopper (``csrc/``) and their plain-torch
versions.  A wrapper launches its kernel for CUDA tensors and takes the
plain version for CPU tensors; launch counts are in ``LAUNCHES``."""
from ._build import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
