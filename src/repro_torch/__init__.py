"""PyTorch + CUDA port of the transprecision posit serving stack.

Beside the JAX package ``repro`` (the reference), this package imports
``torch`` only.  Entry points take ``device`` (default ``"cuda"``); a CUDA
device on a machine without one raises instead of running on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and no GPU is
    available (there is no silent CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: device 'cuda' requested but no CUDA "
                           "GPU is available; pass device='cpu' explicitly")
    return device
