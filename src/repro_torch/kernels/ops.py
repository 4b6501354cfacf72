"""Public entry points over the kernels with ``QuantizedTensor`` plumbing
(port of ``repro.kernels.ops``), so model code stays format-agnostic.
Each call launches the CUDA kernel for CUDA tensors and takes the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from ..core.formats import PositFormat, get
from ..core.quant import QuantizedTensor
from .posit_decode import posit_decode
from .posit_encode import posit_encode
from .posit_matmul import posit_matmul

__all__ = ["posit_decode", "posit_encode", "posit_matmul", "qt_matmul",
           "qt_decode", "quantize_2d"]


def _posit_storage(name: str, w: QuantizedTensor) -> None:
    if not isinstance(w.fmt, PositFormat):
        raise TypeError(f"{name} expects posit storage, got {w.fmt.name}")


def qt_matmul(x, w: QuantizedTensor, **kw):
    """x @ dequant(w) through K7 (decode in shared memory, f32 FMA)."""
    _posit_storage("qt_matmul", w)
    return posit_matmul(x, w.data, w.fmt, scale=w.scale, **kw)


def qt_decode(w: QuantizedTensor, out_dtype=torch.float32):
    """decode(w.data) * w.scale through K1 (NaR -> NaN)."""
    _posit_storage("qt_decode", w)
    out = posit_decode(w.data, w.fmt, out_dtype=out_dtype)
    if w.scale is not None:
        out = out * w.scale
    return out


def quantize_2d(x, fmt_name: str) -> QuantizedTensor:
    """Kernel-path quantize through K2 (unscaled posit storage)."""
    fmt = get(fmt_name)
    if not isinstance(fmt, PositFormat):
        raise TypeError(f"quantize_2d expects a posit format, got {fmt_name}")
    return QuantizedTensor(posit_encode(x, fmt), None, fmt)
