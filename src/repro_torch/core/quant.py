"""Quantize/dequantize across the TALU format family + QuantizedTensor
(port of ``repro.core.quant``).

* ``QuantizedTensor`` — packed codes + an optional runtime scale + the
  format descriptor.  Posit tensors carry a power-of-two scale so tapered
  precision is centred on the tensor's magnitude; int tensors carry an
  affine scale.
* ``quantize`` / ``dequantize`` — storage-format conversion.
* ``fake_quant`` — straight-through-estimator quantization
  (``torch.autograd.Function``).
* ``quantization_mse`` — the mean square error of a round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import posit
from .formats import FloatFormat, Format, IntFormat, PositFormat, get


@dataclasses.dataclass
class QuantizedTensor:
    """Packed low-precision tensor: ``value ~= decode(data) * scale``."""

    data: torch.Tensor
    scale: Optional[torch.Tensor]  # None, scalar, or broadcastable
    fmt: Format

    @property
    def shape(self):
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nbytes_packed(self) -> int:
        """Storage bytes at the format's bit width, scale included."""
        n = self.data.numel() * self.fmt.bits / 8
        if self.scale is not None:
            n += torch.as_tensor(self.scale).numel() * 4
        return int(n)

    def dequantize(self, dtype=torch.float32):
        return dequantize(self, dtype)

    def __getitem__(self, i) -> "QuantizedTensor":
        """Slice data and scale together along the leading (stack) axis."""
        return QuantizedTensor(self.data[i], None if self.scale is None
                               else self.scale[i], self.fmt)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.data.to(device), None if self.scale is None
                               else self.scale.to(device), self.fmt)


def _pow2_scale(x, axis):
    """Power-of-two scale: 2**round(log2(mean of the nonzero |x|))."""
    absx = x.abs()
    if axis is None:
        mean = absx.sum() / (absx > 0).sum()
    else:
        mean = (absx.sum(dim=axis, keepdim=True)
                / (absx > 0).sum(dim=axis, keepdim=True))
    mean = torch.maximum(mean, torch.tensor(1e-30, dtype=mean.dtype,
                                            device=mean.device))
    return torch.exp2(torch.round(torch.log2(mean)))


def quantize(x, fmt, axis=None, scaled: bool = True,
             encode=posit.encode_f32) -> QuantizedTensor:
    """Quantize a float tensor into packed storage codes.

    posit: optional power-of-two runtime scale (exact to apply/remove);
           ``encode(x, fmt)`` is the codec (the gradient wire passes K2's
           normalising mode, which computes ``encode_f32`` bit for bit).
    int:   symmetric per-tensor (axis=None) or per-channel absmax scale.
    float: native dtype cast (round to nearest even).
    """
    fmt = get(fmt)
    x = x.to(torch.float32)
    if isinstance(fmt, PositFormat):
        if scaled:
            s = _pow2_scale(x, axis)
            return QuantizedTensor(encode(x / s, fmt), s, fmt)
        return QuantizedTensor(encode(x, fmt), None, fmt)
    if isinstance(fmt, IntFormat):
        absx = x.abs()
        amax = (absx.amax() if axis is None
                else absx.amax(dim=axis, keepdim=True))
        s = amax.clamp(min=1e-30) / fmt.qmax
        q = torch.clamp(torch.round(x / s), fmt.qmin, fmt.qmax)
        return QuantizedTensor(q.to(fmt.storage_dtype), s, fmt)
    if isinstance(fmt, FloatFormat):
        return QuantizedTensor(x.to(fmt.torch_dtype), None, fmt)
    raise TypeError(fmt)


def dequantize(qt: QuantizedTensor, dtype=torch.float32,
               decode=posit.decode_to_f32):
    """``decode(codes, fmt)`` -> float32 is the posit codec (the gradient
    wire passes K1)."""
    fmt = qt.fmt
    if isinstance(fmt, PositFormat):
        v = torch.nan_to_num(decode(qt.data, fmt))  # NaR -> 0
    else:
        v = qt.data.to(torch.float32)
    if qt.scale is not None:
        v = v * qt.scale
    return v.to(dtype)


class _FakeQuant(torch.autograd.Function):
    """Forward rounds through the format; backward passes gradients
    unchanged (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x, fmt_name, axis):
        return dequantize(quantize(x, get(fmt_name), axis=axis), x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x, fmt_name: str, axis=None):
    """Straight-through quantization of ``x`` through ``fmt_name``."""
    return _FakeQuant.apply(x, fmt_name, axis)


def maybe_dequant(w, dtype=torch.bfloat16):
    """Pass-through for plain tensors; decode for QuantizedTensors."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w, dtype)
    return w


def quantization_mse(x, fmt, axis=None) -> torch.Tensor:
    """Mean squared quantization error of storing ``x`` in ``fmt`` (float32,
    on ``x``'s device)."""
    qt = quantize(x, get(fmt), axis=axis)
    return torch.mean((dequantize(qt) - x.to(torch.float32)) ** 2)
