"""K2: float -> posit encode (quantize-on-store), CUDA kernel + plain
version.

Bit-exact RNE assembly (guard/sticky on the regime/exponent/fraction
concatenation), saturating to maxpos/minpos; NaN/inf -> NaR.  float32
subnormals (|x| < 2^-126) are flushed to zero, as in the reference kernel;
``core.posit.encode_f32`` normalises them instead.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..core.posit import _encode_parts, f32_fields
from . import _build


def encode_tile(x, fmt: PositFormat):
    """Plain version of K2: encode float32 to posit codes, subnormals
    flushed.  Returns the format's storage dtype."""
    _, s, exp_raw, frac, is_zero, is_nar = f32_fields(x)
    is_zero = is_zero | (exp_raw == 0)          # flush subnormals
    return _encode_parts(s, exp_raw - 127, frac, 23, False, is_zero, is_nar,
                         fmt)


def posit_encode(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    """K2: float (any shape) -> codes (uint8, or int16 for posit16)."""
    if not x.is_cuda:
        return encode_tile(x, fmt)
    _build.check_fmt("posit_encode", fmt)
    if x.numel() >= 2 ** 31:
        raise ValueError("posit_encode: more than 2**31 - 1 values")
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=_build.code_dtype(fmt), device=x.device)
    _build.check_cuda("posit_encode", x, out)
    if x.numel():
        _build.launch("posit_codec", "posit_encode", x.device,
                      x.data_ptr(), out.data_ptr(), x.numel(), fmt.bits,
                      fmt.es, fmt.bias)
    return out
