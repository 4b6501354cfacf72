"""K2: float -> posit encode (quantize-on-store), CUDA kernel + plain
version.

Bit-exact RNE assembly (guard/sticky on the regime/exponent/fraction
concatenation), saturating to maxpos/minpos; NaN/inf -> NaR.  By default
float32 subnormals (|x| < 2^-126) are flushed to zero, as in the reference
kernel (plain version ``encode_tile``).  ``subnormals="normalize"`` is the
gradient wire's mode (``optim/compression.py``): it computes
``core.posit.encode_f32`` bit for bit, which is its plain version.  A
posit has no underflow, so there every nonzero subnormal encodes to
+-minpos, as long as the format's bias leaves the largest subnormal's
regime saturated; the wrapper refuses a bias that does not.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..core.posit import _encode_parts, encode_f32, f32_fields
from ..launch.op_cost import custom_call
from . import _build

SUBNORMALS = ("flush", "normalize")


def encode_tile(x, fmt: PositFormat):
    """Plain version of K2: encode float32 to posit codes, subnormals
    flushed.  Returns the format's storage dtype."""
    _, s, exp_raw, frac, is_zero, is_nar = f32_fields(x)
    is_zero = is_zero | (exp_raw == 0)          # flush subnormals
    return _encode_parts(s, exp_raw - 127, frac, 23, False, is_zero, is_nar,
                         fmt)


def subnormals_saturate(fmt: PositFormat) -> bool:
    """True when every float32 subnormal lies below minpos * 2^bias by a
    whole regime: the largest (2^-127 <= |x| < 2^-126) has the regime
    k = (-127 - bias) >> es <= -(n - 1), so RNE gives +-minpos."""
    return (-127 - fmt.bias) >> fmt.es <= -(fmt.bits - 1)


def posit_encode(x: torch.Tensor, fmt: PositFormat,
                 subnormals: str = "flush") -> torch.Tensor:
    """K2: float (any shape) -> codes (uint8, or int16 for posit16).
    ``subnormals``: "flush" (to 0, plain version ``encode_tile``) or
    "normalize" (plain version ``core.posit.encode_f32``)."""
    if subnormals not in SUBNORMALS:
        raise ValueError(f"posit_encode: subnormals={subnormals!r}, "
                         f"expected one of {SUBNORMALS}")
    normalize = subnormals == "normalize"
    if normalize and not subnormals_saturate(fmt):
        raise ValueError(
            f"posit_encode: at bias {fmt.bias} a float32 subnormal is "
            f"representable in {fmt.name}; the normalising mode encodes "
            "every subnormal to +-minpos and refuses such a bias")
    if not x.is_cuda:
        return custom_call(encode_f32 if normalize else encode_tile, x, fmt,
                           reads=[x])
    _build.check_fmt("posit_encode", fmt)
    if x.numel() >= 2 ** 31:
        raise ValueError("posit_encode: more than 2**31 - 1 values")
    x = x.to(torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=_build.code_dtype(fmt), device=x.device)
    _build.check_cuda("posit_encode", x, out)
    if x.numel():
        _build.launch("posit_codec", "posit_encode", x.device,
                      x.data_ptr(), out.data_ptr(), x.numel(), fmt.bits,
                      fmt.es, fmt.bias, int(normalize))
    return out
