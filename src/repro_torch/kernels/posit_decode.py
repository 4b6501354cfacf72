"""K1: posit -> float decode, CUDA kernel + plain version.

``posit_decode`` launches ``csrc/posit_codec.cu::posit_decode_kernel`` for
a CUDA tensor and takes the plain ``decode_tile`` for a CPU tensor.  The
plain version is Algorithm 1, as in the reference: the regime's run length
from n-1 parallel threshold compares, the IEEE-754 bits assembled with
integer ops.  The kernel's branch-free decoder (``posit::decode``) finds the
run with one count of leading zeros and gives the same bits on every code;
NaR -> NaN, 0 -> 0.  Bit-exact for n<=16.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..core.posit import decode_to_f32
from ..launch.op_cost import custom_call
from . import _build


def decode_tile(codes, fmt: PositFormat, out_dtype=torch.float32):
    """Plain version of K1: decode posit codes to float (any shape).
    posit16 codes are int16 holding the bit patterns."""
    if fmt.bits > 16:
        raise ValueError("decode_tile is bit-exact for n <= 16 only")
    return decode_to_f32(codes, fmt).to(out_dtype)


def posit_decode(codes: torch.Tensor, fmt: PositFormat, *,
                 out_dtype=torch.float32) -> torch.Tensor:
    """K1: codes (any shape; uint8, or int16 for posit16) -> float32 or
    bfloat16 of the same shape."""
    if not codes.is_cuda:
        return custom_call(decode_tile, codes, fmt, out_dtype,
                           reads=[codes])
    _build.check_fmt("posit_decode", fmt)
    if codes.dtype != _build.code_dtype(fmt):
        raise TypeError(f"posit_decode: {fmt.name} codes must be "
                        f"{_build.code_dtype(fmt)}, got {codes.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"posit_decode: out_dtype {out_dtype} unsupported")
    if codes.numel() >= 2 ** 31:
        raise ValueError("posit_decode: more than 2**31 - 1 codes")
    codes = codes.contiguous()
    out = torch.empty(codes.shape, dtype=out_dtype, device=codes.device)
    _build.check_cuda("posit_decode", codes, out)
    if codes.numel():
        _build.launch("posit_codec", "posit_decode", codes.device,
                      codes.data_ptr(), out.data_ptr(), codes.numel(),
                      fmt.bits, fmt.es, fmt.bias,
                      int(out_dtype == torch.bfloat16))
    return out
