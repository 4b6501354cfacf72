"""Plain-torch oracles for the codec and matmul kernels (port of
``repro.kernels.ref``).

These call the ``core.posit`` codec, which normalises float32 subnormals;
the kernels' own plain versions (``decode_tile`` / ``encode_tile``) sit
beside each kernel.
"""
from __future__ import annotations

import torch

from ..core import posit
from ..core.formats import PositFormat


def posit_decode_ref(codes, fmt: PositFormat, out_dtype=torch.float32):
    """Oracle for K1: bit-exact posit -> float."""
    return posit.decode_to_f32(codes, fmt).to(out_dtype)


def posit_encode_ref(x, fmt: PositFormat):
    """Oracle for K2 on normal floats: bit-exact RNE float -> posit."""
    return posit.encode_f32(x, fmt)


def posit_matmul_ref(x, w_codes, fmt: PositFormat, scale=None,
                     out_dtype=torch.float32):
    """Oracle for K7: decode weights (NaR -> NaN), f32 matmul, scale."""
    w = posit.decode_to_f32(w_codes, fmt)
    out = torch.matmul(x.to(torch.float32), w)
    if scale is not None:
        out = out * torch.as_tensor(scale, dtype=torch.float32,
                                    device=out.device)
    return out.to(out_dtype)
