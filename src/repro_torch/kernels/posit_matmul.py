"""K7: activations x posit-coded weights matmul, CUDA kernel + plain
version (port of ``repro.kernels.posit_matmul``).

``posit_matmul`` computes ``(x @ decode(W)) * scale`` with an f32
accumulator: x (M, K) float32 or bfloat16, W (K, N) posit codes (uint8, or
int16 holding the posit16 bits), scale None, a scalar or per output column.
A CUDA tensor launches ``csrc/posit_matmul.cu::posit_matmul_kernel``
(decode-in-shared-memory, f32 FMA); a CPU tensor takes the plain
``posit_matmul_plain``.  NaR weights decode to NaN and poison their
column, as in the reference.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from . import _build
from .posit_decode import decode_tile


def scale_row(scale, n: int, device) -> torch.Tensor:
    """The (N,) float32 column scale of ``scale``: None -> ones; a scalar,
    (1,) or (1, 1) broadcasts; (N,) or (1, N) is per output column.  Any
    other shape (an (N, 1) column, a wrong length) raises ``ValueError``:
    flattening it would mis-scale every column."""
    if scale is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    if s.ndim == 0 or tuple(s.shape) in ((1,), (1, 1)):
        return s.reshape(1).expand(n).contiguous()
    if tuple(s.shape) in ((n,), (1, n)):
        return s.reshape(n).contiguous()
    raise ValueError(
        f"posit_matmul scale must be a scalar or per-output-channel of "
        f"shape ({n},) / (1, {n}); got shape {tuple(s.shape)}")


def _check_shapes(x, w_codes):
    if x.ndim != 2 or w_codes.ndim != 2 or x.shape[1] != w_codes.shape[0]:
        raise ValueError(f"posit_matmul: x (M, K) and w_codes (K, N) "
                         f"expected, got {tuple(x.shape)} and "
                         f"{tuple(w_codes.shape)}")


def posit_matmul_plain(x, w_codes, fmt: PositFormat, scale=None, *,
                       compute_dtype=torch.float32):
    """Plain version of K7, the Pallas body's arithmetic: decode W to
    ``compute_dtype``, cast x to it, f32-accumulated product, times the
    column scale."""
    _check_shapes(x, w_codes)
    srow = scale_row(scale, w_codes.shape[1], x.device)
    w = decode_tile(w_codes, fmt, compute_dtype).to(torch.float32)
    xc = x.to(compute_dtype).to(torch.float32)
    return torch.matmul(xc, w) * srow


def posit_matmul(x: torch.Tensor, w_codes: torch.Tensor, fmt: PositFormat,
                 scale=None, *, compute_dtype=torch.float32) -> torch.Tensor:
    """K7: x (M, K) float32/bfloat16 times decode(w_codes (K, N)), times
    ``scale`` (None | scalar | (N,) | (1, N)); returns (M, N) float32.

    The reference's ``blocks`` and ``interpret`` arguments size tiles for
    TPU VMEM and select the Pallas interpreter; they have no counterpart
    here (the CUDA kernel's tile is fixed, a CPU tensor takes the plain
    version)."""
    _check_shapes(x, w_codes)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"posit_matmul: compute_dtype {compute_dtype} "
                        "unsupported")
    if not x.is_cuda:
        return posit_matmul_plain(x, w_codes, fmt, scale,
                                  compute_dtype=compute_dtype)
    srow = scale_row(scale, w_codes.shape[1], x.device)
    _build.check_fmt("posit_matmul", fmt)
    if w_codes.dtype != _build.code_dtype(fmt):
        raise TypeError(f"posit_matmul: {fmt.name} codes must be "
                        f"{_build.code_dtype(fmt)}, got {w_codes.dtype}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"posit_matmul: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    m, k = x.shape
    n = w_codes.shape[1]
    if max(m * k, k * n, m * n) >= 2 ** 31:
        raise ValueError("posit_matmul: an operand has 2**31 elements or "
                         "more")
    x, w_codes = x.contiguous(), w_codes.contiguous()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.check_cuda("posit_matmul", x, w_codes, srow, out)
    if m and n:
        _build.launch("posit_matmul", "posit_matmul", x.device,
                      x.data_ptr(), w_codes.data_ptr(), srow.data_ptr(),
                      out.data_ptr(), m, k, n, fmt.bits, fmt.es, fmt.bias,
                      int(x.dtype == torch.bfloat16),
                      int(compute_dtype == torch.bfloat16))
    return out
