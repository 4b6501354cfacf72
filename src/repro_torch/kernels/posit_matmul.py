"""K7: activations x posit-coded weights matmul, CUDA kernels + plain
version (port of ``repro.kernels.posit_matmul``).

``posit_matmul`` computes ``(x @ decode(W)) * scale`` with an f32
accumulator: x (M, K) float32 or bfloat16, W (K, N) posit codes (uint8, or
int16 holding the posit16 bits), scale None, a scalar or per output column.
A CUDA tensor launches one of two paths of ``csrc/posit_matmul.cu``:

* tensor-core (M above ``SKINNY_MAX_M``, TMA-aligned shapes): the f32
  product as an exact sum of bf16 x bf16 products on ``wgmma`` (x f32 in 3
  bf16 pieces, posit16 weights in 2, n <= 8 weights in 1), W decoded once
  per CTA in shared memory;
* split-K (small M, and every shape the tensor-core path cannot take):
  f32 FFMA over K splits into a ``(splits, M, N)`` workspace, summed in a
  fixed order by a second kernel.

A CPU tensor takes the plain ``posit_matmul_plain``.  NaR weights decode to
NaN and poison their column, as in the reference.
"""
from __future__ import annotations

import torch

from ..core.formats import PositFormat
from ..launch.op_cost import custom_call
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


# Largest M that takes the split-K path: above it the tensor-core path is
# faster (times by M in PERF.md, measured with chip_smoke.py's phase 9b).
SKINNY_MAX_M = 48
_SMS = 132                      # H100 SXM streaming multiprocessors
_PATHS = ("tensor_core", "split_k")


def tensor_core_ok(x, w_codes) -> bool:
    """Whether TMA can load x and W: 16-byte-aligned bases and row strides
    (K % 4 for f32 x, K % 8 for bf16 x; N % 16 for 8-bit codes, N % 8 for
    16-bit codes) and K >= 1."""
    k, n = w_codes.shape
    kx = 4 if x.dtype == torch.float32 else 8
    nw = 16 // w_codes.element_size()
    return (k >= 1 and k % kx == 0 and n % nw == 0
            and x.data_ptr() % 16 == 0 and w_codes.data_ptr() % 16 == 0)


def split_k_rows(code_bytes: int) -> int:
    """Rows of x per thread of the split-K path: 64 f32 sums over 16 bytes
    of codes (16 posit8 or 8 posit16 columns)."""
    return 64 // (16 // code_bytes)


def split_k_splits(m: int, k: int, n: int, code_bytes: int) -> int:
    """K splits of the split-K path: enough CTAs for four per SM, at least
    16 rows of K per split and at most 1024 (the x chunk in shared memory),
    and no empty split."""
    cols = 128 * (16 // code_bytes)              # columns per CTA
    ctas = max(1, -(-n // cols) * -(-m // split_k_rows(code_bytes)))
    splits = max(1, min(-(-4 * _SMS // ctas), k // 16), -(-k // 1024))
    if k:
        splits = -(-k // -(-k // splits))
    return splits


def posit_matmul(x: torch.Tensor, w_codes: torch.Tensor, fmt: PositFormat,
                 scale=None, *, compute_dtype=torch.float32,
                 path: str | None = None) -> torch.Tensor:
    """K7: x (M, K) float32/bfloat16 times decode(w_codes (K, N)), times
    ``scale`` (None | scalar | (N,) | (1, N)); returns (M, N) float32.

    ``path`` picks the CUDA path ("tensor_core" or "split_k"); None takes
    the tensor-core path for M > ``SKINNY_MAX_M`` when TMA can load the
    operands, else split-K.  The reference's ``blocks`` and ``interpret``
    arguments size tiles for TPU VMEM and select the Pallas interpreter;
    they have no counterpart here (the CUDA tiles are fixed, a CPU tensor
    takes the plain version)."""
    _check_shapes(x, w_codes)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"posit_matmul: compute_dtype {compute_dtype} "
                        "unsupported")
    if path not in (None,) + _PATHS:
        raise ValueError(f"posit_matmul: path must be one of {_PATHS}")
    if not x.is_cuda:
        return custom_call(posit_matmul_plain, x, w_codes, fmt, scale,
                           compute_dtype=compute_dtype,
                           reads=[x, w_codes, scale])
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
    aligned = tensor_core_ok(x, w_codes)
    if path is None:
        path = "tensor_core" if m > SKINNY_MAX_M and aligned else "split_k"
    if path == "tensor_core" and not aligned:
        raise ValueError("posit_matmul: the tensor-core path needs 16-byte "
                         "aligned operands and rows (K % 4 for f32 x, "
                         "K % 8 for bf16 x, N % 16 for 8-bit codes, N % 8 "
                         "for 16-bit codes)")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    splits = 0
    work = out
    if path == "split_k":
        rows = split_k_rows(w_codes.element_size())
        if -(-m // rows) > 65535:
            raise ValueError("posit_matmul: the split-K path takes M up to "
                             f"{65535 * rows}")
        splits = split_k_splits(m, k, n, w_codes.element_size())
        if splits > 1:
            work = torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device)
    elif -(-m // 128) > 65535:
        raise ValueError("posit_matmul: M above 65535 * 128")
    _build.check_cuda("posit_matmul", x, w_codes, srow, out, work)
    if m and n:
        _build.launch("posit_matmul", "posit_matmul", x.device,
                      x.data_ptr(), w_codes.data_ptr(), srow.data_ptr(),
                      out.data_ptr(), work.data_ptr(), m, k, n, fmt.bits,
                      fmt.es, fmt.bias, int(x.dtype == torch.bfloat16),
                      int(compute_dtype == torch.bfloat16), splits)
    return out
