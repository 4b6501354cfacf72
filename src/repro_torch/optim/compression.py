"""Gradient wire compression (port of ``repro.optim.compression``): the
paper's posit format as the data-parallel gradient's wire format.

A data-parallel all-reduce moves ``params * wire_bits / 8`` bytes a step;
a posit16 wire halves that against float32.  Error feedback keeps the
compression unbiased over time: each leaf's quantization residual is added
back into the next step's gradient.

Per leaf, with ``g32 = g.float() + r``: ``quant.quantize`` with one
power-of-two scale ``s`` over the whole leaf (axis None), the decoded
``deq = quant.dequantize(...)`` (NaR -> 0) and the new residual
``g32 - deq``.  A posit wire passes its codec to both: K2 in its
normalising mode (``posit_encode(..., subnormals="normalize")``, which
computes ``core.posit.encode_f32`` bit for bit) and K1 (``posit_decode``)
to float32, one launch of each per leaf on the card; on the CPU the same
wrappers take their plain versions.  Int and float wire formats have no
kernel: they ignore the codec.  The all-reduce itself is not here: the
port trains on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core import quant
from ..core.formats import PositFormat, get
from ..kernels import _build
from ..kernels.posit_decode import posit_decode
from ..kernels.posit_encode import posit_encode, subnormals_saturate
from .adamw import tree_leaves, tree_map, tree_unflatten


def check_wire_format(fmt_name: Optional[str]) -> None:
    """Raise ``ValueError`` for a posit wire format the kernels cannot
    take: one without a CUDA instantiation (``_build.check_fmt``), or a
    bias at which a float32 subnormal is representable.  The wire never
    falls back to the plain codec on the card, so the train step refuses
    such a format when it is built, on any device."""
    if fmt_name is None:
        return
    fmt = get(fmt_name)
    if isinstance(fmt, PositFormat):
        _build.check_fmt("grad_wire", fmt)
        if not subnormals_saturate(fmt):
            raise ValueError(f"grad_wire: {fmt.name} at bias {fmt.bias} "
                             "represents float32 subnormals")


def _encode_wire(x: torch.Tensor, fmt: PositFormat) -> torch.Tensor:
    return posit_encode(x, fmt, subnormals="normalize")


def _quantize(g32: torch.Tensor, fmt) -> quant.QuantizedTensor:
    return quant.quantize(g32, fmt, axis=None, encode=_encode_wire)


def _dequantize(qt: quant.QuantizedTensor) -> torch.Tensor:
    return quant.dequantize(qt, torch.float32, decode=posit_decode)


def _leaves(grads, residual):
    """(gradient, residual) leaf pairs in ``tree_leaves`` order; the
    residual None for every leaf when ``residual`` is None (zeros)."""
    flat_g = tree_leaves(grads)
    return zip(flat_g, [None] * len(flat_g) if residual is None
               else tree_leaves(residual))


def compress_grads(grads, fmt_name: Optional[str], residual=None):
    """Quantize a gradient tree to the wire format with error feedback.

    Returns (wire tree, new residual): wire leaves are ``QuantizedTensor``s
    (codes + scale), residual leaves float32 tensors.  ``residual`` None is
    a tree of zeros; it is left as it was."""
    if fmt_name is None:
        return grads, residual
    fmt = get(fmt_name)
    wires, res = [], []
    for g, r in _leaves(grads, residual):
        g32 = g.to(torch.float32)
        if r is not None:
            g32 = g32 + r
        qt = _quantize(g32, fmt)
        wires.append(qt)
        res.append(g32 - _dequantize(qt))
    return tree_unflatten(grads, wires), tree_unflatten(grads, res)


def decompress_grads(wires):
    """Inverse of ``compress_grads`` (without the residual): float32."""
    return tree_map(lambda w: _dequantize(w) if isinstance(
        w, quant.QuantizedTensor) else w, wires)


def error_feedback_update(grads, residual, fmt_name: Optional[str]):
    """One compress -> decompress with error feedback: returns (decoded
    gradients, new residual), each leaf encoded once and decoded once (on
    the card one K2 and one K1 launch per leaf).  The train step applies
    it between the gradients and AdamW, so the update sees the
    wire-precision values.  The new residual is written into
    ``residual``'s own leaves (they hold g + r, then g + r - decoded: the
    values of ``compress_grads``, with no second f32 copy of the model);
    ``residual`` None is zeros, and the new residual is then fresh."""
    if fmt_name is None:
        return grads, residual
    fmt = get(fmt_name)
    deqs, res = [], []
    for g, r in _leaves(grads, residual):
        g32 = g.to(torch.float32, copy=True) if r is None else r.add_(g)
        deq = _dequantize(_quantize(g32, fmt))
        deqs.append(deq)
        res.append(g32.sub_(deq))
    return tree_unflatten(grads, deqs), tree_unflatten(grads, res)


def wire_bytes(grads, fmt_name: Optional[str]) -> int:
    """Bytes a data-parallel all-reduce moves per step in this format."""
    n = sum(int(g.numel()) for g in tree_leaves(grads))
    bits = get(fmt_name).bits if fmt_name else 32
    return n * bits // 8
