"""RG-LRU recurrent unit of the hybrid family (RecurrentGemma / Griffin,
arXiv:2402.19427; port of ``repro.models.rglru``).

Real-gated linear recurrent unit:

    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Sequence mode composes the affine maps h -> a h + b by a doubling scan
over S (log2 S elementwise passes, the depth of the reference's
``jax.lax.associative_scan``), in f32.  Neither a loop over tokens (one
launch per token and layer) nor the closed form through ``cumsum(log
a)`` (``exp(-sum log a)`` overflows f32 after ~850 tokens at the init's
a = 0.9) is used.  Decode is the one-token update.  The reference has no
kernel here; this is plain torch.
"""
from __future__ import annotations

import torch

from ..core.quant import maybe_dequant
from .common import _einsum, dense_init

C_FACTOR = 8.0


def init_rglru(width: int, lead, dtype, device, generator=None):
    """The reference's leaves with a leading ``lead`` shape (the period
    axis, or () for a tail block): ``w_a`` / ``w_x`` in ``dtype``, zero
    ``b_a`` / ``b_x`` and ``Lambda`` in float32, drawn so that a^c lies in
    [0.9, 0.999] (the paper's appendix)."""
    u = torch.empty(lead + (width,), dtype=torch.float32, device=device)
    u.uniform_(0.9, 0.999, generator=generator)
    lam = torch.log(torch.expm1(-torch.log(u) / C_FACTOR))  # softplus^-1

    def dense():
        return dense_init(lead + (width, width), dtype, device, generator)

    def zeros():
        return torch.zeros(lead + (width,), dtype=torch.float32,
                           device=device)

    return {"w_a": dense(), "b_a": zeros(), "w_x": dense(), "b_x": zeros(),
            "Lambda": lam}


def _gates(params, x, cols=slice(None)):
    """(a, gated x), both f32: the fused ``[w_a | w_x]`` product in x's
    dtype (packed weights decoded, no policy hook), then the gates in f32,
    as the reference computes them.  ``cols``: the width columns to
    compute (a rank's share of a split state), all by default."""
    w_ax = torch.cat([maybe_dequant(params["w_a"])[..., cols],
                      maybe_dequant(params["w_x"])[..., cols]], dim=-1)
    ri = _einsum("...d,dk->...k", x, w_ax).to(torch.float32)
    r_in, i_in = torch.chunk(ri, 2, dim=-1)
    r = torch.sigmoid(r_in + params["b_a"][..., cols])
    i = torch.sigmoid(i_in + params["b_x"][..., cols])
    lam = params["Lambda"][..., cols]
    log_a = -C_FACTOR * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * i * x[..., cols].to(torch.float32)


def scan(a, b):
    """Inclusive scan of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis
    1: at offset d = 1, 2, 4, .. every position t >= d composes its map
    with the one d back, ``(a_t a_{t-d}, a_t b_{t-d} + b_t)``, the
    reference's combine.  ceil(log2 S) passes, out of place (autograd
    differentiates it)."""
    s, d = a.shape[1], 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < s:               # the last pass needs no new a
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru(params, x, h0=None):
    """x: (B, S, width) -> (y in x's dtype, h_last (B, width) f32)."""
    a, gx = _gates(params, x)
    if h0 is not None:
        gx = torch.cat([gx[:, :1] + (a[:, 0] * h0)[:, None], gx[:, 1:]],
                       dim=1)
    h = scan(a, gx)
    return h.to(x.dtype), h[:, -1]


def rglru_step(params, x1, h, cols=slice(None)):
    """Decode: x1 (B, 1, width), h (B, width) f32 -> (y (B, 1, width) in
    x1's dtype, h' (B, width) f32, a new tensor; ``h`` is only read).
    With ``cols`` (a rank's width columns) ``h``, y and h' hold those
    columns only."""
    a, gx = _gates(params, x1, cols)
    h_new = a[:, 0] * h + gx[:, 0]
    return h_new[:, None].to(x1.dtype), h_new
