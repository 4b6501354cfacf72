"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch (port
of ``repro.models.moe``).

GShard/Switch-style: a float32 router picks each token's top-k experts,
the k gates are renormalised over the top-k (before any drop), and each
expert takes at most ``cap`` tokens, filled in token-major order with each
token's k choices in top-k order; a choice past its expert's capacity is
dropped (its gate is not renormalised after the drop).  Fully static
shapes.  The expert products are plain batched products (``ecd,edf``,
``ecf,efd``): no TPU kernel of the reference runs here.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .common import _einsum, dense_init


def init_moe(d_model: int, d_ff: int, n_experts: int, dtype, device,
             generator=None, lead: Tuple[int, ...] = ()):
    """Router (d, E) float32, gated expert weights wi (E, d, 2 ff) and
    wo (E, ff, d) in ``dtype``; ``lead`` prepends stacked axes (the layer
    axis of ``lm.init_params``)."""
    return {
        "router": dense_init(lead + (d_model, n_experts), torch.float32,
                             device, generator),
        "wi": dense_init(lead + (n_experts, d_model, 2 * d_ff), dtype,
                         device, generator),
        "wo": dense_init(lead + (n_experts, d_ff, d_model), dtype, device,
                         generator),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: all zeros where idx is outside [0, n); no host
    check of the indices (the stage traces on meta tensors)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity(t: int, top_k: int, n_exp: int, capacity_factor: float) -> int:
    """Tokens each expert takes: ``capacity_factor * top_k * t / n_exp``
    truncated, at least 1; ``capacity_factor <= 0`` is dropless (t)."""
    if capacity_factor <= 0:
        return t
    return max(1, int(capacity_factor * top_k * t / n_exp))


def _route(params, tokens, top_k: int, capacity_factor: float):
    """Shared router: returns (gate_k, idx_k, pos, keep, cap, aux).

    The top-k keeps ``jax.lax.top_k``'s order: descending gates, the lower
    expert index first on a tie (a stable descending sort; ``torch.topk``
    does not promise it), so a row of equal gates picks experts 0..k-1."""
    t = tokens.shape[0]
    n_exp = params["router"].shape[-1]
    gates = torch.softmax(_einsum("td,de->te", tokens.to(torch.float32),
                                  params["router"]), dim=-1)
    idx_k = torch.sort(gates, dim=-1, descending=True,
                       stable=True).indices[:, :top_k]          # (T, k)
    gate_k = torch.gather(gates, -1, idx_k)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    cap = capacity(t, top_k, n_exp, capacity_factor)
    onehot = _one_hot(idx_k, n_exp, torch.int32)                # (T, k, E)
    flat = onehot.reshape(t * top_k, n_exp)
    pos_in_exp = (torch.cumsum(flat, dim=0, dtype=torch.int32)
                  - flat).reshape(t, top_k, n_exp)
    pos = (pos_in_exp * onehot).sum(-1, dtype=torch.int32)      # (T, k)
    keep = (pos < cap) & (onehot.sum(-1) > 0)
    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = gates.mean(0)
    fe = (onehot.sum(1) > 0).to(torch.float32).mean(0)
    aux = n_exp * torch.sum(me * fe)
    return gate_k, idx_k, pos, keep, cap, aux


def _expert_ffn(params, xe, quantize_w):
    """xe: (E, C, d) -> (E, C, d), a gated SwiGLU per expert."""
    wi, wo = params["wi"], params["wo"]
    if quantize_w is not None:
        wi, wo = quantize_w(wi), quantize_w(wo)
    h = _einsum("ecd,edf->ecf", xe, wi)
    gate, up = torch.chunk(h, 2, dim=-1)
    h = torch.nn.functional.silu(gate) * up
    return _einsum("ecf,efd->ecd", h, wo)


def dispatch_for(t: int, n_exp: int, cap: int) -> str:
    """``auto``'s choice: the one-hot einsum while its (T, E, C) dispatch
    tensor holds at most 2^22 elements, else the indexed scatter."""
    return "einsum" if t * n_exp * cap <= (1 << 22) else "scatter"


def moe_ffn(params, x, *, top_k: int, capacity_factor: float = 1.25,
            quantize_w=None, dispatch: str = "auto"):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).  T = B * S tokens
    route together, so a token's capacity depends on every other token of
    the call.

    * ``einsum``  — GShard one-hot dispatch/combine, gates in the model
      dtype;
    * ``scatter`` — slot tables (a trash slot at index ``cap`` takes the
      dropped choices), a gather into expert batches, a scatter-add back
      to tokens; the gates stay float32 until the add.
    """
    b, s, d = x.shape
    n_exp = params["router"].shape[-1]
    t = b * s
    tokens = x.reshape(t, d)
    gate_k, idx_k, pos, keep, cap, aux = _route(params, tokens, top_k,
                                                capacity_factor)
    if dispatch == "auto":
        dispatch = dispatch_for(t, n_exp, cap)
    dt = x.dtype
    if dispatch == "einsum":
        disp = (_one_hot(idx_k, n_exp, dt)[..., None]
                * _one_hot(pos, cap, dt)[..., None, :]
                * keep[..., None, None].to(dt))                 # (T,k,E,C)
        comb = disp * gate_k[..., None, None].to(dt)
        disp_t = disp.sum(1)                                    # (T, E, C)
        comb_t = comb.sum(1)
        xe = _einsum("td,tec->ecd", tokens, disp_t)             # (E, C, d)
        ye = _expert_ffn(params, xe, quantize_w)
        out = _einsum("ecd,tec->td", ye, comb_t)
    elif dispatch == "scatter":
        dev = x.device
        flat_e = idx_k.reshape(-1).long()                       # (T*k,)
        flat_keep = keep.reshape(-1)
        flat_gate = (gate_k.reshape(-1) * flat_keep).to(torch.float32)
        tok_ids = torch.arange(t, device=dev).repeat_interleave(top_k)
        # dropped choices write to the trash slot (index cap)
        flat_p = torch.where(flat_keep, pos.reshape(-1), cap).long()
        slot_tok = torch.zeros((n_exp, cap + 1), dtype=torch.long,
                               device=dev).index_put_(
            (flat_e, flat_p), tok_ids)[:, :cap]
        slot_gate = torch.zeros((n_exp, cap + 1), dtype=torch.float32,
                                device=dev).index_put_(
            (flat_e, flat_p), flat_gate)[:, :cap]
        slot_used = torch.zeros((n_exp, cap + 1), dtype=torch.bool,
                                device=dev).index_put_(
            (flat_e, flat_p), flat_keep)[:, :cap]
        xe = tokens[slot_tok] * slot_used[..., None].to(dt)
        ye = _expert_ffn(params, xe, quantize_w)
        contrib = ye * slot_gate[..., None].to(ye.dtype)
        out = torch.zeros((t, d), dtype=dt, device=dev).index_add_(
            0, slot_tok.reshape(-1),
            (contrib.reshape(n_exp * cap, d)
             * slot_used.reshape(-1, 1).to(ye.dtype)).to(dt))
    else:
        raise ValueError(f"dispatch={dispatch!r}: expected auto, einsum or "
                         "scatter")
    return out.reshape(b, s, d), aux
