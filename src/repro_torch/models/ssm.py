"""Mamba-2 (SSD, state-space duality) layer: the chunked form for training
and prefill, and the one-token recurrent decode step (port of
``repro.models.ssm``).

Shapes: d_inner = expand * d_model; nh = d_inner / headdim heads; state
size ds; the x / B / C streams follow the mamba2 grouping (ng groups of B
and C shared across heads).  The reference has no kernel here; this is
plain torch.

Two rules keep the port's arithmetic the reference's:

* dtypes are promoted as ``jnp`` promotes them (bf16 x f32 -> f32): the
  chunked path's ``dt``, decays and ``D`` are f32, so its ``y`` is f32,
  while the decode step casts its ``y`` back to the stream's dtype;
* the reference's three- and four-operand einsums are written as
  elementwise products followed by one two-operand contraction, in a fixed
  order.  ``torch.einsum`` would otherwise pick its contraction path by
  whether ``opt_einsum`` is installed, so two machines could run (and the
  meta-tensor op counter count) different products.  Each contraction is
  the one XLA keeps, so the counted MACs are the reference's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device
from .common import _call, _einsum, causal_conv, dense_init, rms_norm


def dims(cfg):
    """(d_inner, SSD heads, conv channels) of ``cfg``."""
    d_in = cfg.ssm_expand * cfg.d_model
    return (d_in, d_in // cfg.ssm_headdim,
            d_in + 2 * cfg.ssm_groups * cfg.ssm_state)


def init_mamba2(cfg, lead, dtype, device, generator=None):
    """The reference's leaves with a leading ``lead`` shape (the layer
    axis): ``in_proj``, ``conv_w`` and ``out_proj`` in ``dtype``, and
    ``A_log`` (A = -exp(A_log)), ``D``, ``dt_bias`` and the gated norm's
    ``norm_scale`` in float32."""
    d = cfg.d_model
    d_in, nh, conv_ch = dims(cfg)
    ng, ds = cfg.ssm_groups, cfg.ssm_state

    def dense(*shape):
        return dense_init(lead + shape, dtype, device, generator)

    def f32(fill, n):
        return torch.full(lead + (n,), fill, dtype=torch.float32,
                          device=device)

    return {"in_proj": dense(d, 2 * d_in + 2 * ng * ds + nh),
            "conv_w": dense(cfg.conv_kernel, conv_ch),
            "A_log": f32(0.0, nh), "D": f32(1.0, nh),
            "dt_bias": f32(0.0, nh), "norm_scale": f32(0.0, d_in),
            "out_proj": dense(d_in, d)}


def _split_streams(zxbcdt, cfg):
    d_in, nh, conv_ch = dims(cfg)
    z, xBC, dt = torch.split(zxbcdt, [d_in, conv_ch, nh], dim=-1)
    return z, xBC, dt  # dt: (..., nh)


def _causal_conv(xBC, conv_w, conv_state=None):
    """Depthwise causal conv along S.  xBC: (B, S, C); conv_w: (K, C).
    With ``conv_state`` ((B, K-1, C)) performs the streaming update instead
    and returns (out, new_state)."""
    if conv_state is None:
        return F.silu(causal_conv(xBC, conv_w))
    window = torch.cat([conv_state, xBC], dim=1)   # (B, K, C), S == 1
    out = sum(window[:, i:i + 1] * conv_w[i] for i in range(conv_w.shape[0]))
    return F.silu(out), window[:, 1:]


def _segsum(x):
    """x: (..., Q) -> (..., Q, Q) lower-triangular pairwise sums
    L[i, j] = sum_{j < t <= i} x_t (i >= j), as cumsum differences (the
    reference's form, not upstream Mamba's stable segsum)."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    dif = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return dif.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD forward (training / prefill).

    x: (b, S, nh, hd); dt: (b, S, nh) (softplus'd, > 0); A: (nh,)
    negative; B, C: (b, S, ng, ds); D: (nh,).  Returns (y (b, S, nh, hd),
    final_state (b, nh, hd, ds) f32).  The inter-chunk recurrence is a
    Python loop over the S / chunk chunks, in f32."""
    b, s, nh, hd = x.shape
    ng, ds = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = nh // ng
    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = B.reshape(b, nc, chunk, ng, ds)
    Cc = C.reshape(b, nc, chunk, ng, ds)
    dA = dtc * A  # (b, nc, Q, nh)

    # intra-chunk (quadratic within the chunk)
    L = torch.exp(_segsum(dA.movedim(-1, -2)))              # (b,nc,nh,Q,Q)
    scores = _einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)          # (b,nc,ng,Q,Q)
    scores = scores.repeat_interleave(rep, dim=2)           # (b,nc,nh,Q,Q)
    gated = scores * L
    # "bchqs,bcsh,bcshp->bcqhp": dt into x, then the sum over s
    y_intra = _einsum("bchqs,bcshp->bcqhp", gated, xc * dtc[..., None])

    # chunk-local final states
    dA_cum = torch.cumsum(dA, dim=2)                        # (b,nc,Q,nh)
    dA_tot = dA_cum[:, :, -1]                               # (b,nc,nh)
    decay_out = torch.exp(dA_tot[:, :, None, :] - dA_cum)   # (b,nc,Q,nh)
    Brep = Bc.repeat_interleave(rep, dim=3)
    # "bcqhn,bcqh,bcqh,bcqhp->bchpn": the decay and dt into x, then the
    # sum over q
    states = _einsum("bcqhn,bcqhp->bchpn", Brep,
                     xc * (decay_out * dtc)[..., None])     # (b,nc,nh,hd,ds)

    # inter-chunk recurrence: a loop over chunks
    st = torch.zeros((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = (st * torch.exp(dA_tot[:, c].float())[:, :, None, None]
              + states[:, c].float())
    prev_states = torch.stack(prev, dim=1)                  # (b,nc,nh,hd,ds)

    # inter-chunk contribution: "bcqhn,bcqh,bchpn->bcqhp", the decay into
    # C, then the sum over n (the states rounded to x's dtype first)
    Crep = Cc.repeat_interleave(rep, dim=3)
    decay_in = torch.exp(dA_cum)                            # (b,nc,Q,nh)
    y_inter = _einsum("bcqhn,bchpn->bcqhp", Crep * decay_in[..., None],
                      prev_states.to(x.dtype))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)
    y = y + x * D[None, None, :, None]
    return y, st


def ssd_decode_step(state, x, dt, A, B, C, D, out=None):
    """One-token recurrence. state: (b, nh, hd, ds); x: (b, nh, hd);
    dt: (b, nh); B, C: (b, ng, ds) (per head where ng = nh: a rank's
    heads).  Returns (y (b, nh, hd) in x's dtype,
    new_state).  ``out`` (the shape of ``state``, not aliasing it) takes
    the new state; ``state`` is only read."""
    nh = x.shape[1]
    ng = B.shape[1]
    rep = nh // ng
    Br = B.repeat_interleave(rep, dim=1)                    # (b, nh, ds)
    Cr = C.repeat_interleave(rep, dim=1)
    da = torch.exp(dt * A)                                  # (b, nh)
    # "bh,bhp,bhn->bhpn": an outer product in f32 (the einsum's result
    # type), no sum
    upd = ((x.float()[..., None] * Br.float()[:, :, None, :])
           * dt[:, :, None, None])
    new_state = torch.mul(state, da[:, :, None, None], out=out)
    new_state += upd
    y = _einsum("bhpn,bhn->bhp", new_state, Cr) + x * D[None, :, None]
    return y.to(x.dtype), new_state


def in_proj(params, x, quantize_w=None):
    """The fused z / xBC / dt projection: (b, S, 2 d_in + 2 ng ds + nh)."""
    w_in = params["in_proj"]
    if quantize_w is not None:
        w_in = quantize_w(w_in)
    return _einsum("bsd,dk->bsk", x, w_in)


def _streams(zxbcdt, params, cfg):
    """(z, xBC, dt softplus'd in f32, A = -exp(A_log)) of the fused
    projection."""
    z, xBC, dt = _split_streams(zxbcdt, cfg)
    dt = dt.to(torch.float32) + params["dt_bias"]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))    # jax.nn.softplus
    return z, xBC, dt, -torch.exp(params["A_log"])


def _heads(xBC, cfg):
    """xBC (b, S, conv_ch) -> x (b, S, nh, hd), B and C (b, S, ng, ds)."""
    d_in, nh, _ = dims(cfg)
    ng, ds = cfg.ssm_groups, cfg.ssm_state
    xs, B, C = torch.split(xBC, [d_in, ng * ds, ng * ds], dim=-1)
    b, s = xs.shape[0], xs.shape[1]
    return (xs.reshape(b, s, nh, cfg.ssm_headdim), B.reshape(b, s, ng, ds),
            C.reshape(b, s, ng, ds))


def _gated_norm(y, z, params):
    """The gated RMSNorm before the out projection: norm(y * silu(z))."""
    b, s = y.shape[0], y.shape[1]
    return rms_norm(y.reshape(b, s, -1) * F.silu(z), params["norm_scale"])


def _chunked_mix(zxbcdt, params, cfg):
    """Train / prefill: the layer between its two projections (the stream
    split, the causal conv, ``ssd_chunked`` and the gated norm): (the out
    projection's input, the final SSD state)."""
    z, xBC, dt, A = _streams(zxbcdt, params, cfg)
    xh, Bh, Ch = _heads(_causal_conv(xBC, params["conv_w"]), cfg)
    y, state = ssd_chunked(xh, dt, A, Bh, Ch, params["D"],
                           min(cfg.ssm_chunk, xh.shape[1]))
    return _gated_norm(y, z, params), state


def mamba2_layer(params, x, cfg, *, conv_state=None, ssm_state=None,
                 quantize_w=None, zxbcdt=None, out=None, seg=_call,
                 shard=None):
    """Full mamba2 block.  Train / prefill: conv_state / ssm_state None ->
    (y, (None, ssm_state)); ``seg`` runs the part between the two
    projections (``_chunked_mix``: called directly, or a checkpoint
    segment under remat "dots").  Decode: S == 1 with both states given
    -> (y, (conv_state, ssm_state)), new tensors (``out``: a (conv,
    state) pair of buffers to write them into); the given states are only
    read.  ``zxbcdt`` is :func:`in_proj`'s output where the caller already
    has it.  A decode ``shard`` (``serve.distributed.KVShard``) gives the
    rank's share of the states: ``conv_state`` its conv channels,
    ``ssm_state`` its heads; the conv runs over its channels and its
    output is all-gathered, the SSD update runs its heads and y is
    all-gathered; the projections and the gated norm run whole."""
    if zxbcdt is None:
        zxbcdt = in_proj(params, x, quantize_w)
    w_out = params["out_proj"]
    if quantize_w is not None:
        w_out = quantize_w(w_out)
    if ssm_state is None:
        y, ssm_state = seg(_chunked_mix, zxbcdt, params, cfg)
        return _einsum("bsk,kd->bsd", y, w_out), (None, ssm_state)
    _, nh, conv_ch = dims(cfg)
    chans, heads = ((slice(None),) * 2 if shard is None else
                    (shard.own(conv_ch, "conv channels"),
                     shard.own(nh, "SSD heads")))
    z, xBC, dt, A = _streams(zxbcdt, params, cfg)
    xBC, conv_state = _causal_conv(xBC[..., chans],
                                   params["conv_w"][:, chans], conv_state)
    if out is not None:
        conv_state = out[0].copy_(conv_state)
    if shard is not None:
        xBC = shard.all_gather(xBC)
    xh, Bh, Ch = _heads(xBC, cfg)
    rep = nh // cfg.ssm_groups          # B and C per head, then the rank's
    y, ssm_state = ssd_decode_step(
        ssm_state, xh[:, 0, heads], dt[:, 0, heads], A[heads],
        Bh[:, 0].repeat_interleave(rep, dim=1)[:, heads],
        Ch[:, 0].repeat_interleave(rep, dim=1)[:, heads], params["D"][heads],
        out=None if out is None else out[1])
    if shard is not None:
        y = shard.all_gather(y, dim=1)
    return (_einsum("bsk,kd->bsd", _gated_norm(y[:, None], z, params),
                    w_out), (conv_state, ssm_state))


def init_mamba2_state(cfg, batch, dtype=torch.float32, device="cuda"):
    """Zero (conv (*batch, K-1, conv_ch) in ``dtype``, ssm (*batch, nh, hd,
    ds) f32) states; ``batch`` is an int or a tuple of leading dims (the
    serving cache's (layers, slots)).  On the card unless the caller asks
    for the CPU."""
    device = resolve_device(device)
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    _, nh, conv_ch = dims(cfg)
    return (torch.zeros(lead + (cfg.conv_kernel - 1, conv_ch), dtype=dtype,
                        device=device),
            torch.zeros(lead + (nh, cfg.ssm_headdim, cfg.ssm_state),
                        dtype=torch.float32, device=device))
