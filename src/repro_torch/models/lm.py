"""Decoder-only language model: config, init, the training forward and
loss, and the per-block pieces the serving path uses (port of
``repro.models.lm``, dense, MoE and SSM families).

Params are a plain dict with the reference's leaf names:
``{"embed", "final_norm", "lm_head", "blocks": ({"ln", "wq", "wk", "wv",
"wo", "ln2", "wi", "wo_mlp"},)}`` where every ``blocks`` leaf is stacked
over layers (leading axis P = n_layers).  The MoE family holds a
``"moe": {"router", "wi", "wo"}`` sub-dict (``models/moe.py``) in place
of ``wi`` / ``wo_mlp``.  The SSM family (Mamba-2) has one block type, so
its period is one layer too: ``{"in_proj", "conv_w", "A_log", "D",
"dt_bias", "norm_scale", "out_proj", "ln"}`` (``models/ssm.py``).  The
reference scans over the layer axis; this port loops over layers in
Python (``layer_params``).  Every weight matmul passes through the TC
policy hook (``_qw``), which fake-quantizes each layer's slice on every
call.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch.utils.checkpoint import checkpoint

from ..core import posit, quant
from ..core.formats import PositFormat, get
from ..core.transprecision import BF16, TCPolicy
from .attention import blockwise_attention
from .common import (_einsum, apply_rope, cross_entropy, dense_init,
                     embed_init, rms_norm, rope_freqs)
from .moe import init_moe, moe_ffn
from .ssm import dims as ssm_dims
from .ssm import init_mamba2, mamba2_layer


def _round_up(x, m):
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab: int = 256
    mlp: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 10000.0
    qk_norm: bool = False
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    conv_kernel: int = 4
    dtype_name: str = "bfloat16"
    remat: str = "full"        # none | full (save block inputs only) |
                               # dots (recompute all but the weight
                               # products; dense and MoE only)
    q_block: int = 512
    kv_block: int = 1024
    attn_vjp: str = "flash"    # flash (custom bwd) | naive (autograd loop)
    tie_embed: bool = False

    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm"):
            raise NotImplementedError(
                f"family {self.family!r}: only the dense, moe and ssm "
                "families are ported (other families are a later slice of "
                "the port)")

    @property
    def dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16,
                "float32": torch.float32}[self.dtype_name]

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def vocab_pad(self) -> int:
        return _round_up(self.vocab, 256)

    @functools.cached_property
    def block_types(self) -> tuple:
        # a plain attribute once read (a non-data descriptor), so a test
        # can force another stack's block types onto a copy
        base = ("ssm",) if self.family == "ssm" else ("attn",)
        return base * self.n_layers

    @property
    def period(self) -> tuple:
        return (self.block_types[0],)

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_periods * len(self.period)

    def param_count(self) -> int:
        d, hd, nh, nkv = self.d_model, self.head_dim, self.n_heads, \
            self.n_kv_heads
        head = 0 if self.tie_embed else d * self.vocab_pad
        if self.family == "ssm":
            d_in, nh_ssm, conv_ch = ssm_dims(self)
            ng, ds = self.ssm_groups, self.ssm_state
            block = (d * (2 * d_in + 2 * ng * ds + nh_ssm)   # in_proj
                     + self.conv_kernel * conv_ch + 3 * nh_ssm + d_in
                     + d_in * d + d)                        # out_proj, ln
            return self.vocab_pad * d + d + head + self.n_layers * block
        if self.family == "moe":      # router + gated experts
            ffn = self.moe_experts * (d + 3 * d * self.d_ff)
        else:
            wi = 2 * self.d_ff if self.mlp == "swiglu" else self.d_ff
            ffn = d * wi + self.d_ff * d
        block = (2 * d + d * (nh + 2 * nkv) * hd + nh * hd * d + ffn
                 + (2 * hd if self.qk_norm else 0))
        return self.vocab_pad * d + d + head + self.n_layers * block


def init_params(cfg: ModelCfg, generator: torch.Generator = None,
                device="cuda"):
    """Random params with the reference's init scales (truncated normal in
    +-2 sigma; sigma = fan_in^-1/2 for dense weights, 0.02 for the
    embedding; norms zero).  Draws come from ``generator``, so the values
    differ from the reference's for the same seed."""
    from .. import resolve_device
    device = resolve_device(device)
    d, P, dt = cfg.d_model, cfg.n_layers, cfg.dtype

    def dense(*shape):
        return dense_init(shape, dt, device, generator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    if cfg.family == "ssm":
        blk = init_mamba2(cfg, (P,), dt, device, generator)
        blk["ln"] = zeros(P, d)
    else:
        blk = _init_attn_block(cfg, dense, zeros, device, generator)
    params = {"embed": embed_init((cfg.vocab_pad, d), dt, device, generator),
              "final_norm": zeros(d)}
    if not cfg.tie_embed:
        params["lm_head"] = dense(d, cfg.vocab_pad)
    params["blocks"] = (blk,)
    return params


def _init_attn_block(cfg: ModelCfg, dense, zeros, device, generator):
    """The attention block's leaves, stacked over the layers: attention,
    norms and the dense MLP or the MoE experts."""
    d, hd, nh, nkv, P = (cfg.d_model, cfg.head_dim, cfg.n_heads,
                         cfg.n_kv_heads, cfg.n_layers)
    blk = {"ln": zeros(P, d), "wq": dense(P, d, nh * hd),
           "wk": dense(P, d, nkv * hd), "wv": dense(P, d, nkv * hd),
           "wo": dense(P, nh * hd, d)}
    if cfg.qk_norm:
        blk["q_norm"], blk["k_norm"] = zeros(P, hd), zeros(P, hd)
    blk["ln2"] = zeros(P, d)
    if cfg.family == "moe":
        blk["moe"] = init_moe(d, cfg.d_ff, cfg.moe_experts, cfg.dtype,
                              device, generator, lead=(P,))
    else:
        wi_cols = 2 * cfg.d_ff if cfg.mlp == "swiglu" else cfg.d_ff
        blk.update(wi=dense(P, d, wi_cols), wo_mlp=dense(P, cfg.d_ff, d))
    return blk


def layer_params(blocks: dict, i: int) -> dict:
    """Layer i's slice of the stacked block params, nested dicts (``moe``)
    included (QuantizedTensor leaves slice data and scale together)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def embed_rows(embed, tokens, policy: TCPolicy):
    """``policy.quantize_weight(embed, "embed_weights")[tokens]``.  Under a
    posit format only the looked-up rows are encoded, with the whole
    table's per-column pow2 scale: the same bits as quantizing the table
    and then looking up, without encoding every row of it."""
    f = (None if isinstance(embed, quant.QuantizedTensor)
         else policy.fmt_for("embed_weights"))
    if f is None or not isinstance(get(f), PositFormat):
        return policy.quantize_weight(embed, "embed_weights")[tokens]
    fmt = get(f)
    scale = quant._pow2_scale(embed.to(torch.float32), (0,))
    rows = embed[tokens].to(torch.float32)
    return quant.dequantize(quant.QuantizedTensor(
        posit.encode_f32(rows / scale, fmt), scale, fmt), embed.dtype)


def lm_head(params, cfg: ModelCfg):
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    return head.to(cfg.dtype)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _qw(policy: TCPolicy, role):
    def q(w):
        return policy.quantize_weight(w, role)
    return q


def _call(f, *args):
    return f(*args)


def _recompute(f, *args):
    """One segment of remat "dots": its inputs are saved and it runs again
    in the backward (nothing in it draws random numbers)."""
    return checkpoint(f, *args, use_reentrant=False, preserve_rng_state=False)


def _mlp_act(h, cfg: ModelCfg):
    if cfg.mlp == "swiglu":
        gate, up = torch.chunk(h, 2, dim=-1)
        return torch.nn.functional.silu(gate) * up
    return torch.nn.functional.gelu(h, approximate="tanh")


def _mlp(p, x, cfg: ModelCfg, policy, seg=_call):
    q = _qw(policy, "mlp_weights")
    h = _einsum("bsd,df->bsf", x, q(p["wi"]))
    h = seg(_mlp_act, h, cfg)
    return _einsum("bsf,fd->bsd", h, q(p["wo_mlp"]))


def ffn(p, x, cfg: ModelCfg, policy, seg=_call):
    """The block's FFN after the second norm: (out, aux).  MoE routes the
    call's B x S tokens together under ``cfg.capacity_factor`` and its
    expert weights pass the ``mlp_weights`` hook, one layer's (E, ...)
    slice at a time; the dense MLP has no aux loss (0)."""
    if cfg.family == "moe":
        return moe_ffn(p["moe"], x, top_k=cfg.moe_topk,
                       capacity_factor=cfg.capacity_factor,
                       quantize_w=_qw(policy, "mlp_weights"))
    return _mlp(p, x, cfg, policy, seg), 0.0


def _qkv(p, x, cfg: ModelCfg, policy):
    """Fused QKV projection: one matmul over concat(wq, wk, wv)."""
    q_ = _qw(policy, "attn_weights")
    b, s, _ = x.shape
    hd, nh, nkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wqkv = torch.cat([q_(p["wq"]), q_(p["wk"]), q_(p["wv"])], dim=-1)
    qkv = _einsum("bsd,dk->bsk", x, wqkv)
    qp, kp, vp = torch.split(qkv, [nh * hd, nkv * hd, nkv * hd], dim=-1)
    qp = qp.reshape(b, s, nh, hd)
    kp = kp.reshape(b, s, nkv, hd)
    vp = vp.reshape(b, s, nkv, hd)
    if cfg.qk_norm:
        qp = rms_norm(qp, p["q_norm"])
        kp = rms_norm(kp, p["k_norm"])
    return qp, kp, vp


def _rope_cs(cfg: ModelCfg, positions):
    return rope_freqs(cfg.head_dim, cfg.rope_theta, positions)


def _attn_core(qp, kp, vp, cfg: ModelCfg):
    """RoPE and causal attention over the projected heads -> (B, S,
    nh * hd)."""
    b, s = qp.shape[:2]
    cos, sin = _rope_cs(cfg, torch.arange(s, device=qp.device))
    qp = apply_rope(qp, cos, sin)
    kp = apply_rope(kp, cos, sin)
    ao = blockwise_attention(qp, kp, vp, causal=True, q_block=cfg.q_block,
                             kv_block=cfg.kv_block, vjp=cfg.attn_vjp)
    return ao.reshape(b, s, -1)


def _attn_block(p, x, cfg: ModelCfg, policy, seg=_call):
    """Training attention block (+MLP): dense, causal, RoPE, no
    cross-attention.  ``seg`` runs the parts between the weight products
    (the norms, RoPE + attention, the MLP's activation): called directly,
    or ``_recompute`` for remat "dots" (the MoE FFN runs outside any
    segment).  Returns (x, aux)."""
    h = seg(rms_norm, x, p["ln"])
    qp, kp, vp = _qkv(p, h, cfg, policy)
    ao = seg(_attn_core, qp, kp, vp, cfg)
    ao = _einsum("bsk,kd->bsd", ao, _qw(policy, "attn_weights")(p["wo"]))
    x = x + ao
    mo, aux = ffn(p, seg(rms_norm, x, p["ln2"]), cfg, policy, seg)
    return x + mo, aux


def _ssm_block(p, x, cfg: ModelCfg, policy, seg=_call):
    """Training Mamba-2 block (no FFN): norm, the SSD layer with its two
    projections through the ``mlp_weights`` hook, residual.  Returns (x,
    aux = 0)."""
    h = rms_norm(x, p["ln"])
    y, _ = mamba2_layer(p, h, cfg, quantize_w=_qw(policy, "mlp_weights"))
    return x + y.to(x.dtype), 0.0


def _run_stack(blocks, x, cfg: ModelCfg, policy):
    """The layer stack: a Python loop over the stacked layer axis, each
    layer the block of its type.  Under ``remat="full"`` each layer runs
    in ``torch.utils.checkpoint`` (only the block inputs are saved; the
    block recomputes in the backward).  Under ``"dots"`` (attention
    blocks) the weights' fake-quant and the weight products (``bsd,df``)
    run outside any checkpoint, so autograd keeps the products and their
    operands, and the norms, RoPE + attention and the MLP's activation
    recompute (the reference's ``dots_with_no_batch_dims_saveable`` keeps
    the products alone and recomputes the fake-quant too).  The SSM block
    has no "dots" segmentation yet."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: expected none, full or dots")
    block = {"attn": _attn_block, "ssm": _ssm_block}[cfg.period[0]]
    if cfg.remat == "dots" and block is _ssm_block:
        raise NotImplementedError(
            "remat='dots' is not ported for the ssm family (use 'full' or "
            "'none')")
    aux = 0.0
    for i in range(cfg.n_layers):
        p_i = layer_params(blocks[0], i)
        if cfg.remat == "full":
            x, a = checkpoint(block, p_i, x, cfg, policy,
                              use_reentrant=False)
        else:
            x, a = block(p_i, x, cfg, policy,
                         _recompute if cfg.remat == "dots" else _call)
        aux = aux + a
    return x, aux


def forward(params, batch, cfg: ModelCfg, policy: TCPolicy = BF16):
    """Training / scoring forward: returns (logits (B, S, vocab_pad),
    aux_loss): the MoE layers' summed load-balancing loss, 0 for the dense
    family."""
    emb_q = policy.quantize_weight(params["embed"], "embed_weights")
    x = emb_q[batch["tokens"]].to(cfg.dtype)
    x, aux = _run_stack(params["blocks"], x, cfg, policy)
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    head = policy.quantize_weight(head, "embed_weights", node="lm_head")
    logits = _einsum("bsd,dv->bsv", x, head.to(cfg.dtype))
    return logits, torch.as_tensor(aux, dtype=torch.float32,
                                   device=logits.device)


def loss_fn(params, batch, cfg: ModelCfg, policy: TCPolicy = BF16):
    """Mean next-token cross entropy (+ 0.01 x aux) and its parts."""
    logits, aux = forward(params, batch, cfg, policy)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def hoist_weight_quant(params, policy: TCPolicy):
    """Quantize every weight the policy's hook would quantize, once.

    ``quantize_weight`` is a pure function of the weight, so running it
    here and serving with ``weights_free(policy)`` gives the same logits as
    running it at every call.  Each layer's slice is quantized on its own
    (per output channel over that layer's input axis), as the reference's
    layer scan does.  MoE expert weights are quantized a layer's whole
    (E, ...) slice at a time (one scale per output column over the expert
    and input axes, as the reference's per-call hook sees them); the
    router passes no hook and stays as it is.  An SSM block's two
    projections (``in_proj``, ``out_proj``) pass the ``mlp_weights`` hook;
    its conv taps and f32 leaves pass none and stay raw."""
    q_attn, q_mlp = _qw(policy, "attn_weights"), _qw(policy, "mlp_weights")

    def per_layer(q, w):
        return torch.stack([q(w[i]) for i in range(w.shape[0])])

    out = dict(params)
    if "lm_head" in params:
        out["embed"] = policy.quantize_weight(params["embed"],
                                              "embed_weights")
    # else tied: the serving head reads the raw table (the reference's
    # does), so it stays raw here and the lookup quantizes its rows
    # (``embed_rows`` under ``weights_free(policy, tied=True)``)
    blocks = []
    for blk in params["blocks"]:
        nb = dict(blk)
        if "in_proj" in blk:
            for name in ("in_proj", "out_proj"):
                nb[name] = per_layer(q_mlp, blk[name])
            blocks.append(nb)
            continue
        for name in ("wq", "wk", "wv", "wo"):
            nb[name] = per_layer(q_attn, blk[name])
        if "moe" in blk:
            nb["moe"] = dict(blk["moe"], **{
                name: per_layer(q_mlp, blk["moe"][name])
                for name in ("wi", "wo")})
        else:
            for name in ("wi", "wo_mlp"):
                nb[name] = per_layer(q_mlp, blk[name])
        blocks.append(nb)
    out["blocks"] = tuple(blocks)
    return out


def weights_free(policy: TCPolicy, tied: bool = False) -> TCPolicy:
    """The policy with its weight roles cleared: serving hoisted weights
    through it skips the per-call weight hook and keeps the KV format.  A
    tied model (``tied``: ``cfg.tie_embed``) keeps its embedding role, for
    the lookup of the table ``hoist_weight_quant`` left raw."""
    return dataclasses.replace(
        policy, attn_weights=None, mlp_weights=None,
        embed_weights=policy.embed_weights if tied else None,
        layer_overrides=(), node_overrides=())
