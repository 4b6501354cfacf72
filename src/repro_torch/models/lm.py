"""The language model: config, init, the training forward and loss, and
the per-block pieces the serving path uses (port of ``repro.models.lm``,
every family: dense, MoE, SSM, hybrid, vlm and audio).

Params are a plain dict with the reference's leaf names:
``{"embed", "final_norm", "lm_head", "blocks": ({"ln", "wq", "wk", "wv",
"wo", "ln2", "wi", "wo_mlp"},)}`` where every ``blocks`` leaf is stacked
over layers (leading axis P = n_layers).  The MoE family holds a
``"moe": {"router", "wi", "wo"}`` sub-dict (``models/moe.py``) in place
of ``wi`` / ``wo_mlp``.  The SSM family (Mamba-2) has one block type, so
its period is one layer too: ``{"in_proj", "conv_w", "A_log", "D",
"dt_bias", "norm_scale", "out_proj", "ln"}`` (``models/ssm.py``).

The hybrid family (Griffin / RecurrentGemma) cycles a pattern of block
types, ``("rec", "rec", "attn")``: ``blocks`` holds one dict per pattern
position, each stacked over the ``n_periods`` whole periods, and the
``n_tail`` layers past the last whole period sit unstacked in ``tail``
(a tuple of dicts), as the reference lays them out.  A recurrent block
is ``{"ln", "wx", "wy", "conv_w", "rglru": {"w_a", "b_a", "w_x", "b_x",
"Lambda"}, "w_out", "ln2", "wi", "wo_mlp"}`` (``models/rglru.py``); its
attention blocks are local (``cfg.window``).

The vlm family (Qwen2-VL) is the dense stack with M-RoPE (``cfg.mrope``:
the rotary half split into temporal, height and width sections, each with
its own position stream; the stub frontend gives all three the text
position) and takes a batch of patch embeddings (``batch["embeds"]``, (B,
S, d)) in place of tokens.  The audio family (Whisper) is an encoder-
decoder: ``enc_blocks`` (one attention-block dict stacked over
``enc_layers``) and ``enc_norm`` encode ``batch["frames"]`` (B, enc_seq,
d) plus sinusoid positions, non-causal and without RoPE, and each decoder
block adds cross-attention over that memory after its self-attention
(``ln_x``, ``wq_x``, ``wk_x``, ``wv_x``, ``wo_x``).  The cross weights
pass no hook (the reference's ``maybe_dequant`` only), though
``pack_params`` and the energy model give them the ``attn_weights`` role;
the encoder's blocks pass the hook as the decoder's do.

The reference scans over the period axis; this port loops over layers in
Python (``layer_block`` finds layer l's dict).  Every weight matmul of
the attention and MLP paths passes through the TC policy hook (``_qw``),
which fake-quantizes each layer's slice on every call; the recurrent
block's ``wx`` / ``wy`` / ``w_out`` and the RG-LRU's gates pass none (the
reference's ``maybe_dequant`` only), though ``pack_params`` and the energy
model give them the ``mlp_weights`` role, as the reference does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..core import posit, quant
from ..core.formats import PositFormat, get
from ..core.transprecision import BF16, TCPolicy
from .attention import blockwise_attention
from .common import (_call, _einsum, apply_rope, causal_conv, cross_entropy,
                     dense_init, embed_init, mrope_freqs, rms_norm,
                     rope_freqs, sinusoid_positions)
from .moe import init_moe, moe_ffn
from .rglru import init_rglru, rglru
from .ssm import dims as ssm_dims
from .ssm import init_mamba2, mamba2_layer


FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


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
    mrope: bool = False                   # M-RoPE sections (vlm)
    window: Optional[int] = None          # sliding window of local attention
    pattern: tuple = ("attn",)            # cycled block types (hybrid)
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
    # audio (Whisper-style encoder-decoder)
    enc_layers: int = 0
    enc_seq: int = 1500
    dtype_name: str = "bfloat16"
    remat: str = "full"        # none | full (save block inputs only) |
                               # dots (recompute all but the weight
                               # products; attention-only decoder
                               # stacks: dense, MoE, vlm)
    q_block: int = 512
    kv_block: int = 1024
    attn_vjp: str = "flash"    # flash (custom bwd) | naive (autograd loop)
    tie_embed: bool = False

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; known: "
                             f"{FAMILIES}")

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
        if self.family == "ssm":
            base = ("ssm",)
        elif self.family == "hybrid":
            base = tuple(self.pattern)
        else:
            base = ("attn",)
        reps = -(-self.n_layers // len(base))
        return (base * reps)[: self.n_layers]

    @property
    def period(self) -> tuple:
        return (tuple(self.pattern) if self.family == "hybrid"
                else (self.block_types[0],))

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.period)

    @property
    def n_tail(self) -> int:
        return self.n_layers - self.n_periods * len(self.period)

    @property
    def tail_types(self) -> tuple:
        return self.block_types[self.n_periods * len(self.period):]

    def param_count(self) -> int:
        d, hd, nh, nkv = self.d_model, self.head_dim, self.n_heads, \
            self.n_kv_heads
        head = 0 if self.tie_embed else d * self.vocab_pad
        wi = 2 * self.d_ff if self.mlp == "swiglu" else self.d_ff
        if self.family == "hybrid":
            rec = (2 * d + 3 * d * d + self.conv_kernel * d   # ln, ln2, wx,
                   + 2 * d * d + 3 * d                        # wy, w_out,
                   + d * wi + self.d_ff * d)                  # conv, rglru
            attn = (2 * d + d * (nh + 2 * nkv) * hd + nh * hd * d
                    + d * wi + self.d_ff * d)
            return self.vocab_pad * d + d + head + sum(
                rec if t == "rec" else attn for t in self.block_types)
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
            ffn = d * wi + self.d_ff * d
        block = (2 * d + d * (nh + 2 * nkv) * hd + nh * hd * d + ffn
                 + (2 * hd if self.qk_norm else 0))
        total = self.vocab_pad * d + d + head + self.n_layers * block
        if self.family == "audio":    # cross-attention, encoder, enc_norm
            cross = d + 2 * d * nh * hd + 2 * d * nkv * hd
            total += self.n_layers * cross + self.enc_layers * block + d
        return total


def init_params(cfg: ModelCfg, generator: torch.Generator = None,
                device="cuda"):
    """Random params with the reference's init scales (truncated normal in
    +-2 sigma; sigma = fan_in^-1/2 for dense weights, 0.02 for the
    embedding; norms zero).  Draws come from ``generator``, so the values
    differ from the reference's for the same seed."""
    from .. import resolve_device
    device = resolve_device(device)
    d, dt = cfg.d_model, cfg.dtype
    blocks = tuple(_init_block(cfg, t, (cfg.n_periods,), device, generator)
                   for t in cfg.period)
    params = {"embed": embed_init((cfg.vocab_pad, d), dt, device, generator),
              "final_norm": torch.zeros((d,), dtype=torch.float32,
                                        device=device)}
    if not cfg.tie_embed:
        params["lm_head"] = dense_init((d, cfg.vocab_pad), dt, device,
                                       generator)
    params["blocks"] = blocks
    if cfg.n_tail:
        params["tail"] = tuple(_init_block(cfg, t, (), device, generator)
                               for t in cfg.tail_types)
    if cfg.family == "audio":
        params["enc_blocks"] = (_init_block(cfg, "attn", (cfg.enc_layers,),
                                            device, generator, cross=False),)
        params["enc_norm"] = torch.zeros((d,), dtype=torch.float32,
                                         device=device)
    return params


def _init_block(cfg: ModelCfg, btype: str, lead: tuple, device, generator,
                cross: Optional[bool] = None):
    """One block type's leaves with a leading ``lead`` shape (the period
    axis, or () for a tail block): attention (norms, the dense MLP or the
    MoE experts; an audio decoder block's cross-attention unless ``cross``
    is False), Mamba-2 or the recurrent block."""
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads

    def dense(*shape):
        return dense_init(lead + shape, cfg.dtype, device, generator)

    def zeros(*shape):
        return torch.zeros(lead + shape, dtype=torch.float32, device=device)

    wi_cols = 2 * cfg.d_ff if cfg.mlp == "swiglu" else cfg.d_ff
    if btype == "ssm":
        blk = init_mamba2(cfg, lead, cfg.dtype, device, generator)
        blk["ln"] = zeros(d)
        return blk
    if btype == "rec":
        blk = {"ln": zeros(d), "wx": dense(d, d), "wy": dense(d, d),
               "conv_w": dense(cfg.conv_kernel, d),
               "rglru": init_rglru(d, lead, cfg.dtype, device, generator),
               "w_out": dense(d, d), "ln2": zeros(d)}
        blk.update(wi=dense(d, wi_cols), wo_mlp=dense(cfg.d_ff, d))
        return blk
    blk = {"ln": zeros(d), "wq": dense(d, nh * hd),
           "wk": dense(d, nkv * hd), "wv": dense(d, nkv * hd),
           "wo": dense(nh * hd, d)}
    if cfg.qk_norm:
        blk["q_norm"], blk["k_norm"] = zeros(hd), zeros(hd)
    if (cfg.family == "audio") if cross is None else cross:
        blk.update(ln_x=zeros(d), wq_x=dense(d, nh * hd),
                   wk_x=dense(d, nkv * hd), wv_x=dense(d, nkv * hd),
                   wo_x=dense(nh * hd, d))
    blk["ln2"] = zeros(d)
    if cfg.family == "moe":
        blk["moe"] = init_moe(d, cfg.d_ff, cfg.moe_experts, cfg.dtype,
                              device, generator, lead=lead)
    else:
        blk.update(wi=dense(d, wi_cols), wo_mlp=dense(cfg.d_ff, d))
    return blk


def layer_params(blocks: dict, i: int) -> dict:
    """Layer i's slice of the stacked block params, nested dicts (``moe``,
    ``rglru``) included (QuantizedTensor leaves slice data and scale
    together)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def layer_block(tree, cfg: ModelCfg, l: int):
    """(block type, layer l's dict) of a params or cache tree laid out as
    ``init_params`` lays it out: layer l of a whole period is period
    l // len(period)'s slice of ``tree["blocks"][l % len(period)]`` (views:
    writes land in the stacked buffers), a tail layer is its unstacked
    ``tree["tail"]`` dict."""
    n = len(cfg.period)
    if l < cfg.n_periods * n:
        return cfg.period[l % n], layer_params(tree["blocks"][l % n], l // n)
    return cfg.block_types[l], tree["tail"][l - cfg.n_periods * n]


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
    """cos/sin of the rotary embedding at ``positions``.  Under M-RoPE
    (``cfg.mrope``) positions are (B, S), broadcast to the three streams
    (or (3, B, S) given), and the rotary half splits into sections
    (half - 2 * 3 * (half // 8), 3 * (half // 8), 3 * (half // 8)): cos/sin
    (B, S, half).  Else cos/sin (..., S, half) of 1-D RoPE."""
    if cfg.mrope:
        pos3 = (positions.expand((3,) + tuple(positions.shape))
                if positions.ndim == 2 else positions)
        half = cfg.head_dim // 2
        sec = (half - 2 * ((half // 8) * 3), (half // 8) * 3,
               (half // 8) * 3)
        return mrope_freqs(cfg.head_dim, cfg.rope_theta, pos3, sections=sec)
    return rope_freqs(cfg.head_dim, cfg.rope_theta, positions)


def seq_positions(cfg: ModelCfg, b: int, s: int, device):
    """Positions 0..s-1 for ``_rope_cs``: (s,), or (b, s) under M-RoPE."""
    pos = torch.arange(s, device=device)
    return pos[None].expand(b, s) if cfg.mrope else pos


def _attn_core(qp, kp, vp, cfg: ModelCfg, causal: bool = True):
    """Attention over the projected heads -> (B, S, nh * hd): RoPE (or
    M-RoPE) and causal attention, local where ``cfg.window`` is set; or,
    for an encoder block (``causal`` False), no rotary embedding and no
    mask."""
    b, s = qp.shape[:2]
    if causal:
        cos, sin = _rope_cs(cfg, seq_positions(cfg, b, s, qp.device))
        qp = apply_rope(qp, cos, sin)
        kp = apply_rope(kp, cos, sin)
    ao = blockwise_attention(qp, kp, vp, causal=causal,
                             window=cfg.window if causal else None,
                             q_block=cfg.q_block, kv_block=cfg.kv_block,
                             vjp=cfg.attn_vjp)
    return ao.reshape(b, s, -1)


def cross_kv(p, memory, cfg: ModelCfg):
    """An audio decoder block's cross K/V over the encoder's ``memory``
    (B, M, d): two (B, M, nkv, hd) projections through ``maybe_dequant``
    only (the reference hooks no cross weight)."""
    b, m = memory.shape[:2]
    shape = (b, m, cfg.n_kv_heads, cfg.head_dim)
    return tuple(_einsum("bsd,dk->bsk", memory,
                         quant.maybe_dequant(p[name])).reshape(shape)
                 for name in ("wk_x", "wv_x"))


def _cross_core(qx, kx, vx, cfg: ModelCfg):
    return blockwise_attention(qx, kx, vx, causal=False, q_block=cfg.q_block,
                               kv_block=cfg.kv_block, vjp=cfg.attn_vjp)


def cross_attend(p, x, cfg: ModelCfg, kx, vx, seg=_call):
    """x + the cross-attention of the block's stream ``x`` over cross K/V
    (``ln_x``, ``wq_x``, non-causal blockwise attention, ``wo_x``);
    ``seg`` runs the norm and the attention."""
    b, s = x.shape[:2]
    qx = _einsum("bsd,dk->bsk", seg(rms_norm, x, p["ln_x"]),
                 quant.maybe_dequant(p["wq_x"])).reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    xo = seg(_cross_core, qx, kx, vx, cfg)
    return x + _einsum("bsk,kd->bsd", xo.reshape(b, s, -1),
                       quant.maybe_dequant(p["wo_x"]))


def _attn_block(p, x, cfg: ModelCfg, policy, seg=_call, memory=None,
                causal=True):
    """Training attention block (+MLP): causal with RoPE (M-RoPE under
    ``cfg.mrope``), or an encoder block (``causal`` False: no rotary
    embedding, no mask); an audio decoder block attends over the encoder's
    ``memory`` after its self-attention.  ``seg`` runs the parts between
    the weight products (the norms, RoPE + attention, the MLP's
    activation): called directly, or ``_recompute`` for remat "dots" (the
    MoE FFN runs outside any segment).  Returns (x, aux)."""
    h = seg(rms_norm, x, p["ln"])
    qp, kp, vp = _qkv(p, h, cfg, policy)
    ao = seg(_attn_core, qp, kp, vp, cfg, causal)
    ao = _einsum("bsk,kd->bsd", ao, _qw(policy, "attn_weights")(p["wo"]))
    x = x + ao
    if memory is not None:
        x = cross_attend(p, x, cfg, *cross_kv(p, memory, cfg), seg=seg)
    mo, aux = ffn(p, seg(rms_norm, x, p["ln2"]), cfg, policy, seg)
    return x + mo, aux


def _ssm_block(p, x, cfg: ModelCfg, policy, seg=_call):
    """Training Mamba-2 block (no FFN): norm, the SSD layer with its two
    projections through the ``mlp_weights`` hook, residual; ``seg`` runs
    the norm and the layer's part between its projections (the stream
    split, the causal conv, the chunked scan and the gated norm).  Returns
    (x, aux = 0)."""
    h = seg(rms_norm, x, p["ln"])
    y, _ = mamba2_layer(p, h, cfg, quantize_w=_qw(policy, "mlp_weights"),
                        seg=seg)
    return x + y.to(x.dtype), 0.0


def _rec_block(p, x, cfg: ModelCfg, policy, seg=_call):
    """Training Griffin recurrent block (+MLP): norm, the fused ``[wy |
    wx]`` product, the GELU gate, the causal conv, the RG-LRU scan, the
    gated ``w_out`` product, then the MLP through the ``mlp_weights`` hook.
    ``wx`` / ``wy`` / ``w_out`` and the gates pass no hook (the
    reference's ``maybe_dequant`` only); ``seg`` runs the norms, the part
    between the two products (gate, conv, the RG-LRU's gates and scan)
    and the MLP's activation.  Returns (x, aux = 0)."""
    x, _ = rec_mix(p, x, cfg, seg=seg)
    return x + _mlp(p, seg(rms_norm, x, p["ln2"]), cfg, policy, seg), 0.0


def _rec_core(yu, conv_w, rg, h0):
    """The recurrent mix between its two products: GELU gate, causal conv
    and the RG-LRU over ``yu = h @ [wy | wx]``: (y * gate, h_last)."""
    gate_in, u = torch.chunk(yu, 2, dim=-1)
    gate = torch.nn.functional.gelu(gate_in, approximate="tanh")
    y, h_last = rglru(rg, causal_conv(u, conv_w), h0=h0)
    return y * gate, h_last


def rec_mix(p, x, cfg: ModelCfg, h0=None, seg=_call):
    """The recurrent block's temporal mix and residual, before its MLP:
    (x + w_out(rglru(conv(u)) * gelu(gate)), the scan's last state (B, d)
    f32)."""
    h = seg(rms_norm, x, p["ln"])
    wyx = torch.cat([quant.maybe_dequant(p["wy"]),
                     quant.maybe_dequant(p["wx"])], dim=-1)
    yg, h_last = seg(_rec_core, _einsum("bsd,dk->bsk", h, wyx),
                     p["conv_w"], p["rglru"], h0)
    out = _einsum("bsk,kd->bsd", yg, quant.maybe_dequant(p["w_out"]))
    return x + out, h_last


def _check_remat(cfg: ModelCfg) -> None:
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"remat={cfg.remat!r}: expected none, full or dots")


def _layer(block, p_i, x, cfg: ModelCfg, policy, *extra):
    """One layer under ``cfg.remat``: in ``torch.utils.checkpoint`` for
    "full", with ``_recompute`` segments for "dots", plainly for "none"."""
    if cfg.remat == "full":
        return checkpoint(block, p_i, x, cfg, policy, _call, *extra,
                          use_reentrant=False)
    return block(p_i, x, cfg, policy,
                 _recompute if cfg.remat == "dots" else _call, *extra)


def _run_stack(params, x, cfg: ModelCfg, policy, memory=None):
    """The layer stack: a Python loop over the layers (``layer_block``),
    each layer the block of its type (an audio decoder block attends over
    ``memory``).  Under ``remat="full"`` each layer runs in
    ``torch.utils.checkpoint`` (only the block inputs are saved; the
    block recomputes in the backward).  Under ``"dots"`` the weights'
    fake-quant and the weight products (``bsd,df``) run outside any
    checkpoint, so autograd keeps the products and their operands, and
    what lies between them recomputes in ``torch.utils.checkpoint``
    segments (the reference's ``dots_with_no_batch_dims_saveable`` keeps
    the products alone and recomputes the fake-quant too): the norms,
    RoPE + attention and the MLP's activation of an attention block (an
    audio decoder block's cross-attention norm and attention too, its
    cross K/V products kept); the stream split, causal conv, chunked scan
    and gated norm of a Mamba-2 block; the GELU gate, causal conv and
    RG-LRU (its per-head gate products included) of a recurrent block."""
    blocks = {"attn": _attn_block, "ssm": _ssm_block, "rec": _rec_block}
    aux = 0.0
    for l in range(cfg.n_layers):
        btype, p_i = layer_block(params, cfg, l)
        extra = (memory,) if memory is not None else ()
        x, a = _layer(blocks[btype], p_i, x, cfg, policy, *extra)
        aux = aux + a
    return x, aux


def encode_audio(params, frames, cfg: ModelCfg, policy):
    """The audio encoder: ``frames`` (B, enc_seq, d) plus the sinusoid
    positions, in the model's dtype, through the ``enc_layers`` encoder
    blocks (non-causal, no RoPE, weights through the policy's hook), then
    ``enc_norm``: the memory (B, enc_seq, d) the decoder attends over."""
    pe = sinusoid_positions(frames.shape[1], cfg.d_model, frames.device)
    x = frames.to(cfg.dtype) + pe.to(cfg.dtype)
    for l in range(cfg.enc_layers):
        p = layer_params(params["enc_blocks"][0], l)
        x, _ = _layer(_attn_block, p, x, cfg, policy, None, False)
    return rms_norm(x, params["enc_norm"])


def forward(params, batch, cfg: ModelCfg, policy: TCPolicy = BF16):
    """Training / scoring forward: returns (logits (B, S, vocab_pad),
    aux_loss): the MoE layers' summed load-balancing loss, 0 for the other
    families.  A vlm batch may carry ``embeds`` in place of ``tokens``;
    an audio batch carries ``frames``, which the encoder turns into the
    decoder's cross-attention memory."""
    _check_remat(cfg)
    if cfg.family == "vlm" and "embeds" in batch:
        x = batch["embeds"].to(cfg.dtype)
    else:
        emb_q = policy.quantize_weight(params["embed"], "embed_weights")
        x = emb_q[batch["tokens"]].to(cfg.dtype)
    memory = (encode_audio(params, batch["frames"], cfg, policy)
              if cfg.family == "audio" else None)
    x, aux = _run_stack(params, x, cfg, policy, memory)
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
    layer scan does, and written into one tensor allocated for the whole
    stacked leaf (a tail block's leaves, unstacked, are quantized whole);
    a leaf the policy leaves as it is stays the same tensor.  MoE expert
    weights are quantized a layer's whole (E, ...) slice at a time (one
    scale per output column over the expert and input axes, as the
    reference's per-call hook sees them); the router passes no hook and
    stays as it is.  An SSM block's two projections (``in_proj``,
    ``out_proj``) pass the ``mlp_weights`` hook; its conv taps and f32
    leaves pass none and stay raw.  A recurrent block's MLP (``wi``,
    ``wo_mlp``) passes the ``mlp_weights`` hook; ``wx``, ``wy``,
    ``w_out``, the conv taps and the RG-LRU's leaves pass none on the
    reference's serving path and stay raw.  An audio model's encoder
    blocks (``enc_blocks``) are hoisted as the decoder's attention blocks
    are; the cross-attention weights (``*_x``) pass no hook and stay
    raw."""
    q_attn, q_mlp = _qw(policy, "attn_weights"), _qw(policy, "mlp_weights")

    def per_layer(q, w):
        first = w[0]
        q0 = q(first)
        if q0 is first:             # no format for the role: no copy
            return w
        out = torch.empty((w.shape[0],) + tuple(q0.shape), dtype=q0.dtype,
                          device=q0.device)
        out[0] = q0
        del q0
        for i in range(1, w.shape[0]):
            out[i] = q(w[i])
        return out

    def hoist(blk, each):
        nb = dict(blk)
        if "in_proj" in blk:
            names, q = ("in_proj", "out_proj"), q_mlp
        elif "rglru" in blk:
            names, q = ("wi", "wo_mlp"), q_mlp
        else:
            for name in ("wq", "wk", "wv", "wo"):
                nb[name] = each(q_attn, blk[name])
            if "moe" in blk:
                nb["moe"] = dict(blk["moe"], **{
                    name: each(q_mlp, blk["moe"][name])
                    for name in ("wi", "wo")})
                return nb
            names, q = ("wi", "wo_mlp"), q_mlp
        for name in names:
            nb[name] = each(q, blk[name])
        return nb

    out = dict(params)
    if "lm_head" in params:
        out["embed"] = policy.quantize_weight(params["embed"],
                                              "embed_weights")
    # else tied: the serving head reads the raw table (the reference's
    # does), so it stays raw here and the lookup quantizes its rows
    # (``embed_rows`` under ``weights_free(policy, tied=True)``)
    out["blocks"] = tuple(hoist(blk, per_layer) for blk in params["blocks"])
    if "tail" in params:
        out["tail"] = tuple(hoist(blk, _call) for blk in params["tail"])
    if "enc_blocks" in params:
        out["enc_blocks"] = tuple(hoist(blk, per_layer)
                                  for blk in params["enc_blocks"])
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
