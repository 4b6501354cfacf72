"""Shared model components: init, RMSNorm, the causal depthwise conv
(Mamba-2's and the recurrent block's), RoPE and M-RoPE, Whisper's
sinusoid positions, the training loss, and the logical-axis sharding
rules (port of ``repro.models.common``).

Sharding is written as plain spec trees: a ``P`` holds one mesh axis name
(or a tuple of them, or None) per dim.  The reference's ``constrain`` is a
compiler hint with no counterpart in eager torch; the port has no
tensor-parallel path for it to steer yet."""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..launch import op_cost


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with JAX's type promotion (bf16 x f32 -> f32).  On the CPU
    each operand's free dims (the rows or the columns of the GEMM it
    becomes) are zero-padded to at least ``_MIN_ROWS`` and the padding cut
    from the result, so that a row's bits do not depend on how many rows
    share the call (:func:`_einsum_rows_fixed`); not while the op counter
    counts (``launch.op_cost.counting``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    a, b = a.to(dt), b.to(dt)
    if a.device.type != "cpu" or op_cost.counting():
        return torch.einsum(eq, a, b)
    return _einsum_rows_fixed(eq, a, b)


# MKL's SGEMM runs the last rows (columns) of a call through edge kernels
# that sum K in another order than its full tiles: on one and two threads
# a row of a 1-3 row call (1-11 at two threads, less multiples of 4) or a
# column of a call under 12 columns gets other bits than the same row of a
# larger call.  XLA's CPU dot of a 2-D product gives every row the same
# bits whatever the count, those of torch's large calls where K <= 128.
# 16 rows put every call on the full tiles (tests/test_torch_rowcount.py
# sweeps it).
_MIN_ROWS = 16


def _ellipsis_dims(spec: str, ndim: int) -> int:
    return ndim - (len(spec) - 3) if "..." in spec else 0


def _einsum_rows_fixed(eq: str, a: torch.Tensor, b: torch.Tensor):
    """``torch.einsum(eq, a, b)`` with each operand's free dims (those of
    one operand that reach the output) zero-padded to ``_MIN_ROWS`` rows
    along its last free dim, and the padding cut from the result.  A
    padded row is zeros: it reads the other operand's values but lands
    only in the cut part."""
    lhs, out = eq.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    # spell a broadcast ``...`` out in capitals, right-aligned
    na, nb = _ellipsis_dims(sa, a.ndim), _ellipsis_dims(sb, b.ndim)
    ell = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"[:max(na, nb)]
    sa = sa.replace("...", ell[len(ell) - na:])
    sb = sb.replace("...", ell[len(ell) - nb:])
    out = out.replace("...", ell)
    cut = []
    ops = [a, b]
    for i, (s, o) in enumerate(((sa, sb), (sb, sa))):
        x = ops[i]
        free = [d for d, c in enumerate(s) if c in out and c not in o]
        rows = math.prod(x.shape[d] for d in free)
        if not free or rows == 0 or rows >= _MIN_ROWS:
            continue
        d = free[-1]
        n = x.shape[d]
        pad = -(-_MIN_ROWS * n // rows) - n
        ops[i] = torch.cat([x, x.new_zeros(x.shape[:d] + (pad,)
                                           + x.shape[d + 1:])], dim=d)
        cut.append((out.index(s[d]), n))
    y = torch.einsum(f"{sa},{sb}->{out}", *ops)
    if not cut:
        return y
    for dim, n in cut:
        y = y.narrow(dim, 0, n)
    return y.contiguous()


def _call(f, *args):
    """A block's ``seg`` when nothing is recomputed: call ``f`` directly
    (``lm._recompute`` is the remat "dots" one)."""
    return f(*args)


# ---------------------------------------------------------------------------
# Logical-axis sharding rules
# ---------------------------------------------------------------------------
# logical axes used by the models:
#   "batch"   — global batch            -> ("pod","data") typically
#   "seq"     — sequence                -> None or "model" (SP)
#   "heads"   — attention heads         -> "model" when divisible
#   "kv_seq"  — cache sequence          -> "model" for distributed decode
#   "ffn"     — d_ff                    -> "model"
#   "vocab"   — vocabulary              -> "model"
#   "expert"  — MoE experts             -> "model"

def _axis_entry(a):
    """One dim's entry, canonical as ``jax.sharding.PartitionSpec`` keeps
    it: a sequence of one name is the name, an empty one None."""
    if isinstance(a, (tuple, list)):
        return None if not a else a[0] if len(a) == 1 else tuple(a)
    return a


class P(tuple):
    """A partition spec: per dim a mesh axis name, a tuple of names, or
    None (replicated); trailing dims left out are replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, (_axis_entry(a) for a in axes))

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists, with the
    reference's path strings (keys and indices joined by "/"); a
    ``QuantizedTensor`` and a ``P`` are one leaf each."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, f"{path}/{i}" if path
                                        else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


# a decode cache's attention K/V leaves (codes or values, and their
# scales): the leaves that run along the KV sequence
KV_LEAVES = ("k", "v", "k_scale", "v_scale")
# a decode cache's recurrent leaves, which "model" splits: the dim in the
# leaf's per-layer shape, and what it counts
RECURRENT_SPLIT = {"state": (1, "SSD heads"),       # (B, nh, hd, ds)
                   "conv": (2, "conv channels"),    # (B, K-1, ch)
                   "h": (1, "RG-LRU channels")}     # (B, width)


def rank_split(path: str, paged: bool) -> Optional[Tuple[int, str, str]]:
    """How a rank of the distributed decode holds a decode-cache leaf (by
    its ``map_with_path`` path), as ``launch.mesh.cache_specs`` shards it:
    (dim, mesh axis, what the dim counts) for a leaf a rank holds a slice
    of, one further under a period-stacked ``blocks`` leaf; None for a
    leaf whole on every rank (``pos``, the page table, cross K/V,
    ``memory``).  "kv_seq": a K/V ring's W in (B, W, nkv[, hd]) or a
    pool's flat rows R in (R, nkv[, hd]); "model": the Mamba-2 state's
    heads, its conv's channels, the RG-LRU ``h``'s and its conv's
    width."""
    name = path.split("/")[-1]
    lead = 1 if path.startswith("blocks") else 0
    if name in KV_LEAVES:
        return (lead + (0 if paged else 1), "kv_seq",
                "pool pages" if paged else "ring rows")
    if name in RECURRENT_SPLIT:
        dim, what = RECURRENT_SPLIT[name]
        return lead + dim, "model", what
    return None


_RULES: contextvars.ContextVar = contextvars.ContextVar("axis_rules",
                                                        default=None)


@contextlib.contextmanager
def axis_rules(rules: Optional[dict]):
    """Install logical -> mesh axis rules (launcher only)."""
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def logical_to_spec(names: Sequence[Optional[str]]) -> P:
    """The installed rules applied to one logical name (or None) per dim."""
    rules = _RULES.get() or {}
    return P(*[rules.get(n) if n else None for n in names])


# ---------------------------------------------------------------------------
# Initializers: truncated normal in +-2 sigma, as in the reference
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std: float, dtype, device,
                  generator: Optional[torch.Generator]):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(shape, dtype, device, generator=None, in_axis: int = -2):
    """sigma = fan_in^-1/2 with fan_in = shape[in_axis]."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return _trunc_normal(shape, 1.0 / math.sqrt(fan_in), dtype, device,
                         generator)


def embed_init(shape, dtype, device, generator=None):
    """sigma = 0.02."""
    return _trunc_normal(shape, 0.02, dtype, device, generator)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32 with a ``(1 + scale)`` gain, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    inv = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (x32 * inv * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm in f32 (mean and variance over the last axis), cast back
    to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return ((x - mu) * torch.rsqrt(var + eps) * scale + bias).to(dt)


def causal_conv(u, conv_w):
    """Depthwise causal conv along S, summed tap by tap as the reference
    sums it: u (B, S, C), conv_w (K, C) -> (B, S, C)."""
    k, s = conv_w.shape[0], u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    return sum(pad[:, i:i + s] * conv_w[i] for i in range(k))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, positions):
    """positions: (..., S) int -> cos/sin (..., S, d_head/2) f32."""
    half = d_head // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions.device) / half))
    ang = positions.to(torch.float32)[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, h, d); cos/sin: (B, S, d/2) or (S, d/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_freqs(d_head: int, theta: float, positions_3d,
                sections=(16, 24, 24)):
    """Qwen2-VL M-RoPE: the rotary half splits into (temporal, height,
    width) sections, each rotated by its own position stream.
    positions_3d: (3, B, S) int -> cos/sin (B, S, d_head/2) f32.  With the
    frontend stubbed all three streams carry the text position, which
    gives 1-D RoPE's values exactly."""
    half = d_head // 2
    assert sum(sections) == half, (sections, half)
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=positions_3d.device) / half))
    coss, sins = [], []
    off = 0
    for i, sec in enumerate(sections):
        ang = positions_3d[i].to(torch.float32)[..., None] * inv[off:off + sec]
        coss.append(torch.cos(ang))
        sins.append(torch.sin(ang))
        off += sec
    return torch.cat(coss, -1), torch.cat(sins, -1)


def sinusoid_positions(seq: int, dim: int, device=None):
    """Whisper's fixed sinusoid embeddings (S, d) f32, computed in numpy
    float64 as the reference computes them."""
    pos = np.arange(seq)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def cross_entropy(logits, labels, vocab: int):
    """Mean CE over valid labels (label == -1 masked); logits may be padded
    beyond ``vocab`` and the pad region is masked.  logsumexp in f32."""
    vpad = logits.shape[-1]
    if vpad > vocab:
        pad = torch.arange(vpad, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e9)
    valid = labels >= 0
    labels_c = labels.clamp(0, vocab - 1).to(torch.int64)
    l32 = logits.to(torch.float32)
    logz = torch.logsumexp(l32, dim=-1)
    gold = torch.gather(l32, -1, labels_c[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
