"""Transprecision-computing (TC) policy engine (port of
``repro.core.transprecision``).

A policy names the format of each tensor role (attention/MLP/embedding
weights, KV cache, ...), with layer- and node-level overrides.  The weight
hook ``quantize_weight`` runs on every matmul weight: fake-quant through
the role's format, or decode-on-load for packed ``QuantizedTensor``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import quant
from .formats import POSIT4_1, POSIT8_2, POSIT16_2, PositFormat, get


@dataclasses.dataclass(frozen=True)
class TCPolicy:
    """Transprecision policy. ``None`` for a role means full precision."""

    name: str = "bf16"
    attn_weights: Optional[str] = None
    mlp_weights: Optional[str] = None
    embed_weights: Optional[str] = None
    activations: Optional[str] = None
    kv_cache: Optional[str] = None
    grad_wire: Optional[str] = None
    ssm_state: Optional[str] = None
    # layer granularity: ((layer_idx, role, fmt), ...)
    layer_overrides: Tuple[Tuple[int, str, str], ...] = ()
    # node granularity: ((op_name, fmt), ...)
    node_overrides: Tuple[Tuple[str, str], ...] = ()
    # serving: store the KV cache as packed posit codes (decode-on-read)
    packed_kv: bool = False
    # serving KV-cache storage format: one of KV_FORMATS, or None (defer to
    # the legacy (packed_kv, kv_cache) pair, else model-dtype floats)
    kv_format: Optional[str] = None
    # serving KV-cache layout: "ring" (this port) or "paged"
    kv_layout: str = "ring"
    kv_page_size: int = 16

    def fmt_for(self, role: str, layer: Optional[int] = None,
                node: Optional[str] = None) -> Optional[str]:
        if node is not None:
            for op_name, f in self.node_overrides:
                if op_name == node:
                    return f
        if layer is not None:
            for li, r, f in self.layer_overrides:
                if li == layer and r == role:
                    return f
        return getattr(self, role)

    def quantize_weight(self, w, role: str, layer=None, node=None):
        """Weight hook on every matmul: decode-on-load for a packed
        QuantizedTensor, else fake-quant (per output channel, the last
        axis) through the role's format."""
        if isinstance(w, quant.QuantizedTensor):
            return w.dequantize(torch.bfloat16)
        f = self.fmt_for(role, layer, node)
        if f is None:
            return w
        return quant.fake_quant(w, f, axis=tuple(range(w.ndim - 1)))


# ---------------------------------------------------------------------------
# KV-cache storage resolution
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVStorage:
    """Resolved serving KV-cache storage: a float dtype OR packed posit.

    ``fmt`` set -> the cache ring holds posit codes + a per-row (token x
    head) f32 power-of-two scale; ``packed`` nibble-packs sub-byte codes
    two-per-byte.  ``fmt`` None -> plain float storage in ``dtype``.
    """

    name: str
    fmt: Optional[PositFormat] = None
    dtype_name: Optional[str] = None
    packed: bool = False

    @property
    def is_posit(self) -> bool:
        return self.fmt is not None

    @property
    def dtype(self) -> torch.dtype:
        return {"f32": torch.float32, "bf16": torch.bfloat16}[self.dtype_name]

    def bytes_per_value(self, head_dim: int) -> float:
        """Device bytes per cached K/V element, scale overhead amortized."""
        if self.fmt is None:
            return {"f32": 4.0, "bf16": 2.0}[self.dtype_name]
        itemsize = self.fmt.storage_dtype.itemsize
        code = itemsize / 2.0 if self.packed else float(itemsize)
        return code + 4.0 / head_dim


KV_FORMATS = {
    "f32": KVStorage("f32", dtype_name="f32"),
    "bf16": KVStorage("bf16", dtype_name="bf16"),
    "posit16": KVStorage("posit16", fmt=POSIT16_2),
    "posit8": KVStorage("posit8", fmt=POSIT8_2),
    "posit4": KVStorage("posit4", fmt=POSIT4_1, packed=True),
}


def kv_storage(policy: Optional[TCPolicy]) -> Optional[KVStorage]:
    """Resolve a policy's KV-cache storage; None means model-dtype floats.

    Precedence: explicit ``kv_format`` > legacy ``packed_kv`` + posit
    ``kv_cache`` role > None.
    """
    if policy is None:
        return None
    if policy.kv_format is not None:
        if policy.kv_format not in KV_FORMATS:
            raise KeyError(f"unknown kv_format {policy.kv_format!r}; "
                           f"known: {sorted(KV_FORMATS)}")
        return KV_FORMATS[policy.kv_format]
    if policy.packed_kv and policy.kv_cache:
        f = get(policy.kv_cache)
        if isinstance(f, PositFormat):
            return KVStorage(f.name, fmt=f, packed=f.bits < 8)
    return None


def draft_policy(policy: "TCPolicy", weights_fmt: str = "posit8_2",
                 kv_format: str = "posit8") -> "TCPolicy":
    """The low-precision *draft* policy of self-speculative decoding: the
    same weights through posit8 (``weights_fmt``) and a posit8 KV ring
    (``kv_format``).  The draft cache is always a ring (private, rolled
    back wholesale, never shared) and overrides are dropped: the draft is
    uniformly cheap."""
    base = get_policy(policy)
    return dataclasses.replace(
        base,
        name=f"{base.name}+draft_{kv_format}",
        attn_weights=weights_fmt,
        mlp_weights=weights_fmt,
        embed_weights=base.embed_weights or "posit16_2",
        kv_format=kv_format,
        kv_layout="ring",
        packed_kv=False,
        layer_overrides=(),
        node_overrides=(),
    )


# ---------------------------------------------------------------------------
# Presets
# ---------------------------------------------------------------------------

# Full precision (baseline)
BF16 = TCPolicy(name="bf16")

# The paper's edge configuration: "Posit P(8,2) is exclusively used for
# vector operations, as this configuration is most used for DNNs deployed on
# edge devices" (§IV-D).
PAPER_EDGE = TCPolicy(
    name="paper_edge_p8",
    attn_weights="posit8_2",
    mlp_weights="posit8_2",
    embed_weights="posit16_2",
    kv_cache="posit8_2",
)

# Mixed transprecision: wider formats where sensitivity is high.
MIXED_TC = TCPolicy(
    name="mixed_tc",
    attn_weights="posit8_2",
    mlp_weights="posit8_2",
    embed_weights="posit16_2",
    kv_cache="posit16_2",
    grad_wire="posit16_2",
)

# INT8 weight-only (the TALU INT mode)
INT8_W = TCPolicy(name="int8_w", attn_weights="int8", mlp_weights="int8",
                  embed_weights="int8")

# FP8 weight-only (the TALU FP mode)
FP8_W = TCPolicy(name="fp8_w", attn_weights="fp8_e4m3", mlp_weights="fp8_e4m3",
                 embed_weights="fp8_e4m3")

# Packed posit serving: weights AND KV cache stored as posit codes
SERVE_P8 = TCPolicy(name="serve_posit8",
                    attn_weights="posit8_2", mlp_weights="posit8_2",
                    kv_cache="posit8_2", packed_kv=True)
SERVE_P16 = TCPolicy(name="serve_posit16",
                     attn_weights="posit16_2", mlp_weights="posit16_2",
                     kv_cache="posit16_2", packed_kv=True)

PRESETS = {p.name: p for p in [BF16, PAPER_EDGE, MIXED_TC, INT8_W, FP8_W,
                               SERVE_P8, SERVE_P16]}


def get_policy(name) -> TCPolicy:
    if isinstance(name, TCPolicy):
        return name
    if name not in PRESETS:
        raise KeyError(f"unknown TC policy {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]


def hbm_bytes_per_param(policy: TCPolicy, role: str = "mlp_weights",
                        default: float = 2.0) -> float:
    """Storage bytes per parameter of ``role`` under ``policy``: its
    format's bits / 8, or ``default`` for a full-precision role (bf16, as
    the reference; the energy accountant passes the served tensor's own
    item size)."""
    f = getattr(policy, role)
    return (get(f).bits / 8.0) if f else default


# ---------------------------------------------------------------------------
# Packed-parameter conversion (serving)
# ---------------------------------------------------------------------------

_ROLE_BY_NAME = {
    "wq": "attn_weights", "wk": "attn_weights", "wv": "attn_weights",
    "wo": "attn_weights", "wi": "mlp_weights", "wo_mlp": "mlp_weights",
}


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def pack_params(params, policy: TCPolicy):
    """Convert matrix weight leaves to packed posit QuantizedTensors per the
    policy's role formats (embeddings, norms and vectors stay unpacked).

    Stacked ``blocks`` leaves keep their leading stack axis in the scale;
    output projections (``wo``, ``wo_mlp``) scale per input row, the rest
    per output column, as in the reference."""

    def pack(path, w):
        name = next((k for k in reversed(path) if isinstance(k, str)), None)
        role = _ROLE_BY_NAME.get(name)
        if role is None or w.ndim < 2:
            return w
        f = policy.fmt_for(role)
        if f is None or not isinstance(get(f), PositFormat):
            return w
        stacked = path[0] == "blocks" and w.ndim >= 3
        ch = w.ndim - 2 if name in ("wo", "wo_mlp") else w.ndim - 1
        keep = {ch} | ({0} if stacked else set())
        axis = tuple(i for i in range(w.ndim) if i not in keep)
        return quant.quantize(w, get(f), axis=axis)

    return _map_with_path(pack, params)
