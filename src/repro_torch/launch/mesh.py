"""Production mesh + sharding rules as plain spec trees (port of
``repro.launch.mesh``).

A mesh here is a record of named axis sizes: building one touches no
device and no process group.  The specs say what is sharded where:
  * logical-axis rules (installed via ``models.common.axis_rules``), and
  * param/opt/batch/cache ``P`` builders keyed off leaf names — 2-D
    sharding: matrix input dims -> "data" (FSDP), output dims -> "model"
    (TP), experts -> "model" (EP), KV-cache sequence -> "model".

The port runs one of them: the dims ``cache_specs`` splits (the "kv_seq"
dims and the recurrent state's "model" dims, ``models.common.rank_split``)
are what a rank of the distributed decode (``serve/distributed.py``) holds
a slice of (``models.serve_model.init_cache(..., kv_shard=)``), with the
"model" axis as the ranks.  A paged pool, which
the reference's rule does not cover (its leaves have no batch axis),
shards its flat rows on "kv_seq".
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

from ..models.common import P, map_with_path, rank_split
from ..models.lm import ModelCfg


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named axis sizes, as ``jax.sharding.Mesh`` exposes them
    (``axis_names``, ``shape[name]``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Mapping[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_host_mesh(world: int = 1, *, model: bool = False) -> MeshShape:
    """``world`` ranks as a 1-D data mesh (CPU tests, examples), or with
    ``model`` as the "model" axis: the ranks of one host's distributed
    decode, each holding the whole batch and 1/world of the split
    state."""
    return MeshShape(("data", "model"), (1, world) if model else (world, 1))


# ---------------------------------------------------------------------------
# Logical-axis rules
# ---------------------------------------------------------------------------

def _batch_rule(mesh, global_batch: int):
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    bsz = math.prod(mesh.shape[a] for a in batch_axes)
    return batch_axes if global_batch % bsz == 0 else None


def train_rules(mesh, *, global_batch: int, seq_shard: bool = True,
                heads_shard: bool = False) -> Dict[str, Any]:
    return {
        "batch": _batch_rule(mesh, global_batch),
        "seq": "model" if seq_shard else None,   # sequence-parallel residual
        "heads": "model" if heads_shard else None,
        "ffn": "model",
        "vocab": "model",
        "expert": "model",
        "kv_seq": "model",
    }


def serve_rules(mesh, *, global_batch: int) -> Dict[str, Any]:
    return {
        "batch": _batch_rule(mesh, global_batch),
        "seq": None,
        "heads": None,
        "ffn": "model",
        "vocab": "model",
        "expert": "model",
        "kv_seq": "model",
    }


# ---------------------------------------------------------------------------
# Param / optimizer / batch / cache specs
# ---------------------------------------------------------------------------

# weight-leaf name -> (spec for the trailing dims); leading stack axes get None
_MAT_IN_OUT = {"wq", "wk", "wv", "wi", "wx", "wy", "in_proj", "w_a", "w_x",
               "wq_x", "wk_x", "wv_x"}
_MAT_OUT_IN = {"wo", "wo_mlp", "w_out", "out_proj", "wo_x"}


def _leaf_spec(path: str, shape, fsdp, model) -> P:
    """Trailing-dims partition for one param leaf (by its dict key name)."""
    parts = path.split("/")
    name = parts[-1]
    nd = len(shape)
    # packed QuantizedTensor leaves: codes shard like the weight itself,
    # per-channel scales shard on their (last) channel dim
    if name == "data" and len(parts) >= 2:
        name = parts[-2]
    elif name == "scale":
        parent = parts[-2] if len(parts) >= 2 else ""
        last = model if (parent in _MAT_IN_OUT or parent in _MAT_OUT_IN
                         or parent in ("wi", "wo")) else None
        if parent in _MAT_OUT_IN:   # output dim is the param's fsdp dim
            last = fsdp
        return P(*([None] * (nd - 1)), last)
    if name == "embed":                       # (vocab, d)
        return P(model, fsdp)
    if name == "lm_head":                     # (d, vocab)
        return P(fsdp, model)
    if name == "router":                      # (d, E) — replicate E (tiny)
        return P(*([None] * (nd - 2)), fsdp, None)
    if name in ("wi", "wo") and nd >= 3 and "moe" in path:
        # MoE expert weights (E, d, f) / (E, f, d): experts on model (EP)
        lead = [None] * (nd - 3)
        if name == "wi":
            return P(*lead, model, fsdp, None)
        return P(*lead, model, None, fsdp)
    if name == "conv_w":                      # (K, ch): channels follow model
        return P(*([None] * (nd - 1)), model)
    if name in _MAT_IN_OUT and nd >= 2:
        return P(*([None] * (nd - 2)), fsdp, model)
    if name in _MAT_OUT_IN and nd >= 2:
        return P(*([None] * (nd - 2)), model, fsdp)
    # vectors/norms/scalars (ln, *_norm, A_log, D, dt_bias, Lambda, b_*)
    return P(*([None] * nd))


def param_specs(params, *, fsdp: Optional[str] = "data",
                model: Optional[str] = "model"):
    """Spec tree matching ``lm.init_params`` (the meta device builds one
    without memory).  MoE expert weights live under a "moe" key so the EP
    rule finds them; everything else dispatches on the leaf name.
    ``fsdp=None`` replicates the weight input dims (serving mode).  A
    packed ``QuantizedTensor`` gets ONE spec, from its codes' shape."""
    return map_with_path(
        lambda path, leaf: _leaf_spec(path, leaf.shape, fsdp, model), params)


def opt_specs(pspecs):
    """Optimizer-state specs: every moment/master leaf shards like its
    param."""
    return {"step": P(), "mu": pspecs, "nu": pspecs, "master": pspecs}


def batch_specs(cfg: ModelCfg, rules: Dict[str, Any], keys=None):
    b = rules.get("batch")
    out = {"tokens": P(b, None), "labels": P(b, None),
           "embeds": P(b, None, None), "frames": P(b, None, None)}
    if keys is None:
        keys = {"tokens", "labels"}
        if cfg.family == "vlm":
            keys = {"embeds", "labels"}
        if cfg.family == "audio":
            keys |= {"frames"}
    return {k: out[k] for k in keys}


def cache_specs(cache, cfg: ModelCfg, rules: Dict[str, Any]):
    """Decode-cache specs: KV sequence on ``rules["kv_seq"]``, the
    recurrent state's heads, channels and width on "model", batch on
    ``rules["batch"]`` (``models.common.rank_split`` names each split
    dim).  A paged cache (one with a ``page_table``) shards its pools'
    flat rows (P, R, nkv, Dc|hd) on the KV axis, and keeps the page table
    replicated."""
    b = rules.get("batch")
    axis_of = {"kv_seq": rules.get("kv_seq"), "model": "model"}
    paged = "page_table" in cache

    def spec(path: str, leaf) -> P:
        name = path.split("/")[-1]
        nd = len(leaf.shape)
        lead = (None,) if path.startswith("blocks") else ()   # period stack
        if name == "pos":
            return P()
        if name == "memory":                  # (B, enc_seq, d)
            return P(b, None, None)
        if name in ("xk", "xv"):              # (B, enc_seq, nkv, hd)
            return P(*lead, b, None, None, None)
        split = rank_split(path, paged)
        if split is None:
            return P(*([None] * nd))
        axes = [None] * nd      # ring (B, W, nkv[, hd]); pool (R, nkv[, hd]);
        axes[split[0]] = axis_of[split[1]]  # state, conv, h: (B, ...)
        if not (paged and split[1] == "kv_seq"):
            axes[len(lead)] = b
        return P(*axes)

    return map_with_path(spec, cache)
