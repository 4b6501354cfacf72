"""Meta-tensor stand-ins for every model input (dry run, no allocation;
port of ``repro.launch.specs``).

``input_specs(cfg, shape)`` -> dict of meta tensors for train/prefill;
``decode_specs`` additionally builds the cache on the meta device,
pre-sized to ``seq_len`` (the assigned decode cells serve one new token
against a cache of seq_len).  Modality frontends are stubbed per the
assignment: vlm gets patch embeddings, audio gets precomputed mel-frame
embeddings.  The shapes and dtypes are the reference's.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs import ShapeSpec
from ..core.transprecision import BF16
from ..models.lm import ModelCfg
from ..models.serve_model import init_cache


def sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: shape and dtype, no storage."""
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelCfg, spec: ShapeSpec) -> Dict[str, Any]:
    """Training / prefill inputs for one assigned (arch x shape) cell."""
    b, s = spec.global_batch, spec.seq_len
    out: Dict[str, Any] = {}
    if cfg.family == "vlm":
        # patch/frame embeddings from the (stubbed) vision frontend
        out["embeds"] = sds((b, s, cfg.d_model), torch.bfloat16)
    else:
        out["tokens"] = sds((b, s), torch.int32)
    if cfg.family == "audio":
        out["frames"] = sds((b, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if spec.kind == "train":
        out["labels"] = sds((b, s), torch.int32)
    return out


def decode_specs(cfg: ModelCfg, spec: ShapeSpec,
                 policy=None) -> Tuple[Any, Any]:
    """(meta cache, token spec) for the single-token serve step: (b, 1)
    token ids, or (b, 1, d) bf16 embeddings for a vlm stack."""
    b, s = spec.global_batch, spec.seq_len
    cache = init_cache(cfg, b, s, policy=policy or BF16, device="meta")
    if cfg.family == "vlm":
        tok = sds((b, 1, cfg.d_model), torch.bfloat16)   # embeds path
    else:
        tok = sds((b, 1), torch.int32)
    return cache, tok
