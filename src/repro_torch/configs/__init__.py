"""Architecture registry: ``get_config(arch, smoke=...)`` under the
reference's arch ids.  Each module defines ``full()`` (the published
config) and ``smoke()`` (a reduced same-family config for CPU tests).
Every family of the reference is ported: dense, MoE, SSM, hybrid, vlm
and audio.

``SHAPES`` carries the four assigned input shapes; ``cells()`` yields the
(arch x shape) dry-run cells with the sub-quadratic skip rule applied
(long_500k runs only for recurrent-state families), as the reference's
registry does.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Iterable, Tuple

_MODULES = {
    "llama3-8b": "llama3_8b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-15b": "starcoder2_15b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-large-v3": "whisper_large_v3",
    # the paper's own deployment target
    "paper-edge": "paper_edge",
}

# archs of families this port does not carry yet, by family: none left
# (the name stays for the callers that list the registry)
UNPORTED: dict = {}

ARCHS = tuple(_MODULES)
# the assigned archs of the dry-run matrix, in the reference's order (the
# paper's own paper-edge is not one of the 40 assigned cells)
ASSIGNED = ("mamba2-2.7b", "llama3-8b", "granite-3-8b", "qwen3-4b",
            "starcoder2-15b", "qwen2-vl-2b", "recurrentgemma-9b",
            "phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m",
            "whisper-large-v3")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

# families with O(1)-state decode can run the 500k cell
SUBQUADRATIC = ("ssm", "hybrid")


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.smoke() if smoke else mod.full()


def shape_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runs?, reason-if-skip) for an (arch x shape) cell."""
    cfg = get_config(arch)
    spec = SHAPES[shape]
    if spec.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, ("full-attention family: 500k-token KV decode is "
                       "quadratic-cost/O(seq) memory; skipped per assignment "
                       "(DESIGN.md §Arch-applicability)")
    return True, ""


def cells(archs: Iterable[str] = ASSIGNED):
    """(arch, shape, runs?, reason) for every (arch x shape) cell; the
    default is the 40 assigned cells."""
    for arch in archs:
        for shape in SHAPES:
            ok, why = shape_applicable(arch, shape)
            yield arch, shape, ok, why
