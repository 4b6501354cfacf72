"""Architecture registry: ``get_config(arch, smoke=...)`` under the
reference's arch ids.  Each module defines ``full()`` (the published
config) and ``smoke()`` (a reduced same-family config for CPU tests).
The dense, MoE, SSM and hybrid families are ported; the archs of the
other families (vlm, audio) are registered by name and raise
``NotImplementedError``."""
from __future__ import annotations

import importlib

_MODULES = {
    "llama3-8b": "llama3_8b",
    "granite-3-8b": "granite_3_8b",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-15b": "starcoder2_15b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    # the paper's own deployment target
    "paper-edge": "paper_edge",
}

# archs of families this port does not carry yet, by family
UNPORTED = {
    "qwen2-vl-2b": "vlm",
    "whisper-large-v3": "audio",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch in UNPORTED:
        raise NotImplementedError(
            f"arch {arch!r} ({UNPORTED[arch]} family) is not ported yet "
            f"(this port carries {sorted(_MODULES)}; the other families "
            "are a later slice)")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(UNPORTED)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.smoke() if smoke else mod.full()
