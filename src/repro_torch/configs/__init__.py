"""Architecture registry: ``get_config(arch, smoke=...)`` under the
reference's arch ids.  Each module defines ``full()`` (the published
config) and ``smoke()`` (a reduced same-family config for CPU tests).
Every family of the reference is ported: dense, MoE, SSM, hybrid, vlm
and audio."""
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
    "qwen2-vl-2b": "qwen2_vl_2b",
    "whisper-large-v3": "whisper_large_v3",
    # the paper's own deployment target
    "paper-edge": "paper_edge",
}

# archs of families this port does not carry yet, by family: none left
# (the name stays for the callers that list the registry)
UNPORTED: dict = {}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.smoke() if smoke else mod.full()
