"""Architecture registry: ``get_config(arch, smoke=...)``.  This slice of
the port carries the dense ``paper-edge`` model only."""
from __future__ import annotations

from . import paper_edge

_MODULES = {"paper-edge": paper_edge}


def get_config(arch: str, smoke: bool = False):
    if arch not in _MODULES:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (this slice carries "
            f"{sorted(_MODULES)}; the other families are a later slice)")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.full()
