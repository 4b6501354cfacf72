"""What the ablation scripts (``k1_ablation.py``, ``k5_ablation.py``,
``k7_ablation.py``) share: variants of the port's CUDA libraries built from
patched copies of their sources, and the switch that makes the wrappers
call one variant.

A variant is a list of (text, replacement) pairs.  Each text must occur
exactly once in the copied sources (every ``.cuh`` header and the ``.cu``
files of the libraries built), so a patch that no longer matches stops the
script instead of timing the unpatched kernel.  Needs the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(tag: str, variants: dict, libs, csrc: Path = None) -> dict:
    """Build the libraries ``libs`` of every variant, one ``nvcc`` each, all
    at once, into ``build/<tag>/<variant>/`` (the ptxas report in
    ``<lib>.log`` there).  ``csrc`` is the source directory (default: this
    checkout's).  Returns {variant: {lib: path of the shared library}}."""
    from repro_torch.kernels import _build
    csrc = Path(csrc or _build.CSRC)
    paths, procs = {}, []
    for variant, patches in variants.items():
        files = {p.name: p.read_text() for p in csrc.glob("*.cuh")}
        files.update({f"{lib}.cu": (csrc / f"{lib}.cu").read_text()
                      for lib in libs})
        for text, repl in patches:
            hits = [f for f, src in files.items() if text in src]
            if len(hits) != 1 or files[hits[0]].count(text) != 1:
                raise RuntimeError(f"{tag}: {text!r} is not once in the "
                                   f"sources; update the variant {variant}")
            files[hits[0]] = files[hits[0]].replace(text, repl)
        out = _build.BUILD_ROOT / tag / variant
        out.mkdir(parents=True, exist_ok=True)
        for f, src in files.items():
            (out / f).write_text(src)
        paths[variant] = {lib: out / f"lib{lib}.so" for lib in libs}
        for lib in libs:
            log = out / f"{lib}.log"
            with open(log, "w") as fh:
                procs.append((variant, log, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                     str(paths[variant][lib]), str(out / f"{lib}.cu")],
                    stdout=fh, stderr=subprocess.STDOUT)))
    failed = [(v, log) for v, log, proc in procs if proc.wait() != 0]
    if failed:
        raise RuntimeError(f"{tag}: nvcc failed for {failed[0][0]}:\n"
                           + failed[0][1].read_text()[-4000:])
    return paths


def use(paths: dict) -> dict:
    """Load one variant's libraries ({lib: path}) and make the wrappers
    call them; returns {lib: the loaded library}."""
    from repro_torch.kernels import _build
    for lib, path in paths.items():
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in _build.SIGNATURES[lib].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        _build._libs[lib] = cdll
    return {lib: _build._libs[lib] for lib in paths}
