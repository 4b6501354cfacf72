"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds go
to ``build/kernels-<hash>/`` at the checkout root, keyed by a hash of every
source and the flags, at first use; all libraries are compiled in parallel
(one ``nvcc`` per source).  Nothing here runs at import time.

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# library -> {C entry: argtypes}; every entry returns cudaGetLastError()
SIGNATURES = {
    "posit_codec": {
        # codes, out, count, nbits, es, bias, out_bf16, stream
        "posit_decode": [_P, _P, _I, _I, _I, _I, _I, _P],
        # x, codes, count, nbits, es, bias, normalize, stream
        "posit_encode": [_P, _P, _I, _I, _I, _I, _I, _P],
    },
    "kv_cache": {
        # k_new, v_new, k_codes, k_scale, v_codes, v_scale, pos,
        # k_new's and v_new's element strides along b, t, head,
        # B, T, H, hd, W, nbits, es, bias, x_bf16, stream
        "kv_append_rows": [_P] * 7 + [_L] * 6 + [_I] * 9 + [_P],
        # q, k_codes, k_scale, v_codes, v_scale, cache_len, out, part,
        # B, nkv, grp, hd, W, nbits, es, bias, q_bf16, split_rows, qscale,
        # stream
        "decode_attention": [_P] * 8 + [_I] * 10 + [_F, _P],
    },
    "paged_kv": {
        # k_new, v_new, k_codes, k_scale, v_codes, v_scale, dst,
        # k_new's and v_new's element strides along b, t, head,
        # B, T, H, hd, R, nbits, es, bias, x_bf16, stream
        "paged_kv_append_rows": [_P] * 7 + [_L] * 6 + [_I] * 9 + [_P],
        # q, k_codes, k_scale, v_codes, v_scale, page_table, seq_lens, out,
        # part, B, nkv, grp, hd, ps, Pmax, num_pages, nbits, es, bias, q_bf16,
        # split_rows, qscale, stream
        "paged_decode_attention": [_P] * 9 + [_I] * 12 + [_F, _P],
    },
    "posit_matmul": {
        # x, w_codes, scale, out, work, M, K, N, nbits, es, bias, x_bf16,
        # compute_bf16, splits, stream
        "posit_matmul": [_P] * 5 + [_I] * 9 + [_P],
    },
}

LAUNCHES: Dict[str, int] = {fn: 0 for entries in SIGNATURES.values()
                            for fn in entries}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds = None     # wall time of the last build, for reports


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit on the machine with the GPU")
    return found


def build_dir() -> Path:
    return BUILD_ROOT / f"kernels-{_digest()}"


def build_all() -> Path:
    """Compile every library not yet built (in parallel) and return the
    build directory.  Raises with the compiler's output on failure."""
    global build_seconds
    out = build_dir()
    todo = [n for n in SIGNATURES if not (out / f"lib{n}.so").exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out / f"lib{name}.so.{os.getpid()}.tmp"
        log = open(out / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), tmp, log)
    failed = []
    for name, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(name)
        else:
            os.replace(tmp, out / f"lib{name}.so")
    build_seconds = time.perf_counter() - t0
    if failed:
        msgs = "\n".join((out / f"{n}.log").read_text() for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return out


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building all libraries at first use."""
    with _lock:
        if name not in _libs:
            path = build_all() / f"lib{name}.so"
            cdll = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(cdll, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def launch(library: str, fn: str, device: torch.device, *args) -> None:
    """Call C entry ``fn`` on ``device``'s current stream, raise on a CUDA
    error and count the launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib(library), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {fn} failed to launch: error {rc}")
    LAUNCHES[fn] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor the kernel touches must be a contiguous CUDA tensor on
    one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on {dev}, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def code_dtype(fmt) -> torch.dtype:
    """Codes the kernels read and write: uint8 up to 8 bits, else int16
    (the posit16 bit patterns)."""
    return torch.uint8 if fmt.bits <= 8 else torch.int16


KERNEL_FORMATS = {(4, 1), (8, 0), (8, 1), (8, 2), (16, 0), (16, 1), (16, 2)}


def check_fmt(name: str, fmt) -> None:
    if (fmt.bits, fmt.es) not in KERNEL_FORMATS:
        raise ValueError(f"{name}: no CUDA instantiation for posit"
                         f"({fmt.bits},{fmt.es}); built: "
                         f"{sorted(KERNEL_FORMATS)}")


def check_kv(name: str, fmt, packed: bool, codes, scales) -> None:
    """What every KV-cache kernel takes: a built format, nibble packing
    exactly for 4-bit codes, codes of ``code_dtype(fmt)`` and float32
    scales."""
    check_fmt(name, fmt)
    if packed != (fmt.bits == 4):
        raise ValueError(f"{name}: nibble packing is for 4-bit codes")
    for c in codes:
        if c.dtype != code_dtype(fmt):
            raise TypeError(f"{name}: codes must be {code_dtype(fmt)}")
    for s in scales:
        if s.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32")
