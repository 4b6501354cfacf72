#!/usr/bin/env python3
"""Where K7's tensor-core path spends its time, on the card: the kernel
built again with one part switched off at a time, each variant timed at
the main path's shapes.  The GPU machine has no `ncu`, so this is the
breakdown it can give.

    python3 scripts/k7_ablation.py      # from the repository root, one GPU

Variants (each a copy of ``src/repro_torch/csrc/posit_matmul.cu`` with a
guard inserted, built into ``build/k7_ablation/``): ``base``; ``nodec``
(the W tiles are not decoded: the tensor cores read stale shared memory);
``nomma`` (no wgmma: ptxas then also drops the A-fragment splits, whose
only use is the wgmma); ``nommadec`` (neither: TMA loads, barriers and the
epilogue, the skeleton).  Results are times only; no variant but ``base``
computes the product.  Prints one JSON line per variant: µs per call
(CUDA events around 10 calls after 3 warm-up calls) by case.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KNOBS = {   # source text -> the same with a guard in front
    "    decode_w_share<CB, WP>(smem + L::kC":
        "    if (!ABL_NODEC) decode_w_share<CB, WP>(smem + L::kC",
    "          wgmma_rs(acc, a[pc][kk],":
        "          if (!ABL_NOMMA) wgmma_rs(acc, a[pc][kk],",
}
VARIANTS = {"base": {}, "nodec": {"ABL_NODEC": 1}, "nomma": {"ABL_NOMMA": 1},
            "nommadec": {"ABL_NODEC": 1, "ABL_NOMMA": 1}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels import _build
    from repro_torch.kernels.posit_encode import encode_tile

    src = (_build.CSRC / "posit_matmul.cu").read_text()
    for old, new in KNOBS.items():
        if old not in src:
            raise RuntimeError(f"k7_ablation: {old.strip()!r} not in the "
                               "kernel source; update KNOBS")
        src = src.replace(old, new)
    out = _build.BUILD_ROOT / "k7_ablation"
    out.mkdir(parents=True, exist_ok=True)
    (out / "posit_codec.cuh").write_text(
        (_build.CSRC / "posit_codec.cuh").read_text())
    (out / "k7.cu").write_text(src)
    t0 = time.perf_counter()
    procs = {}
    for name, on in VARIANTS.items():
        defs = [f"-D{k}={on.get(k, 0)}" for k in ("ABL_NODEC", "ABL_NOMMA")]
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *defs, "-o",
             str(out / f"lib{name}.so"), str(out / "k7.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
    print(f"built {len(procs)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    p8, p16 = get_fmt("posit8_2"), get_fmt("posit16_2")

    def case(m, k, n, x_dtype, fmt):
        x = torch.randn(m, k, generator=gen, device=dev).to(x_dtype)
        w = encode_tile(torch.randn(k, n, generator=gen, device=dev), fmt)
        return x, w, fmt

    cases = {
        "x f32, posit8_2, 8192 x 4096 x 768": case(8192, 768, 4096,
                                                   torch.float32, p8),
        "x bf16, posit8_2, 8192 x 4096 x 768": case(8192, 768, 4096,
                                                    torch.bfloat16, p8),
        "x bf16, posit16_2, 8192 x 8192 x 768": case(8192, 768, 8192,
                                                     torch.bfloat16, p16),
    }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for name in VARIANTS:
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).posit_matmul
        fn.argtypes = _build.SIGNATURES["posit_matmul"]["posit_matmul"]
        fn.restype = ctypes.c_int
        row = {}
        for label, (x, w, fmt) in cases.items():
            (m, k), n = x.shape, w.shape[1]
            scale = torch.ones(n, device=dev)
            o = torch.empty(m, n, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                rc = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(),
                        o.data_ptr(), o.data_ptr(), m, k, n, fmt.bits,
                        fmt.es, fmt.bias, int(x.dtype == torch.bfloat16), 0,
                        0, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch error {rc}")
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(10):
                call()
            e1.record()
            torch.cuda.synchronize()
            row[label] = 1e3 * e0.elapsed_time(e1) / 10
        print(json.dumps({"variant": name, "us": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
