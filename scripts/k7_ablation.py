#!/usr/bin/env python3
"""Where K7's tensor-core path spends its time, on the card: the kernel
built again with one part switched off at a time, each variant timed at
the main path's shapes.  The GPU machine has no `ncu`, so this is the
breakdown it can give.

    python3 scripts/k7_ablation.py [--root DIR]   # from the repository root

``--root`` names the checkout whose ``src/repro_torch/csrc`` is built
(default: this one), so that two commits' K7 can be compared in one call.
Variants (copies of ``posit_matmul.cu`` with a call switched off, built
through ``ablation_build.py`` into ``build/k7_ablation/<root's name>/``):
``base``; ``nodec`` (the W tiles are not decoded: the tensor cores read
stale shared memory); ``nomma`` (no wgmma: ptxas then also drops the
A-fragment splits, whose only use is the wgmma); ``nommadec`` (neither:
TMA loads, barriers and the epilogue, the skeleton).  Results are times
only; no variant but ``base`` computes the product.  Prints the card's
name and power limit, one JSON line with ``base``'s registers and spill
stores for each instance of ``tc_kernel`` and ``skinny_kernel`` (from
ptxas), then one JSON line per variant: µs per call (CUDA events around
10 calls after 3 warm-up calls) by case.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import ablation_build

HERE = Path(__file__).resolve().parents[1]
NODEC = ("    decode_w_share<CB, WP>(smem + L::kC",
         "    if (false) decode_w_share<CB, WP>(smem + L::kC")
NOMMA = ("          wgmma_rs(acc, a[pc][kk],",
         "          if (false) wgmma_rs(acc, a[pc][kk],")
VARIANTS = {"base": [], "nodec": [NODEC], "nomma": [NOMMA],
            "nommadec": [NODEC, NOMMA]}


def ptxas_usage(log: str) -> dict:
    """{kernel instance: [registers, spill store bytes]} of tc_kernel and
    skinny_kernel in a ptxas -v report (template arguments as mangled)."""
    res = {}
    for m in re.finditer(r"Compiling entry function '\S*?((?:tc|skinny)_"
                         r"kernel)(I\S+?E)E\S*'.*?(\d+) bytes spill stores"
                         r".*?Used (\d+) registers", log, re.S):
        res[m.group(1) + m.group(2)] = [int(m.group(4)), int(m.group(3))]
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k7_ablation: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE / "src"))
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels.posit_encode import encode_tile

    root = args.root.resolve()
    libs = ablation_build.build(f"k7_ablation/{root.name}", VARIANTS,
                                ("posit_matmul",),
                                root / "src" / "repro_torch" / "csrc")
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
        "x bf16, posit16_2, 8192 x 32000 x 768 (the head)": case(
            8192, 768, 32000, torch.bfloat16, p16),
    }
    print(ablation_build.card(), flush=True)
    print(json.dumps({"root": str(root), "registers_spills": ptxas_usage(
        (libs["base"]["posit_matmul"].parent / "posit_matmul.log")
        .read_text())}), flush=True)
    for name in VARIANTS:
        fn = ablation_build.use(libs[name])["posit_matmul"].posit_matmul
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
        print(json.dumps({"root": str(root), "variant": name, "us": row}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
