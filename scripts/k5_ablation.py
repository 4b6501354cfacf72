#!/usr/bin/env python3
"""Where the appends' time goes, on the card: K5 (paged) and K3 (ring),
which share ``kv_rows.cuh``'s lane-group append, built again with their
posit encode switched off, both variants timed at the main paths' shapes.
The GPU machine has no `ncu`, so this is the breakdown it can give.

    python3 scripts/k5_ablation.py      # from the repository root, one GPU

Variants (copies of ``src/repro_torch/csrc/paged_kv.cu``,
``kv_cache.cu`` and their headers, built into
``build/k5_ablation/<variant>/`` and swapped in for the ``paged_kv`` and
``kv_cache`` libraries): ``base``; ``noenc`` (each element's code is the
top bits of x / scale instead of ``posit::encode``: the launch, the loads,
the row's sum, the shuffles and the stores stay).  Only ``base`` computes
K5 and K3.  Run order base, noenc, base, noenc.  Prints the card's name
and power limit, then one JSON line per run: device µs per call from a
CUDA graph of 20 calls replayed between CUDA events
(``chip_smoke.graph_ms``), argument sets rotated over 12 layers' pools or
rings, posit8, B = 8, nkv = 4, hd = 64: K5's ``f32_us`` (T = 1, f32 rows,
the kernels line's shape), ``bf16_us`` (T = 1, the model's bf16 rows, v a
strided view), ``t1024_bf16_us`` (T = 1024, B = 1, bf16: a paged
prefill); K3's ``k3_bf16_us`` (T = 1 from the same bf16 rows into
1024-row rings: the ring decode step's append).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import ablation_build

ROOT = Path(__file__).resolve().parents[1]
ENCODE = "c[k][e] = posit::encode<N, ES>(v[k][e] / scale, bias);"
VARIANTS = {"base": [],
            "noenc": [(ENCODE, "c[k][e] = __float_as_uint(v[k][e] / scale) "
                               ">> (32 - N);")]}
LIBS = ("paged_kv", "kv_cache")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_ablation: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import graph_ms
    from repro_torch.core.formats import POSIT8_2
    from repro_torch.kernels import kv_cache as kvk
    from repro_torch.kernels import paged_kv as pkv

    print(ablation_build.card(), flush=True)
    libs = ablation_build.build("k5_ablation", VARIANTS, LIBS)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layers, b, nkv, hd, ps, pmax = 12, 8, 4, 64, 16, 64
    rows = (1 + b * pmax) * ps
    table = (1 + torch.randperm(b * pmax, generator=gen, device=dev)).reshape(
        b, pmax).to(torch.int32)
    pools = [(torch.zeros(rows, nkv, hd, dtype=torch.uint8, device=dev),
              torch.ones(rows, nkv, device=dev)) for _ in range(layers)]
    pos = torch.tensor([198, 353, 390, 511, 673, 698, 880, 910],
                       dtype=torch.int32, device=dev)
    dst = pkv.flat_dst_rows(table, pos, ps)
    k1 = torch.randn(b, 1, nkv, hd, generator=gen, device=dev)
    v1 = torch.randn(b, 1, nkv, hd, generator=gen, device=dev)
    qkv = torch.cat([k1, k1, v1], dim=-1).to(torch.bfloat16)
    kb, vb = qkv[..., hd:2 * hd].contiguous(), qkv[..., 2 * hd:]
    kv_pf = torch.randn(1, 1024, nkv, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    dst_pf = pkv.flat_dst_rows_chunk(
        table[:1], torch.zeros(1, dtype=torch.int32, device=dev), 1024, ps)

    rings = [(torch.zeros(b, 1024, nkv, hd, dtype=torch.uint8, device=dev),
              torch.ones(b, 1024, nkv, device=dev)) for _ in range(layers)]

    def call(i, k, v, d):
        c, s = pools[i]
        return pkv.paged_kv_append_rows(c, s, c, s, k, v, d, POSIT8_2)

    def call_ring(i, k, v):
        c, s = rings[i]
        return kvk.kv_append_rows(c, s, c, s, k, v, pos, POSIT8_2)

    for variant in ("base", "noenc", "base", "noenc"):
        ablation_build.use(libs[variant])
        res = {"variant": variant,
               "f32_us": 1e3 * graph_ms(
                   lambda i: call(i, k1, v1, dst[:, None]), layers),
               "bf16_us": 1e3 * graph_ms(
                   lambda i: call(i, kb, vb, dst[:, None]), layers),
               "t1024_bf16_us": 1e3 * graph_ms(
                   lambda i: call(i, kv_pf, kv_pf, dst_pf), layers),
               "k3_bf16_us": 1e3 * graph_ms(
                   lambda i: call_ring(i, kb, vb), layers)}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
