#!/usr/bin/env python3
"""Where K1's time goes, on the card: ``posit_decode`` built again with its
decode or its loads per thread changed, every variant timed at the kernels
line's shape.  The GPU machine has no `ncu`, so this is the breakdown it
can give.

    python3 scripts/k1_ablation.py      # from the repository root, one GPU

Variants (copies of ``src/repro_torch/csrc/posit_codec.cu`` and its header
with a few lines replaced, built through ``ablation_build.py`` into
``build/k1_ablation/<variant>/`` and swapped in for the ``posit_codec``
library): ``base``, the kernel as it is (each load one 16-B store's codes,
4 loads per thread in flight; codes of n <= 8 through a 256-entry f32
table in shared memory that each CTA builds with ``posit::decode``, 16-bit
codes inline); ``inline`` (no table: every code through the inline
``posit::decode``); ``copy`` (no table, no decode: each value is the
code's bits plus the bias, bit-cast to f32; the launch, the loads and the
stores stay); ``loads1``, ``loads2`` and ``loads8`` (``base`` with 1, 2 or
8 loads per thread in flight); ``staged`` (16-B code loads, 2 per thread,
the warp's codes staged through shared memory where one load makes more
than one store, so that each store instruction writes 512 contiguous
bytes).  Every variant but ``copy`` is held bit for bit to
``decode_tile`` before it is timed; ``copy`` computes something else.
Run order: the variants as listed, twice.
Prints the card's name and power limit, then one JSON line per run: device
µs per call from a CUDA graph of 20 calls replayed between CUDA events
(``chip_smoke.graph_ms``), argument sets rotated over 12 arrays of
2,097,152 codes (one layer's posit8 K ring): posit8_2 to f32 (``f32_us``)
and to bf16 (``bf16_us``), and posit16_2 to f32 (``p16_us``).
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import ablation_build

ROOT = Path(__file__).resolve().parents[1]
TABLE_IF = "  if constexpr (N <= 8) {\n"
NO_TABLE = "  if constexpr (false) {\n"
DEC = ("    if constexpr (N <= 8) return tab[c & 0xFFu];\n"
       "    else return posit::decode<N, ES>(c, bias);\n")
LOADS = "constexpr int kDecodeLoads = 4;"
LOOP = """\
  for (int g = tid; g < nvec; g += kDecodeLoads * stride) {
    Load c[kDecodeLoads];
#pragma unroll
    for (int u = 0; u < kDecodeLoads; ++u)
      c[u] = g + u * stride < nvec ? cv[g + u * stride] : Load{};
#pragma unroll
    for (int u = 0; u < kDecodeLoads; ++u)
      if (g + u * stride < nvec)
        decode_store<kBits, OutT, kVecStore, kPerStore>(
            c[u].w, dst + (size_t)(g + u * stride) * kPerLoad, dec);
  }
"""
# 16-B loads; where one load's codes make kStores > 1 stores, the warp's
# codes pass through shared memory and each lane decodes the codes of one
# whole store, so every store instruction writes 512 contiguous bytes
STAGED_LOOP = """\
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int kStores = kPerLoad / kPerStore;
  constexpr int kWords = kPerStore * sizeof(CodeT) / 4;
  for (int g0 = tid - lane; g0 < nvec; g0 += kDecodeLoads * stride) {
    Load c[kDecodeLoads];
#pragma unroll
    for (int u = 0; u < kDecodeLoads; ++u) {
      const int g = g0 + u * stride + lane;
      c[u] = g < nvec ? cv[g] : Load{};
    }
    if constexpr (kStores == 1) {
#pragma unroll
      for (int u = 0; u < kDecodeLoads; ++u) {
        const int g = g0 + u * stride + lane;
        if (g < nvec)
          decode_store<kBits, OutT, kVecStore, kPerStore>(
              c[u].w, dst + (size_t)g * kPerLoad, dec);
      }
    } else {
      __shared__ Load stage[kThreads / 32][kDecodeLoads][32];
#pragma unroll
      for (int u = 0; u < kDecodeLoads; ++u) stage[warp][u][lane] = c[u];
      __syncwarp();
#pragma unroll
      for (int u = 0; u < kDecodeLoads; ++u) {
        const uint32_t* words =
            reinterpret_cast<const uint32_t*>(stage[warp][u]);
#pragma unroll
        for (int i = 0; i < kStores; ++i) {
          const int j = lane + 32 * i;
          uint32_t w[kWords];
#pragma unroll
          for (int k = 0; k < kWords; ++k) w[k] = words[j * kWords + k];
          if (g0 + u * stride + j / kStores < nvec)
            decode_store<kBits, OutT, kVecStore, kPerStore>(
                w, dst + (size_t)(g0 + u * stride) * kPerLoad + j * kPerStore,
                dec);
        }
      }
      __syncwarp();
    }
  }
"""
# variant -> [(text in posit_codec.cu, its replacement)]
VARIANTS = {
    "base": [],
    "inline": [(TABLE_IF, NO_TABLE),
               (DEC, "    return posit::decode<N, ES>(c, bias);\n")],
    "copy": [(TABLE_IF, NO_TABLE),
             (DEC, "    return __uint_as_float(c + bias);\n")],
    "loads1": [(LOADS, "constexpr int kDecodeLoads = 1;")],
    "loads2": [(LOADS, "constexpr int kDecodeLoads = 2;")],
    "loads8": [(LOADS, "constexpr int kDecodeLoads = 8;")],
    "staged": [("constexpr int kCodesPerLoad = 16 / sizeof(OutT);",
                "constexpr int kCodesPerLoad = 16 / sizeof(CodeT);"),
               (LOADS, "constexpr int kDecodeLoads = 2;"),
               (LOOP, STAGED_LOOP)],
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_ablation: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    from chip_smoke import bits_equal, graph_ms
    from repro_torch.core.formats import POSIT8_2, POSIT16_2
    from repro_torch.kernels.posit_decode import decode_tile, posit_decode

    print(ablation_build.card(), flush=True)
    libs = ablation_build.build("k1_ablation", VARIANTS, ("posit_codec",))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    layers, n = 12, 1 << 21
    c8 = [torch.randint(0, 256, (n,), generator=gen, device=dev,
                        dtype=torch.uint8) for _ in range(layers)]
    c16 = [torch.randint(-(1 << 15), 1 << 15, (n,), generator=gen,
                         device=dev, dtype=torch.int16)
           for _ in range(layers)]
    for variant in tuple(VARIANTS) * 2:
        ablation_build.use(libs[variant])
        if variant != "copy":
            for codes, fmt in ((c8[0], POSIT8_2), (c16[0], POSIT16_2)):
                for out in (torch.float32, torch.bfloat16):
                    assert bits_equal(posit_decode(codes, fmt, out_dtype=out),
                                      decode_tile(codes, fmt, out)), (
                                          variant, fmt.name, out)
        res = {"variant": variant,
               "f32_us": 1e3 * graph_ms(
                   lambda i: posit_decode(c8[i], POSIT8_2), layers),
               "bf16_us": 1e3 * graph_ms(
                   lambda i: posit_decode(c8[i], POSIT8_2,
                                          out_dtype=torch.bfloat16), layers),
               "p16_us": 1e3 * graph_ms(
                   lambda i: posit_decode(c16[i], POSIT16_2), layers)}
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
