#!/usr/bin/env python3
"""Device times of the port's K1-K7 at the main paths' shapes, for
one checkout of the port, so that two commits can be compared in one run
on one card (parent, change, change, parent):

    python3 scripts/port_kernel_times.py [--root DIR] [--seed N]

``--root`` names the checkout whose ``src/repro_torch`` is timed (default:
this one); it builds that checkout's kernels under its own ``build/``.
Only entry points that every slice of the port has are called.  Times are
device ms per call from a CUDA graph of the calls replayed between CUDA
events (``chip_smoke.graph_ms``), argument sets rotated over 12 layers'
buffers as in ``chip_smoke.py``'s kernels line:

- K1: 2,097,152 posit8_2 codes (one layer's posit8 K ring, the kernels
  line's shape) to f32 (``k1_us``) and to bf16 (``k1_bf16_us``);
- K2 (``k2_us``): 2,097,152 f32 values (the same shape) to posit8_2
  codes;
- K3 (ring append, posit8, B = 8, T = 1, into 1024-row rings): f32 rows
  (``k3_us``, the kernels line's shape); the ring decode step's append
  from the model's bf16 K/V (v a strided view of the fused QKV output) as
  casts to f32 then K3 (``k3_casts_us``) and as the wrapper given the bf16
  rows (``k3_bf16_us``: a checkout whose K3 reads bf16 launches K3 alone,
  an older one casts inside its wrapper); and the wrapper given bf16 rows
  at a ring prefill's T = 1024, B = 1 (``k3_t1024_bf16_us``);
- K6 (paged) and K4 (ring): B = 8, nh = 12 over 4 KV heads of 64, posit8
  codes, 16-row pages through a shuffled table, seq_lens {1, 17, 128,
  129, 500, 1000, 1023, 1024}, q bf16;
- K5 (paged append, posit8, B = 8, T = 1, into the same pool): f32 rows
  (``k5_us``, the kernels line's shape); the paged decode step's append
  from the model's bf16 K/V (v a strided view of the fused QKV output) as
  casts to f32 then K5 (``k5_casts_us``) and as the wrapper given the bf16
  rows (``k5_bf16_us``: a checkout whose K5 reads bf16 launches K5 alone,
  an older one casts inside its wrapper); and the wrapper given bf16 rows
  at a paged prefill's T = 1024, B = 1 (``k5_t1024_bf16_us``);
- K7: x (M, 768) f32 times wi (768 x 4096, posit8_2, (1, N) scale) at
  M = 8192 and M = 8, beside torch.matmul by the decoded f32 W; and
  (``k7_p16_us``) the quickstart's head, bf16 x (8192, 768) times a
  768 x 32000 posit16_2 W with its (1, N) scale (16-bit codes decode
  inline);
- quickstart part 2: the 73 ``qt_matmul`` calls of ``chip_smoke.py``
  phase 10 (12 layers x wq wk wv wo wi wo_mlp in posit8_2 and the head
  in posit16_2, bf16 activations of 8 x 1024 tokens), one graph of all.

Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("port_kernel_times: no CUDA GPU available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(HERE))
    from chip_smoke import graph_ms
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.formats import POSIT8_2, POSIT16_2
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import kv_cache as kvk
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels.ops import qt_matmul
    from repro_torch.kernels.posit_decode import decode_tile, posit_decode
    from repro_torch.kernels.posit_encode import posit_encode
    from repro_torch.kernels.posit_matmul import posit_matmul
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(root)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    layers, b, nkv, hd, nh, ps, w = 12, 8, 4, 64, 12, 16, 1024
    pmax = w // ps
    pages = 1 + b * pmax
    res = {"root": str(root)}

    # K4 / K6 over the same live rows
    lens = torch.tensor([1, 17, 128, 129, 500, 1000, 1023, 1024],
                        dtype=torch.int32, device=dev)
    table = torch.from_numpy((1 + rng.permutation(b * pmax)).reshape(
        b, pmax).astype(np.int32)).to(dev)
    q = torch.randn(b, 1, nh, hd, generator=gen, device=dev).to(
        torch.bfloat16)

    def codes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    def scales(*shape):
        return torch.exp2(torch.randint(-8, 8, shape, generator=gen,
                                        device=dev).float())

    pool = [(codes(pages * ps, nkv, hd), scales(pages * ps, nkv),
             codes(pages * ps, nkv, hd), scales(pages * ps, nkv))
            for _ in range(layers)]
    ring = [(codes(b, w, nkv, hd), scales(b, w, nkv), codes(b, w, nkv, hd),
             scales(b, w, nkv)) for _ in range(layers)]
    res["k6_us"] = 1e3 * graph_ms(lambda i: pkv.paged_decode_attention(
        q, *pool[i], table, lens, POSIT8_2, page_size=ps), layers)
    res["k4_us"] = 1e3 * graph_ms(lambda i: kvk.decode_attention(
        q, *ring[i], lens, POSIT8_2), layers)

    # K1 over one layer's posit8 K ring of codes, K2 over its values
    cs = [codes(b * w * nkv * hd) for _ in range(layers)]
    res["k1_us"] = 1e3 * graph_ms(lambda i: posit_decode(cs[i], POSIT8_2),
                                  layers)
    res["k1_bf16_us"] = 1e3 * graph_ms(lambda i: posit_decode(
        cs[i], POSIT8_2, out_dtype=torch.bfloat16), layers)
    xs = [decode_tile(c, POSIT8_2) for c in cs]
    del cs
    res["k2_us"] = 1e3 * graph_ms(lambda i: posit_encode(xs[i], POSIT8_2),
                                  layers)
    del xs

    # K3 into the rings and K5 into the pool
    pos = torch.tensor([int(n) + 16 for n in lens], dtype=torch.int32,
                       device=dev)
    dst = pkv.flat_dst_rows(table, pos, ps)
    k1 = torch.randn(b, 1, nkv, hd, generator=gen, device=dev)
    v1 = torch.randn(b, 1, nkv, hd, generator=gen, device=dev)
    qkv = torch.cat([k1, k1, v1], dim=-1).to(torch.bfloat16)
    kb, vb = qkv[..., hd:2 * hd].contiguous(), qkv[..., 2 * hd:]
    res["k3_us"] = 1e3 * graph_ms(lambda i: kvk.kv_append_rows(
        *ring[i], k1, v1, pos, POSIT8_2), layers)
    res["k3_casts_us"] = 1e3 * graph_ms(lambda i: kvk.kv_append_rows(
        *ring[i], kb.float(), vb.float(), pos, POSIT8_2), layers)
    res["k3_bf16_us"] = 1e3 * graph_ms(lambda i: kvk.kv_append_rows(
        *ring[i], kb, vb, pos, POSIT8_2), layers)
    pos0 = torch.zeros(1, dtype=torch.int32, device=dev)
    res["k5_us"] = 1e3 * graph_ms(lambda i: pkv.paged_kv_append(
        *pool[i], k1, v1, dst, POSIT8_2), layers)
    res["k5_casts_us"] = 1e3 * graph_ms(lambda i: pkv.paged_kv_append(
        *pool[i], kb.float(), vb.float(), dst, POSIT8_2), layers)
    res["k5_bf16_us"] = 1e3 * graph_ms(lambda i: pkv.paged_kv_append(
        *pool[i], kb, vb, dst, POSIT8_2), layers)
    kv_pf = torch.randn(1, w, nkv, hd, generator=gen, device=dev).to(
        torch.bfloat16)
    dst_pf = pkv.flat_dst_rows_chunk(
        table[:1], torch.zeros(1, dtype=torch.int32, device=dev), w, ps)
    res["k5_t1024_bf16_us"] = 1e3 * graph_ms(
        lambda i: pkv.paged_kv_append_rows(*pool[i], kv_pf, kv_pf, dst_pf,
                                           POSIT8_2), layers)
    res["k3_t1024_bf16_us"] = 1e3 * graph_ms(
        lambda i: kvk.kv_append_rows(*(t[:1] for t in ring[i]), kv_pf,
                                     kv_pf, pos0, POSIT8_2), layers)
    del pool, ring

    # K7 at the kernels line's shapes
    wi = [quantize(0.02 * torch.randn(768, 4096, generator=gen, device=dev),
                   POSIT8_2, axis=0) for _ in range(layers)]
    dec = [decode_tile(t.data, POSIT8_2) for t in wi]
    res["k7_us"], res["decoded_matmul_us"] = {}, {}
    for m in (8192, 8):
        xs = [torch.randn(m, 768, generator=gen, device=dev)
              for _ in range(layers)]
        res["k7_us"][m] = 1e3 * graph_ms(lambda i, _x=xs: posit_matmul(
            _x[i], wi[i].data, POSIT8_2, wi[i].scale), layers)
        res["decoded_matmul_us"][m] = 1e3 * graph_ms(
            lambda i, _x=xs: torch.matmul(_x[i], dec[i]) * wi[i].scale,
            layers)
    del dec
    x16 = torch.randn(8192, 768, generator=gen, device=dev).to(
        torch.bfloat16)
    heads = [quantize(0.02 * torch.randn(768, 32000, generator=gen,
                                         device=dev), POSIT16_2, axis=0)
             for _ in range(2)]
    res["k7_p16_us"] = 1e3 * graph_ms(lambda i: posit_matmul(
        x16, heads[i].data, POSIT16_2, heads[i].scale), 2)
    del heads

    # quickstart part 2: 73 qt_matmul calls
    hid = torch.randn(8192, 768, generator=gen, device=dev).to(
        torch.bfloat16)
    act = torch.randn(8192, 2048, generator=gen, device=dev).to(
        torch.bfloat16)
    calls = []
    for _ in range(layers):
        for k, n in ((768, 768), (768, 256), (768, 256), (768, 768),
                     (768, 4096)):
            calls.append((hid, quantize(0.02 * torch.randn(
                k, n, generator=gen, device=dev), POSIT8_2, axis=0)))
        calls.append((act, quantize(0.02 * torch.randn(
            2048, 768, generator=gen, device=dev), POSIT8_2, axis=0)))
    calls.append((hid, quantize(0.02 * torch.randn(
        768, 32000, generator=gen, device=dev), POSIT16_2, axis=0)))
    res["part2_ms"] = len(calls) * graph_ms(
        lambda i: qt_matmul(*calls[i]), len(calls), iters=len(calls),
        reps=3)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
