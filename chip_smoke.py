#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Builds the hand-written CUDA kernels (K1..K4) from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card, serves the
full-width paper-edge model through ``ServingEngine`` with a posit8 KV ring,
checks card against CPU at float32, times every kernel and prints one JSON
line per contract.  Needs one CUDA GPU; run from the repository root:

    python3 chip_smoke.py [--seed N]

Every phase asserts; nothing is caught.  Tolerances:
  K1, K2, K3     bit-exact against decode_tile / encode_tile /
                 kv_append_rows_ref (NaN exactly at NaR for K1).
  K4             rtol 1e-5, atol 1e-5 against decode_attention_ref on K/V
                 of O(1) magnitude (online vs dense softmax: f32
                 summation order).
  card vs CPU    rtol 1e-3, atol 1e-3 on the first two decode steps' logits
                 (float32 model, TF32 off on the card; matmul summation
                 order differs between cuBLAS and the CPU).

Kernel times (the kernels JSON line): ``ms`` is the device time per
wrapper call, from a CUDA graph of 20 calls replayed between CUDA events,
so no host launch cost enters it (K4's wrapper adds its q scaling and
output cast, small elementwise ops, to the kernel); ``plain_ms`` is the
plain PyTorch version per call, between CUDA events around eager calls.
The decode-step profile of phase 6b (device busy, idle share) comes from a
torch.profiler trace and reads "not measured" where the trace holds no
device events.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # non-tensor-core float32, H100 SXM

KERNELS = {
    "posit_decode": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_decode.py:68"),
    "posit_encode": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_encode.py:81"),
    "kv_append_rows": ("src/repro_torch/csrc/kv_cache.cu",
                       "src/repro/kernels/kv_cache.py:150"),
    "decode_attention": ("src/repro_torch/csrc/kv_cache.cu",
                         "src/repro/kernels/kv_cache.py:259"),
}
CODEC_FORMATS = ("posit4_1", "posit8_0", "posit8_2", "posit16_1", "posit16_2")
# the main path's shape: max_batch 8, max_len 1024, 4 KV heads of 64
B, W, NKV, HD, NH = 8, 1024, 4, 64, 12
KV_FORMATS = (("posit16_2", False), ("posit8_2", False), ("posit4_1", True))


T_START = time.perf_counter()


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        nan_a, nan_b = torch.isnan(a), torch.isnan(b)
        if not torch.equal(nan_a, nan_b):
            return False
        a, b = a[~nan_a], b[~nan_b]
        view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
        return torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))
    return torch.equal(a, b)


def time_ms(fn, n_args: int, iters: int = 20, reps: int = 5) -> float:
    """Median ms per call over ``reps`` runs of ``iters`` calls, CUDA
    events; call i uses argument set i % n_args (sets sized past the L2)."""
    import torch
    for i in range(3):
        fn(i % n_args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i % n_args)
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / iters)
    return statistics.median(times)


def graph_ms(fn, n_args: int, iters: int = 20, reps: int = 5) -> float:
    """Median device ms per call of ``fn`` over ``reps`` replays of a CUDA
    graph of ``iters`` calls (call i uses argument set i % n_args), between
    CUDA events: the card's time, without the host's launch cost."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up off the default stream
        for i in range(3):
            fn(i % n_args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i % n_args)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / iters)
    del graph
    return statistics.median(times)


def device_events(prof):
    """Total device µs by short kernel name in a profiler trace."""
    import torch
    out = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("(")[0].split("<")[0]
        name = name.split("::")[-1] or e.name[:40]
        functor = re.search(r"::(\w*Functor\w*)", e.name)
        if functor:                 # which op a generic elementwise ran
            name += f"[{functor.group(1)}]"
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels import LAUNCHES, _build, reset_launches
    from repro_torch.kernels import kv_cache as kvk
    from repro_torch.kernels.posit_decode import decode_tile, posit_decode
    from repro_torch.kernels.posit_encode import encode_tile, posit_encode
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    err = {k: 0.0 for k in KERNELS}

    # 1. card line and kernel build ------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)          # the card's name and power limit
    t0 = time.perf_counter()
    bdir = _build.build_all()
    for name in _build.SIGNATURES:
        _build.lib(name)
    ptxas = "".join(log.read_text() for log in sorted(bdir.glob("*.log")))
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                            ptxas))
    phase(f"phase 1 build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.build_seconds or 0.0:.1f} s) -> {bdir.name}; ptxas: "
          f"{len(regs)} kernels, max {max(regs, default=0)} registers, "
          f"{spills} bytes spilled")

    # 2. K1 vs decode_tile, every code ---------------------------------
    for name in CODEC_FORMATS:
        fmt = get_fmt(name)
        codes = torch.arange(1 << fmt.bits, dtype=torch.int64, device=dev)
        codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes).to(
            _build.code_dtype(fmt))
        for out_dtype in (torch.float32, torch.bfloat16):
            got = posit_decode(codes, fmt, out_dtype=out_dtype)
            want = decode_tile(codes, fmt, out_dtype)
            assert bits_equal(got, want), (name, out_dtype)
            nar = torch.zeros_like(codes, dtype=torch.bool)
            nar[1 << (fmt.bits - 1)] = True
            assert torch.equal(torch.isnan(got), nar), name
    phase(f"phase 2 K1 posit_decode bit-exact on every code of "
          f"{', '.join(CODEC_FORMATS)} (f32 and bf16 out)")

    # 3. K2 vs encode_tile ---------------------------------------------
    normal = rng.normal(0, 1, 1 << 16).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        1.4e-45, -1.17e-38, 1.18e-38, 3.4e38, -3.4e38],
                       np.float32)
    pats = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate(
        [normal, normal * 1e-8, normal * 1e8, special, pats])).to(dev)
    for name in CODEC_FORMATS:
        fmt = get_fmt(name)
        assert bits_equal(posit_encode(x, fmt), encode_tile(x, fmt)), name
    phase(f"phase 3 K2 posit_encode bit-exact on {x.numel()} inputs "
          f"(normal at 1, 1e-8, 1e8; +-0, +-inf, NaN, subnormals; 2^20 "
          f"random bit patterns)")

    # 4. K3 vs kv_append_rows_ref at the main path's shape -------------
    def fresh_ring(fmt, packed):
        dc = kvk.code_channels(HD, fmt, packed)
        hi = 1 << (8 if fmt.bits <= 8 else 16)
        codes = torch.from_numpy(rng.integers(0, hi, (B, W, NKV, dc))).to(dev)
        codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes) \
            if fmt.bits > 8 else codes
        codes = codes.to(_build.code_dtype(fmt))
        scales = torch.from_numpy(np.exp2(rng.integers(
            -8, 8, (B, W, NKV))).astype(np.float32)).to(dev)
        return codes, scales

    def rows(t, spread=6):
        mag = np.exp2(rng.uniform(-spread, spread, (B, t, NKV, 1)))
        return torch.from_numpy((rng.normal(0, 1, (B, t, NKV, HD)) * mag)
                                .astype(np.float32)).to(dev)

    pos_wrap = torch.tensor([0, 5, 1023, 1024, 1500, 2047, 3000, 77],
                            dtype=torch.int32, device=dev)
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        for t, pos in ((1, pos_wrap),
                       (W, torch.zeros(B, dtype=torch.int32, device=dev))):
            kc, ks = fresh_ring(fmt, packed)
            vc, vs = fresh_ring(fmt, packed)
            kn, vn = rows(t), rows(t)
            got = kvk.kv_append_rows(kc.clone(), ks.clone(), vc.clone(),
                                     vs.clone(), kn, vn, pos, fmt,
                                     packed=packed)
            want = kvk.kv_append_rows_ref(kc.clone(), ks.clone(), vc.clone(),
                                          vs.clone(), kn, vn, pos, fmt,
                                          packed)
            for g, w_ in zip(got, want):
                assert bits_equal(g, w_), (name, t)
            if t == 1:          # rows not written are unchanged
                idx = pos_wrap.long() % W
                keep = torch.ones((B, W), dtype=torch.bool, device=dev)
                keep[torch.arange(B, device=dev), idx] = False
                assert torch.equal(got[0][keep], kc[keep]), name
                assert torch.equal(got[1][keep], ks[keep]), name
    phase("phase 4 K3 kv_append_rows bit-exact (codes, scales, untouched "
          f"rows) at B={B} W={W} nkv={NKV} hd={HD}, posit16/8/4, T=1 with "
          "wrapping pos and T=1024 from 0")

    # 5. K4 vs decode_attention_ref: K/V rows of O(1) magnitude (per-row
    # scales over 2^-2..2^2, as post-RoPE K/V at init), so 1e-5 is a few
    # f32 roundings of the output's scale ------------------------------
    cache_len = torch.tensor([1, 17, 128, 129, 500, 1000, 1023, 1024],
                             dtype=torch.int32, device=dev)
    # slots with nothing cached: every row masked, the mean of V
    empty_len = torch.tensor([0, 17, 0, 129, 500, 0, 1023, 1024],
                             dtype=torch.int32, device=dev)
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        kc, ks = fresh_ring(fmt, packed)
        vc, vs = fresh_ring(fmt, packed)
        kvk.kv_append_rows_ref(kc, ks, vc, vs, rows(W, 2), rows(W, 2),
                               torch.zeros(B, dtype=torch.int32, device=dev),
                               fmt, packed)
        q = torch.from_numpy(rng.normal(0, 1, (B, 1, NH, HD)).astype(
            np.float32)).to(dev)
        errs = []
        for cl in (cache_len, empty_len):
            got = kvk.decode_attention(q, kc, ks, vc, vs, cl, fmt,
                                       packed=packed)
            want = kvk.decode_attention_ref(q, kc, ks, vc, vs, cl, fmt,
                                            packed)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs.append(float((got - want).abs().max()))
        if name == "posit8_2":
            err["decode_attention"] = errs[0]
        phase(f"phase 5 K4 decode_attention {name}: max |err| {errs[0]:.3e}"
              f", {errs[1]:.3e} with empty slots (rtol 1e-5, atol 1e-5)")

    # 6. main path: full-width paper-edge, posit8 ring, 8 requests -----
    cfg = get_config("paper-edge")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    n_params = cfg.param_count()
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=8, max_len=1024, kv_format="posit8"),
        policy="paper_edge_p8")
    finite = []
    prefill_fn, generate_fn = eng.engine.prefill, eng.engine.generate

    def prefill_checked(*a):
        out = prefill_fn(*a)
        finite.append(torch.isfinite(out["logits"]).all())
        return out

    def generate_checked(*a):
        state, logits = generate_fn(*a)
        finite.append(torch.isfinite(logits).all())
        return state, logits

    eng.engine.prefill, eng.engine.generate = prefill_checked, \
        generate_checked
    eng.serve([Request(uid=-1, prompt=rng.integers(0, cfg.vocab, 64),
                       max_new=3)])                       # warm-up
    lens = rng.integers(64, 901, 8)
    reqs = [Request(uid=i, prompt=rng.integers(0, cfg.vocab, int(n)),
                    max_new=32) for i, n in enumerate(lens)]
    eng.tracer.reset()
    eng.tracer.enable()
    steps0, tokens0 = eng.stats["decode_steps"], eng.stats["tokens"]
    torch.cuda.synchronize()
    reset_launches()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    main_launches = dict(LAUNCHES)
    eng.tracer.disable()
    steps = eng.stats["decode_steps"] - steps0
    tokens = eng.stats["tokens"] - tokens0
    st = eng.tracer.self_times()

    def stage_ms(stage):
        n = st[f"{stage}.device"]["count"]
        return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                      + st[f"{stage}.device"]["total_s"]) / n, n

    prefill_ms, n_prefill = stage_ms("prefill")
    decode_ms, _ = stage_ms("generate")
    assert all(bool(f) for f in finite), "non-finite logits"
    assert all(len(r.out_tokens) == 32 for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    for k in ("kv_append_rows", "decode_attention"):
        assert main_launches[k] >= cfg.n_layers * steps, (k, main_launches)
    phase(f"phase 6 main path: paper-edge {cfg.n_layers}L d{cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads}h hd{cfg.head_dim} vocab "
          f"{cfg.vocab} ({n_params / 1e6:.1f} M params, {cfg.dtype_name}), "
          f"posit8 ring, 8 requests of {sorted(int(n) for n in lens)} "
          f"prompt tokens, max_new 32: prefill {prefill_ms:.2f} ms/call "
          f"({n_prefill} calls), decode {decode_ms:.3f} ms/step ({steps} "
          f"steps), {tokens / stats['wall_s']:.1f} tok/s, KV "
          f"{eng.kv_cache_bytes()} B, launches K3 "
          f"{main_launches['kv_append_rows']} K4 "
          f"{main_launches['decode_attention']}")

    # 6b. where a decode step's time goes: one profiled window --------
    from torch.profiler import ProfilerActivity, profile
    n_prof = 5
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.cache, logits = generate_fn(eng.params, eng.cache)
            logits.float().cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    per_step = {k: v / n_prof for k, v in LAUNCHES.items()}
    per_kernel = {k: v / n_prof / 1e3
                  for k, v in device_events(prof).items()}
    busy = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    device = (f"device busy {busy:.3f} ms/step, idle share "
              f"{1 - busy / wall_ms:.3f}; top kernels (ms/step): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top)) if per_kernel \
        else "device busy and idle share not measured (the profiler " \
             "trace held no device events)"
    phase(f"phase 6b decode-step profile ({n_prof} generate calls at the "
          f"served positions): wall {wall_ms:.3f} ms/step, {device}")

    # 7. the whole slice, card vs CPU at float32 ----------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype_name="float32")
    params32 = lm.init_params(cfg32, gen, device=dev)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (19, 40)]
    runs = {}
    for device in ("cuda", "cpu"):         # the engine moves the params
        e32 = ServingEngine(cfg32, params32, ServeConfig(
            max_batch=2, max_len=64, kv_format="posit8"),
            policy="paper_edge_p8", device=device)
        logs = []
        gen_fn = e32.engine.generate

        def generate_logged(*a, _g=gen_fn, _l=logs):
            state, logits = _g(*a)
            _l.append(logits.detach().cpu())
            return state, logits

        e32.engine.generate = generate_logged
        rq = [Request(uid=i, prompt=pr, max_new=8)
              for i, pr in enumerate(prompts)]
        e32.serve(rq)
        runs[device] = (logs, [r.out_tokens for r in rq])
    for i in range(2):
        torch.testing.assert_close(runs["cuda"][0][i], runs["cpu"][0][i],
                                   rtol=1e-3, atol=1e-3)
    dmax = max(float((runs["cuda"][0][i] - runs["cpu"][0][i]).abs().max())
               for i in range(2))
    same = [sum(a == b for a, b in zip(x, y))
            for x, y in zip(runs["cuda"][1], runs["cpu"][1])]
    phase(f"phase 7 card vs CPU (float32, TF32 off): first two decode "
          f"steps' logits within rtol 1e-3 atol 1e-3 (max |diff| "
          f"{dmax:.3e}); identical greedy tokens per request "
          f"{same} of 8")

    # 8. kernels line: times at the main path's shapes -----------------
    p8 = get_fmt("posit8_2")
    layers = cfg.n_layers
    n_codes = B * W * NKV * HD                  # one layer's K ring
    code_sets = [torch.from_numpy(rng.integers(0, 256, n_codes).astype(
        np.uint8)).to(dev) for _ in range(layers)]
    x_sets = [decode_tile(c, p8) for c in code_sets]
    kc_l = torch.zeros((layers, B, W, NKV, HD), dtype=torch.uint8,
                       device=dev)
    ks_l = torch.ones((layers, B, W, NKV), device=dev)
    vc_l, vs_l = kc_l.clone(), ks_l.clone()
    for i in range(layers):
        kvk.kv_append_rows(kc_l[i], ks_l[i], vc_l[i], vs_l[i], rows(W),
                           rows(W), torch.zeros(B, dtype=torch.int32,
                                                device=dev), p8)
    k_step, v_step = rows(1), rows(1)
    pos_step = torch.tensor([int(n) + 16 for n in lens], dtype=torch.int32,
                            device=dev)
    q_step = torch.from_numpy(rng.normal(0, 1, (B, 1, NH, HD)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    live = int(cache_len.sum())

    def k1(i, plain=False):
        return (decode_tile if plain else posit_decode)(code_sets[i], p8)

    def k2(i, plain=False):
        return (encode_tile if plain else posit_encode)(x_sets[i], p8)

    def k3(i, plain=False):
        fn = kvk.kv_append_rows_ref if plain else kvk.kv_append_rows
        kw = {} if plain else {"packed": False}
        return fn(kc_l[i], ks_l[i], vc_l[i], vs_l[i], k_step, v_step,
                  pos_step, p8, **kw)

    def k4(i, plain=False):
        fn = kvk.decode_attention_ref if plain else kvk.decode_attention
        kw = {} if plain else {"packed": False}
        return fn(q_step, kc_l[i], ks_l[i], vc_l[i], vs_l[i], cache_len,
                  p8, **kw)

    # 8b. K4's device time against the 64-row blocks each slot walks
    walk_us = {}
    for n_rows in (64, 256, 1024):
        cl_n = torch.full((B,), n_rows, dtype=torch.int32, device=dev)
        walk_us[n_rows // 64] = 1e3 * graph_ms(
            lambda i, _cl=cl_n: kvk.decode_attention(
                q_step, kc_l[i], ks_l[i], vc_l[i], vs_l[i], _cl, p8), layers)
    phase("phase 8b K4 device µs per call by blocks walked per slot (B=8, "
          "64 rows each): " + ", ".join(f"{k}: {v:.2f}"
                                        for k, v in walk_us.items())
          + f"; {(walk_us[16] - walk_us[1]) / 15:.2f} µs per block")

    byts = {
        "posit_decode": n_codes * (1 + 4),
        "posit_encode": n_codes * (4 + 1),
        "kv_append_rows": 2 * B * NKV * (HD * 4 + HD + 4) + B * 4,
        "decode_attention": 2 * live * NKV * (HD + 4) + B * 4
        + 2 * B * NH * HD * 4,
    }
    flops = {"decode_attention": live * NH * 4 * HD}
    fns = {"posit_decode": k1, "posit_encode": k2, "kv_append_rows": k3,
           "decode_attention": k4}
    out = []
    for name, fn in fns.items():
        ms = graph_ms(fn, layers)
        plain_ms = time_ms(lambda i: fn(i, plain=True), layers, iters=3,
                           reps=3)
        t_bytes = byts[name] / H100_BYTES_PER_S * 1e3
        t_ops = flops.get(name, 0) / H100_F32_FLOPS * 1e3
        src, repl = KERNELS[name]
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": main_launches[name],
            "launches_per_decode_step": per_step[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None})
    print(json.dumps({"kernels": out}), flush=True)

    # 9. last line ------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
