#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Builds the hand-written CUDA kernels (K1..K7) from ``src/repro_torch/csrc``,
holds each against its plain PyTorch version on the card, serves the
full-width paper-edge model through ``ServingEngine`` with a posit8 KV ring
and then a posit8 paged pool, checks card against CPU at float32 in both
layouts, runs the quickstart path at full width (the codec, K7 through
``qt_matmul`` on every weight matrix, five PAPER_EDGE train steps), checks
a train step card against CPU, trains full-width paper-edge through the
``Trainer`` under MIXED_TC (the posit16 gradient wire: K2 in its
normalising mode, then K1, on every gradient leaf) with checkpoints, a
crash and a restore, holds remat "dots" to "full", streams through the
threaded ``Orchestrator`` under injected faults, retry and the numeric
guard, runs the serve launcher, times every kernel and prints one JSON
line per contract.  Needs one CUDA GPU; run from the
repository root:

    python3 chip_smoke.py [--seed N]

Phases: 1 build; 2 K1 (every code of the 7 formats; 2^20 random codes over
many CTAs; misaligned views and ragged lengths); 3 K2 (every f32 bit
pattern for posit8_2 and posit16_2; misaligned views and ragged lengths);
4 K3 (f32 and bf16 rows, a strided v, a prefill that wraps inside the
call); 4b K5 (f32 and bf16 rows); 5 K4 (split boundaries, f32 and bf16 q);
5b K6 (split boundaries too); 6 ring main path; 6b ring decode-step
profile; 6c paged main path; 6d paged decode-step profile; 7 card vs CPU
(ring); 7b card vs CPU (paged); 8 kernel times (K1 also held to
decode_tile there); 8b K4 by blocks walked; 8c K6 by blocks walked over
the same rows, beside K4; 8d one paged decode layer's append as the step
calls it, and K5 at a prefill's T = 1024; 8e the same for the ring's K3; 9
K7 (both paths, the crossover's neighbours; posit8 and posit16 at every
es); 9b K7's two paths timed by M (the crossover); 10 the quickstart path
(serving's counterpart: training; part 2's device time); 10b train step
card vs CPU; then K7's times.  Phases 11a-11c run after 7b (own generator):
11a the speculative verify pass at float32, card vs CPU and vs five
sequential decode steps, and K3/K5 at T = 5 from bf16 rows; 11b rollback,
card vs CPU; 11c speculative serving (main path of K1) in both layouts at
gamma 2 and 4, each beside a baseline engine, printed as a
``{"speculative": ...}`` JSON line.  Phase 13 runs after 11c (own
generator): the paged posit8 engine of 6c (257 pages) with
``page_overcommit``; 13a the ``Orchestrator`` against the same engine's
``serve()`` at float32 and bf16 (TTFT, ITL, tokens/s); 13b a benign
``FaultPlan.random`` with retry and the guard; 13c a ``poison_logits``
fault fixed at ladder level 2, the rungs' re-decode times, and a
guard-armed idle decode step's profile beside 6d's; 13d a persistent
stage error and a stall under the watchdog; 13e
``repro_torch.launch.serve --full --async --energy`` with a fault plan,
as a subprocess; 13f (first, on the float32 engine) the float32 prefill
of the 8 prompts together, one by one and at their own buckets, and the
first layer and op where their rows differ; an ``{"orchestrator": ...}``
JSON line.  Phase 14 runs after 13: the modeled energy per token (TALU
Table IV per-MAC PDP, 20 pJ/B DRAM; not the card's energy) of phase 6's,
6c's and 11c's (ring, gamma 2) served runs, priced from meta-tensor
traces of each stage, and card vs CPU at smoke size; an
``{"energy": ...}`` JSON line.  Phase 12 runs
after 10b (own generators): 12a K2's wire mode (subnormals normalised, as
``core.posit.encode_f32``) on every f32 bit pattern for posit8_2 and
posit16_2, and on sampled inputs and views for every format; 12b the wire
on one full-width step's gradients, kernels against the plain versions on
the card, its launches (11 K2 + 11 K1), its time, K2 and K1 at the wi
leaf, and train steps with and without the wire; 12c the ``Trainer``
(MIXED_TC, batch 8 x 1024): 6 steps straight, then checkpoints every 3
steps under ``build/``, a crash at step 4 and a fresh ``Trainer`` that
restores and finishes, with checkpoint bytes and save / write / restore
times; 12d two steps each under remat "dots", "none" and "full" from one
state, in turns, with each one's step time and peak memory; a
``{"training": ...}`` JSON line.

Every phase asserts; nothing is caught.  Tolerances:
  K1, K2, K3, K5 bit-exact against decode_tile / encode_tile /
                 kv_append_rows_ref / paged_kv_append_rows_ref (NaN exactly
                 at NaR for K1; K3 and K5 from bf16 rows against the plain
                 version on the same values as f32; K5 on every pool row
                 outside trash page 0, where idle slots collide in no set
                 order).
  K4, K6         rtol 1e-5, atol 1e-5 against decode_attention_ref /
                 paged_decode_attention_ref on K/V of O(1) magnitude
                 (split vs dense softmax: f32 summation order); K4 with a
                 bf16 q rtol/atol 2^-7 against the plain version on the
                 same bf16 q (one bf16 rounding of the output).
  K7             rtol 2e-5, atol 2e-4 against posit_matmul_plain (the
                 reference's own tolerance: f32 accumulation order) on
                 weights encoded from N(0, 1); NaN exactly in a NaR column.
  card vs CPU    (a) the CPU's first two decode steps from the card's cache
                 and rows within rtol 1e-3, atol 1e-3 of the card's logits
                 (float32 model, TF32 off: matmul summation order); (b) the
                 caches each device wrote: scales equal, codes differing on
                 < 0.1 % of the written codes, each one posit step from its
                 counterpart (a value at a rounding midpoint) or, near zero,
                 within 2^-12 of the row's scale (posit8's spacing there is
                 below f32 noise), ring and paged.
  train step     card vs CPU at float32: loss rtol 1e-4, grad norm rtol
                 1e-3, every updated param and master leaf atol 1e-5.
  verify (11a)   card vs CPU from identical caches, and card vs five card
                 decode steps: logits rtol 1e-3, atol 1e-3; written codes
                 by the card-vs-CPU rule above; K3/K5 bit-exact.
  rollback (11b) bit-exact card vs CPU outside trash page 0.
  wire (12a, 12b) K2's wire mode bit-exact against encode_f32; the wire's
                 scales, codes, decoded gradients and residuals bit-exact
                 against quant.quantize / dequantize on the card from the
                 same gradients and residuals; exactly 11 K2 and 11 K1
                 launches per wire.
  Trainer (12c)  the restored state bit-exact against the checkpoint's
                 arrays; final loss of crash + restore within rtol 1e-5 of
                 the straight run's (the reference's own test tolerance:
                 the card's reductions need not repeat bit for bit);
                 losses finite, and lower on the first batch after the 6
                 steps; 66 K2 and 66 K1 launches in 6 steps.
  remat (12d)    "dots" and "none" vs "full" from one state: losses
                 equal, updated params and master within atol 1e-5
                 (phase 10b's).
  orchestrator   (13a) float32, TF32 off: streams admitted one by one
                 equal to the same engine's serve(); admitted together
                 (one B = 8 prefill at bucket 1024, a 50 ms batch
                 window) and bf16: equal tokens counted, not asserted
                 (13f: the card's GEMMs round a row by the row count,
                 from layer 0's QKV product); every stream terminal and
                 error-free, pool
                 drained, K3, K5 and K6 launched.  (13b) every stream
                 error-free, pool drained, un-poisoned streams equal to
                 13a's float32 serve().  (13c) guard.fallbacks == 2, level
                 2; the replaced row within 1e-3 of a decode_step at the
                 rung's policy on the raw weights from the true pre-round
                 state, and more than 1e-3 from one through the engine's
                 posit8-hoisted weights; the other 7 streams equal to
                 13a's.  (13d) all streams failed and the pool drained
                 after a persistent error; the watchdog fails a 2 s stall
                 in < 1.9 s.  (13e) exit 0, healthy, nothing in flight,
                 the energy table's header printed.
  prefill (13f)  reported, not asserted: where a float32 prefill's rows
                 first differ between B = 8 and B = 1 at bucket 1024, and
                 between bucket 1024 and the prompt's own bucket.
  energy (14)    no kernel launch and no device allocation (peak
                 included) while the table is built; every stage's MACs
                 equal to the analytic count from the config; at smoke
                 size the card's and the CPU's tables equal field for
                 field and J/token equal.
  speculative (11c) every request gets its 32 tokens, no page leaks, K1,
                 K3, K4 (and K5, paged) launched; the tokens equal to the
                 baseline's stream are counted, not asserted (decode reads
                 through K4/K6, the verify through K1 + chunk attention:
                 another summation order, so near ties may argmax apart).
The paged run's greedy tokens are compared with the ring run's and the
count printed, not asserted: K4 and K6 now share one split walk, but the
layouts batch the requests differently (one paged request waits for
pages), and a bf16 model's results depend on the batch.

Kernel times (the kernels JSON line): ``ms`` is the device time per
wrapper call, from a CUDA graph of 20 calls replayed between CUDA events,
so no host launch cost enters it (K4 and K6 are two kernels each, a
split walk and a combine, with q's scaling and the output cast inside, and
K7's split-K path is two kernels too);
``plain_ms`` is the plain PyTorch version per call, between CUDA events
around eager calls.  K1's entry also carries its time and bytes bound to
bf16 (``bf16_out``).  K7's entry also carries its M = 8 shape (``m8``),
``decoded_matmul_ms``, torch.matmul of x by the already decoded f32
weights: a labelled yardstick, not the same function (no PyTorch call
decodes posit codes, so ``library_ms`` is null), its tensor-core bound
(``bound_ms``: 3 bf16 passes at the tensor cores' peak) beside the bound
of the same product in f32 without tensor cores (``bound_f32_simt_ms``),
and the crossover between its two paths with the times it was set from.
K2's ``launches`` are the training path's (12c: the Trainer's 6 steps);
K1's and K2's entries carry ``launches_train`` (per step and total, 12c)
and ``wire_wi``, their time at the wire's largest leaf (wi's gradient,
37,748,736 values, posit16_2) against its bytes bound.  The decode-step and
train-step profiles (device busy, idle share) come from a torch.profiler
trace and read "not measured" where the trace holds no device events.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # non-tensor-core float32, H100 SXM
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores, H100 SXM

KERNELS = {
    "posit_decode": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_decode.py:68"),
    "posit_encode": ("src/repro_torch/csrc/posit_codec.cu",
                     "src/repro/kernels/posit_encode.py:81"),
    "kv_append_rows": ("src/repro_torch/csrc/kv_cache.cu",
                       "src/repro/kernels/kv_cache.py:150"),
    "decode_attention": ("src/repro_torch/csrc/kv_cache.cu",
                         "src/repro/kernels/kv_cache.py:259"),
    "paged_kv_append_rows": ("src/repro_torch/csrc/paged_kv.cu",
                             "src/repro/kernels/paged_kv.py:123"),
    "paged_decode_attention": ("src/repro_torch/csrc/paged_kv.cu",
                               "src/repro/kernels/paged_kv.py:234"),
    "posit_matmul": ("src/repro_torch/csrc/posit_matmul.cu",
                     "src/repro/kernels/posit_matmul.py:50"),
}
ALL_FORMATS = ("posit4_1", "posit8_0", "posit8_1", "posit8_2", "posit16_0",
               "posit16_1", "posit16_2")
EXHAUSTIVE_FORMATS = ("posit8_2", "posit16_2")
# the main path's shape: max_batch 8, max_len 1024, 4 KV heads of 64
B, W, NKV, HD, NH = 8, 1024, 4, 64, 12
# the paged main path: 16-row pages, Pmax = W / PS logical pages per slot,
# a full pool of 1 trash page + B * Pmax; the engine run uses half of it
PS = 16
PMAX = W // PS
POOL_PAGES = 1 + B * PMAX
ENGINE_PAGES = 257
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


def device_events(prof, launches=None):
    """Total device µs by short kernel name in a profiler trace; where a
    dict ``launches`` is given, the kernel launches by name are added to
    it (copies, as a cast runs, are named ``*[copy]``; memcpy and memset
    are not kernels and are left out)."""
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
        elif "copy_kernel" in e.name:
            name += "[copy]"
        out[name] = out.get(name, 0.0) + e.time_range.elapsed_us()
        if launches is not None and not e.name.startswith("Mem"):
            launches[name] = launches.get(name, 0) + 1
    return out


PREFILL_OPS = ("ln", "qkv", "attention", "wo", "ln2", "mlp")


def prefill_taps(api, params, prompts, width):
    """Prefill ``prompts`` through ``api`` (a ``TransprecisionEngine``) at
    bucket ``width`` in one call and return the prefix with the
    intermediates of each op, in order: per layer ``PREFILL_OPS`` (the
    QKV output before RoPE, the attention output after it), then the final
    norm and one head product per row.  The serving model's module-level
    functions are wrapped for the call and restored after it."""
    import torch
    from repro_torch.models import attention as att
    from repro_torch.models import serve_model as sm
    taps = []

    def tapped(fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            taps.append(out if isinstance(out, tuple) else (out,))
            return out
        return run

    names = ("rms_norm", "_qkv", "_einsum", "_mlp")
    saved = [getattr(sm, n) for n in names] + [att.blockwise_attention]
    for n, fn in zip(names, saved):
        setattr(sm, n, tapped(fn))
    att.blockwise_attention = tapped(saved[-1])
    toks = np.zeros((len(prompts), width), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    try:
        prefix = api.prefill(params, torch.from_numpy(toks),
                             torch.tensor([len(p) for p in prompts]))
    finally:
        for n, fn in zip(names, saved):
            setattr(sm, n, fn)
        att.blockwise_attention = saved[-1]
    n_layers = len(taps[:-1 - len(prompts)]) // len(PREFILL_OPS)
    labels = [f"layer {i} {op}" for i in range(n_layers)
              for op in PREFILL_OPS] + ["final norm"]
    body = dict(zip(labels, taps))
    body["head"] = (torch.cat([t[0] for t in taps[len(labels):]]),)
    return prefix, body


def first_difference(a, ia, b, ib, n):
    """The first op, in the model's order, at which row ``ia`` of the taps
    ``a`` differs from row ``ib`` of ``b`` over the first ``n`` positions,
    with the largest |difference| there, and the differing K/V codes and
    scales of the two prefixes' first ``n`` rows."""
    first, worst = None, 0.0
    for op in a[1]:
        for x, y in zip(a[1][op], b[1][op]):
            x, y = x[ia], y[ib]
            if x.ndim and op != "head":
                x, y = x[:n], y[:n]
            d = float((x.float() - y.float()).abs().max())
            if d > 0 and first is None:
                first, worst = op, d
    ka, kb = a[0]["cache"]["blocks"][0], b[0]["cache"]["blocks"][0]
    kv = sum(int((ka[k][:, ia, :n] != kb[k][:, ib, :n]).sum()) for k in ka)
    return first, worst, kv


def phase13f(e, prompts) -> dict:
    """13f. Is a prompt's float32 prefill independent of its batch on the
    card?  Phase 13's paged posit8 engine (TF32 off) prefills the 8
    prompts (i) together at bucket W, (ii) one at a time at W and (iii)
    one at a time at each prompt's own bucket; reports, per comparison,
    the first layer and op at which a row differs and the largest
    difference there, the logits' largest difference and the differing
    K/V codes and scales.  (i) against (ii) changes only the GEMMs' row
    count; (ii) against (iii) that and the attention's padded width."""
    import torch
    assert not torch.backends.cuda.matmul.allow_tf32
    api = e.engine
    together = prefill_taps(api, e.params, prompts, W)
    res = {"i_vs_ii": [], "ii_vs_iii": []}
    for i, p in enumerate(prompts):
        n = len(p)
        alone = prefill_taps(api, e.params, [p], W)
        own = prefill_taps(api, e.params, [p], api.bucket_for(n))
        for key, (a, ia, b) in (("i_vs_ii", (together, i, alone)),
                                ("ii_vs_iii", (alone, 0, own))):
            first, worst, kv = first_difference(a, ia, b, 0, n)
            logits = float((a[1]["head"][0][ia] - b[1]["head"][0][0]).abs()
                           .max())
            res[key].append({"prompt_tokens": n, "first": first,
                             "first_max_abs": worst,
                             "logits_max_abs": logits,
                             "kv_differing": kv})
        del alone, own
    del together
    torch.cuda.empty_cache()
    out = {}
    for key, rows in res.items():
        firsts = [r["first"] for r in rows if r["first"] is not None]
        out[key] = {
            "rows_differing": len(firsts),
            "first_ops": sorted(set(firsts)),
            "logits_max_abs": max(r["logits_max_abs"] for r in rows),
            "kv_differing": sum(r["kv_differing"] for r in rows),
            "per_prompt": rows}
    phase("phase 13f float32 prefill rows vs batch (TF32 off, bucket "
          f"{W}): (i) together vs (ii) alone: "
          f"{out['i_vs_ii']['rows_differing']} of 8 prompts differ, first at {out['i_vs_ii']['first_ops']}, "
          f"logits max |diff| {out['i_vs_ii']['logits_max_abs']:.3e}, K/V "
          f"codes/scales differing {out['i_vs_ii']['kv_differing']}; (ii) "
          f"vs (iii) own bucket: {out['ii_vs_iii']['rows_differing']} differ,"
          f" first at {out['ii_vs_iii']['first_ops']}, logits max |diff| "
          f"{out['ii_vs_iii']['logits_max_abs']:.3e}, K/V differing "
          f"{out['ii_vs_iii']['kv_differing']}; per prompt (tokens, first "
          "op, its max |diff|): "
          + "; ".join(f"{r['prompt_tokens']}: {r['first']} "
                      f"{r['first_max_abs']:.3e}"
                      for r in res["i_vs_ii"]))
    return out


def phase13(dev, seed, cfg, params, cfg32, params32, prompts, warm,
            profile_steps, prof_busy, busy_6d) -> dict:
    """13. The serving orchestrator and its robustness at full width on
    the paged posit8 engine (phase 6c's pool of 257 pages, overcommitted):
    13a the ``Orchestrator`` against the same engine's ``serve()`` (float32,
    TF32 off: streams equal; bf16: equal tokens counted), TTFT / ITL
    percentiles and tokens/s; 13b a benign ``FaultPlan.random`` with retry
    and the guard; 13c a ``poison_logits`` fault fixed at ladder level 2:
    the rung's row against a decode step at the rung's policy from the
    pre-round state, the rungs' re-decode times, and a guard-armed but idle
    decode step's profile against phase 6d's; 13d a persistent stage error
    and a stalled stage under the watchdog; 13e the serve launcher as a
    subprocess, with ``--energy``; 13f (first) ``phase13f``.  Returns the
    ``{"orchestrator": ...}`` line's object."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.models import serve_model as sm
    from repro_torch.serve import (Fault, FaultPlan, InjectedFault,
                                   Orchestrator, OrchestratorConfig, Request,
                                   RetryPolicy, ServeConfig, ServingEngine,
                                   StreamingRequest)
    from repro_torch.serve.guard import pre_round

    rng13 = np.random.default_rng([seed, 13])
    paged = dict(max_batch=8, max_len=W, kv_format="posit8",
                 kv_layout="paged", page_size=PS, num_pages=ENGINE_PAGES)
    scfg = ServeConfig(page_overcommit=True, **paged)
    retry = RetryPolicy(backoff_s=0.001, max_backoff_s=0.01)
    path = ("kv_append_rows", "paged_kv_append_rows",
            "paged_decode_attention")
    batched = OrchestratorConfig(batch_window_s=0.05)   # one admission
    out = {}

    def engine(c, p, **kw):
        # the constructor loads the kernel libraries on this thread, before
        # any orchestrator thread exists
        return ServingEngine(c, p, kw.pop("scfg", scfg),
                             policy="paper_edge_p8", device=dev, **kw)

    def drained(e):
        e.allocator.assert_consistent()
        assert e.allocator.live_pages == 0, e.allocator.live_pages

    def serve_sync(e, max_new=32):
        reqs = [Request(uid=i, prompt=p, max_new=max_new)
                for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert all(r.done and r.error is None
                   and len(r.out_tokens) == max_new for r in reqs)
        drained(e)
        return [list(r.out_tokens) for r in reqs], wall

    def orchestrate(e, ocfg, staggered=False, max_new=32):
        """The 8 prompts through an orchestrator over ``e``, every kernel
        count set to 0 just before and read just after.  ``staggered``
        submits each prompt once the previous one has streamed its first
        token, so each is admitted through a prefill of its own, as
        ``serve()`` admits them."""
        sreqs = [StreamingRequest(p.tolist(), max_new=max_new)
                 for p in prompts]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with Orchestrator(e, ocfg) as orch:
            for s in sreqs:
                assert orch.submit(s, timeout=60.0)
                while staggered and not s.token_t and not s.done:
                    time.sleep(0.0005)
            for s in sreqs:
                assert s.wait(300.0), "stream never reached a terminal state"
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: LAUNCHES[k] for k in path}
        assert all(s.error is None and len(s.out_tokens) == max_new
                   for s in sreqs), [s.error for s in sreqs]
        assert all(v > 0 for v in launches.values()), launches
        drained(e)
        h = orch.health()
        assert h["in_flight"] == 0 and h["healthy"], h
        return sreqs, wall, launches

    def pct(xs):
        return {"p50_ms": float(np.percentile(xs, 50)) * 1e3,
                "p99_ms": float(np.percentile(xs, 99)) * 1e3}

    # 13a. the orchestrator against the same engine's serve(): the 8
    # prompts admitted together (one bucketed prefill: TTFT, ITL, tok/s)
    # and, at float32, one by one (each its own prefill, as serve() admits
    # them: the streams must be serve()'s) --------------------------------
    def equal_tokens(sreqs, ref):
        return sum(a == b for s, r in zip(sreqs, ref)
                   for a, b in zip(s.out_tokens, r))

    for dtype, c, p in (("float32", cfg32, params32),
                        ("bfloat16", cfg, params)):
        e = engine(c, p)
        if dtype == "float32":
            out["13f"] = phase13f(e, prompts)
        e.serve([Request(uid=-1, prompt=warm, max_new=3)])      # warm-up
        ref, s_wall = serve_sync(e)
        ev = e.stats["evictions"]
        sreqs, o_wall, launches = orchestrate(e, batched)
        cell = {"ttft": pct([s.ttft_s for s in sreqs]),
                "itl": pct([g for s in sreqs for g in s.itl_s()]),
                "tok_s": {"serve": 256 / s_wall, "orchestrator":
                          256 / o_wall},
                "wall_s": {"serve": s_wall, "orchestrator": o_wall},
                "evictions": {"serve": ev, "orchestrator":
                              e.stats["evictions"] - ev},
                "launches": launches,
                "tokens_equal_to_serve": equal_tokens(sreqs, ref)}
        if dtype == "float32":
            batched32 = [list(s.out_tokens) for s in sreqs]
            one_by_one, _, launches_1 = orchestrate(e, OrchestratorConfig(),
                                                    staggered=True)
            cell["one_by_one"] = {
                "tokens_equal_to_serve": equal_tokens(one_by_one, ref),
                "launches": launches_1}
        out[f"13a_{dtype}"] = cell
        phase(f"phase 13a orchestrator vs serve() on one paged posit8 "
              f"engine ({ENGINE_PAGES} pages, overcommit), {dtype}: TTFT "
              f"p50/p99 {cell['ttft']['p50_ms']:.2f}/"
              f"{cell['ttft']['p99_ms']:.2f} ms, ITL p50/p99 "
              f"{cell['itl']['p50_ms']:.3f}/{cell['itl']['p99_ms']:.3f} ms; "
              f"{cell['tok_s']['orchestrator']:.1f} tok/s against serve()'s "
              f"{cell['tok_s']['serve']:.1f}; evictions {cell['evictions']}; "
              f"launches {launches}; tokens equal to serve()'s "
              f"{cell['tokens_equal_to_serve']} of 256 admitted together "
              "(not asserted: one B = 8 prefill at bucket 1024 against "
              "8 single ones, whose GEMMs round by row count, 13f)"
              + (f", {cell['one_by_one']['tokens_equal_to_serve']} of 256 "
                 "admitted one by one (asserted)" if dtype == "float32"
                 else ""))
        if dtype == "float32":
            assert [s.out_tokens for s in one_by_one] == ref
            ref32 = ref
        del e

    # 13b. a benign random fault plan with retry and the guard, float32;
    # the fault-free run is 13a's with the same admission ---------------
    plan = FaultPlan.random(6, n=6, rounds=25, slots=8)
    e = engine(cfg32, params32, faults=plan, retry=retry, guard=True)
    sreqs, wall_b, launches = orchestrate(e, batched)
    poisoned = e.faults.uids_poisoned
    clean = [i for i, s in enumerate(sreqs) if s._req.uid not in poisoned]
    same = sum(sreqs[i].out_tokens == batched32[i] for i in clean)
    c = e.metrics.snapshot()["counters"]
    kinds = sorted({ev["kind"] for ev in e.faults.events})
    out["13b"] = {"plan": "random:seed=6,n=6,rounds=25,slots=8",
                  "fired": len(e.faults.events), "kinds": kinds,
                  "retries": int(c.get("stage.retries", 0)),
                  "evictions": e.stats["evictions"],
                  "guard_fallbacks": int(c.get("guard.fallbacks", 0)),
                  "poisoned": len(poisoned), "clean_equal": same,
                  "clean": len(clean), "wall_s": wall_b,
                  "launches": launches}
    phase(f"phase 13b benign FaultPlan.random(6) with retry and the guard "
          f"(float32): {len(e.faults.events)} faults fired {kinds}, "
          f"{out['13b']['retries']} retries, {e.stats['evictions']} "
          f"evictions, guard fallbacks {out['13b']['guard_fallbacks']}; "
          f"every stream terminal and error-free, pool drained; "
          f"un-poisoned streams equal to the fault-free run (13a's, "
          f"admitted together) {same} of "
          f"{len(clean)}; wall {wall_b:.3f} s")
    assert clean and same == len(clean)
    if poisoned:
        assert c["guard.fallbacks"] > 0
    del e

    # 13c. a poisoned slot re-decoded up the ladder (fixed at level 2) --
    e = engine(cfg32, params32, faults=FaultPlan((Fault(
        "poison_logits", at=3, slot=0, fixed_by_level=2),)), guard=True)
    kept, got, build_ms = {}, {}, {}
    generate, check = e.engine.generate, e.guard.check_round
    build = e.guard.rung

    def build_timed(lvl):               # a rung's first use hoists
        if lvl in e.guard._rungs:
            return build(lvl)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = build(lvl)
        torch.cuda.synchronize()
        build_ms[f"level{lvl}"] = 1e3 * (time.perf_counter() - t0)
        return r

    def generate_kept(p, state):        # the true pre-round state
        kept["state"] = {**state, "pos": state["pos"].clone(),
                         "tok": state["tok"].clone(),
                         "page_table": state["page_table"].clone(),
                         "blocks": tuple({k: v.clone() for k, v in b.items()}
                                         for b in state["blocks"])}
        return generate(p, state)

    def check_timed(prev, logits, active, poisons=None):
        if not poisons:
            return check(prev, logits, active, poisons)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(prev, logits, active, poisons)
        torch.cuda.synchronize()
        (slot,) = poisons
        got.update(first_ms=1e3 * (time.perf_counter() - t0), slot=slot,
                   row=logits[slot].copy(), state=kept["state"])

    e.engine.generate, e.guard.check_round = generate_kept, check_timed
    e.guard.rung = build_timed
    reqs = [Request(uid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    e.serve(reqs)
    e.engine.generate, e.guard.rung = generate, build
    drained(e)
    c = e.metrics.snapshot()["counters"]
    (uid,) = e.faults.uids_poisoned
    top = e.guard.ladder[1]
    st, slot = got["state"], got["slot"]
    want = sm.decode_step(params32, pre_round(st), st["tok"], cfg32,
                          top)[0][slot].float().cpu().numpy()
    hoisted = sm.decode_step(e.params, pre_round(st), st["tok"], cfg32,
                             lm.weights_free(top))[0][slot].float().cpu(
                             ).numpy()
    d_rung = float(np.abs(got["row"] - want).max())
    d_p8 = float(np.abs(got["row"] - hoisted).max())
    neighbours = [r.out_tokens == ref32[r.uid] for r in reqs if r.uid != uid]
    rung_ms = {}
    for lvl in (1, 2):
        stages, rp = e.guard.rung(lvl)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stages.generate(rp, pre_round(st))[1][slot].float().cpu()
            ts.append(1e3 * (time.perf_counter() - t0))
        rung_ms[f"level{lvl}"] = statistics.median(ts)
    out["13c"] = {"fallbacks": int(c["guard.fallbacks"]),
                  "level": e.guard.level(uid),
                  "row_vs_decode_step_max_abs": d_rung,
                  "row_vs_posit8_hoisted_max_abs": d_p8,
                  "first_quarantine_ms": got["first_ms"],
                  "rung_build_ms": build_ms, "redecode_ms": rung_ms,
                  "neighbours_equal": sum(neighbours)}
    phase(f"phase 13c poison_logits fixed at level 2 (float32): guard "
          f"fallbacks {c['guard.fallbacks']}, level {e.guard.level(uid)}; "
          f"the replaced row vs a decode_step at the rung's policy from the "
          f"pre-round state max |diff| {d_rung:.3e} (1e-3), vs the engine's "
          f"posit8-hoisted weights {d_p8:.3e}; first quarantine (both rungs "
          f"hoisted, two re-decodes) {got['first_ms']:.1f} ms, of which "
          f"building the rungs {build_ms['level1']:.1f} / "
          f"{build_ms['level2']:.1f} ms; later "
          f"re-decodes (clone + generate + row) {rung_ms['level1']:.2f} / "
          f"{rung_ms['level2']:.2f} ms at levels 1 / 2; neighbours' streams "
          f"equal to the fault-free run {sum(neighbours)} of 7")
    assert c["guard.fallbacks"] == 2 and c["guard.nonfinite_rows"] == 1
    assert c["guard.exhausted"] == 0 and e.guard.level(uid) == 2
    assert d_rung <= 1e-3 < d_p8, (d_rung, d_p8)
    assert all(neighbours)
    del e, got, kept

    # a guard-armed, idle decode step against phase 6d's (bf16, 6c's
    # engine): one dict copy per step, no clone ------------------------
    e = engine(cfg, params, scfg=ServeConfig(**paged), guard=True)
    e.serve([Request(uid=-1, prompt=warm, max_new=3)])
    e.add_requests([Request(uid=100 + i, prompt=p, max_new=32)
                    for i, p in enumerate(prompts)])
    wall_g, per_step_g, device_g = profile_steps(e.step)
    busy_g = prof_busy[-1]
    e.serve([])
    drained(e)
    assert e.metrics.snapshot()["counters"]["guard.nonfinite_rows"] == 0
    out["guard_idle_step"] = {"wall_ms": wall_g, "busy_ms": busy_g,
                              "busy_ms_6d": busy_6d,
                              "launches_per_step": {
                                  k: per_step_g[k] for k in path}}
    phase(f"phase 13c' guard armed but idle, paged decode step (bf16): wall "
          f"{wall_g:.3f} ms/step, {device_g}; phase 6d's busy "
          + (f"{busy_6d:.3f} ms/step" if busy_6d is not None
             else "not measured"))
    del e

    # 13d. lethal: a persistent stage error; a stall under the watchdog --
    sub = [rng13.integers(0, cfg.vocab, int(n))
           for n in rng13.integers(64, 513, 4)]
    e = engine(cfg, params, faults=FaultPlan((Fault(
        "stage_error", stage="generate", at=2, transient=False),)),
        retry=retry)
    orch = Orchestrator(e, OrchestratorConfig())
    sreqs = [StreamingRequest(p.tolist(), max_new=32) for p in sub]
    for s in sreqs:
        assert orch.submit(s, timeout=60.0)
    for s in sreqs:
        assert s.wait(120.0)
    assert all(s.error for s in sreqs) and not orch.healthy
    assert isinstance(orch.worker_exc, InjectedFault)
    orch.close()
    drained(e)
    del e
    e = engine(cfg, params, faults=FaultPlan((Fault(
        "stage_delay", stage="generate", at=2, delay_s=2.0),)))
    orch = Orchestrator(e, OrchestratorConfig(watchdog_s=0.2))
    s = StreamingRequest(sub[0].tolist(), max_new=300)
    t0 = time.perf_counter()
    assert orch.submit(s)
    assert s.wait(60.0)
    waited = time.perf_counter() - t0
    assert waited < 1.9 and "watchdog" in s.error and not orch.healthy
    orch.close()                    # joins the scheduler after the stall
    drained(e)
    out["13d"] = {"persistent_error": "contained",
                  "watchdog_failed_after_s": waited}
    phase(f"phase 13d lethal: a persistent generate error contained (4 "
          f"streams failed, orchestrator unhealthy, pool drained); a 2 s "
          f"stall against watchdog_s 0.2 failed its stream after "
          f"{waited:.3f} s (< 1.9), pool drained after close")
    del e

    # 13e. the serve launcher at full width, as a subprocess ------------
    argv = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
            "--async", "--kv-layout", "paged", "--kv-format", "posit8",
            "--overcommit", "--fault-plan", "random:seed=3,n=6", "--health",
            "--energy"]
    t0 = time.perf_counter()
    run = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ,
                                               PYTHONPATH=str(ROOT / "src")))
    took = time.perf_counter() - t0
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    health = json.loads(next(line for line in run.stdout.splitlines()
                             if line.startswith("health: "))[8:])
    assert health["healthy"] and health["in_flight"] == 0, health
    assert health["engine"]["live_pages"] == 0, health
    assert "terminal errors" not in run.stdout, run.stdout[-3000:]
    lat = [line for line in run.stdout.splitlines()
           if line.startswith(("TTFT", "ITL"))]
    energy_head = [line for line in run.stdout.splitlines()
                   if line.startswith("energy (modeled: TALU Table IV")]
    assert len(energy_head) == 1, run.stdout[-3000:]
    assert "not priced" not in run.stdout, run.stdout[-3000:]
    out["13e"] = {"argv": argv[3:], "seconds": took,
                  "counters": health["counters"], "latency": lat,
                  "energy": energy_head[0]}
    fired = health["counters"].get("faults.injected", 0)
    phase(f"phase 13e launcher `{' '.join(argv[2:])}`: exit 0 in "
          f"{took:.1f} s, healthy, nothing in flight, pool drained; "
          f"{'; '.join(lat)}; faults {fired} fired, guard fallbacks "
          f"{health['counters'].get('guard.fallbacks', 0)}; {energy_head[0]}")
    return out


def analytic_mac_flops(cfg, stage: str, spec, page_size: int) -> int:
    """A stage's product FLOPs from the config and its spec's shapes (2 per
    MAC): every weight product at each token it runs on (the head at each
    prefill row's last position only), plus QK and PV over the attention's
    rows: the padded prompt for prefill (every q block against every kv
    block, as the blockwise loop runs), the ring's width or the page
    table's rows for generate and verify.  insert and rollback run no
    product."""
    d, nh, nkv, hd, ff, n_l = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, cfg.d_ff, cfg.n_layers)
    wi = 2 * ff if cfg.mlp == "swiglu" else ff
    per_token = n_l * (d * (nh + 2 * nkv) * hd + nh * hd * d + d * wi
                       + ff * d)
    head = d * cfg.vocab_pad
    stage = stage.split(".")[-1]
    if stage in ("insert", "rollback"):
        return 0
    if stage == "prefill":
        b, s = spec[1].shape
        qb, kb = min(cfg.q_block, s), min(cfg.kv_block, s)
        sp, skp = -(-s // qb) * qb, -(-s // kb) * kb
        return (2 * b * s * per_token + 2 * b * head
                + 4 * b * n_l * nh * sp * skp * hd)
    state = spec[1]
    rows = (state["page_table"].shape[1] * page_size
            if "page_table" in state else state["blocks"][0]["k"].shape[2])
    b = state["tok"].shape[0]
    t = spec[2].shape[1] if stage == "verify" else 1
    return 2 * b * t * (per_token + head) + 4 * b * t * n_l * nh * rows * hd


def phase14(dev, seed, runs) -> dict:
    """14. Modeled energy per token (TALU Table IV per-MAC PDP, 20 pJ/B
    DRAM: a model of the paper's edge device, not the card's energy).
    14a prices the full-width engines of ``runs`` (label -> (driver, the
    served run's stage calls, its tokens)): the table from meta-tensor
    traces of each stage's recorded spec, with no kernel launched and no
    device memory allocated while it is built, every stage's MACs equal to
    ``analytic_mac_flops``, and the J/token of the run's window (draft
    stages apart from the target's).  14b serves the same seeded requests
    at smoke size on a card engine and a CPU engine, ring and paged: the
    two tables equal field for field, and J/token equal."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models import lm
    from repro_torch.obs import EnergyAccountant, energy
    from repro_torch.serve import Request, ServeConfig, ServingEngine

    out = {"model": "modeled (TALU Table IV, 20 pJ/B DRAM)",
           "priced_at": "each stage's first call's shapes (a run's "
                        "prefills at the warm-up's bucket), every call "
                        "alike, as the reference prices",
           "runs": {}}
    for label, (driver, calls, tokens) in runs.items():
        energy._COST_CACHE.clear()          # time the traces themselves
        acct = EnergyAccountant(driver)
        # no collection of older garbage (which may hold device tensors)
        # while the table is built: any change is the trace's own
        gc.collect()
        torch.cuda.synchronize()
        launches0, mem0 = dict(LAUNCHES), torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gc.disable()
        try:
            t0 = time.perf_counter()
            table = acct.table()
            secs = time.perf_counter() - t0
        finally:
            gc.enable()
        mem = (torch.cuda.memory_allocated(),
               torch.cuda.max_memory_allocated())
        assert dict(LAUNCHES) == launches0, label
        assert mem == (mem0, mem0), (label, mem0, mem)
        engines = [driver.engine] + ([driver.draft_engine] if hasattr(
            driver, "draft_engine") else [])
        prefill_shape = {}
        for eng in engines:
            for name, (_, spec) in eng.stage_specs.items():
                if name.endswith("prefill"):        # (B, bucket) tokens
                    prefill_shape[name] = list(spec[1].shape)
                want = analytic_mac_flops(driver.cfg, name, spec,
                                          eng.policy.kv_page_size)
                assert table[name].mac_flops == want, (label, name,
                                                        table[name].mac_flops,
                                                        want)
        bd = acct.breakdown(calls=calls, tokens=tokens)
        assert "errors" not in bd, bd["errors"]
        draft_j = sum(st["joules"] for name, st in bd["stages"].items()
                      if name.startswith("draft."))
        out["runs"][label] = {
            "tokens": tokens, "joules": bd["joules_total"],
            "joules_per_token": bd["joules_per_token"],
            "joules_draft": draft_j,
            "joules_target": bd["joules_total"] - draft_j,
            "pricing_s": secs, "prefill_priced_at": prefill_shape,
            "stages": {name: {
                "calls": st["calls"], "pj_per_call": st["pj_per_call"],
                "compute_share": st["pj_compute"] / st["pj_per_call"],
                "mac_flops": st["mac_flops"],
                "model_bytes": st["model_bytes"],
                "mac_mix": st["mac_mix"]}
                for name, st in bd["stages"].items()}}
        phase(f"phase 14a {label}: modeled (TALU Table IV, 20 pJ/B DRAM) "
              f"{bd['joules_per_token'] * 1e6:.3f} uJ/token over {tokens} "
              f"tokens ({bd['joules_total'] * 1e3:.3f} mJ"
              + (f", draft stages {draft_j * 1e3:.3f} mJ" if draft_j
                 else "")
              + f"); every prefill priced at its first call's (B, bucket) "
              f"{prefill_shape}; priced in {secs:.3f} s with no launch and "
              "no device allocation; MACs equal to the analytic count for "
              + ", ".join(f"{name} ({st['calls']} calls, "
                          f"{st['pj_per_call'] * 1e-6:.2f} uJ/call)"
                          for name, st in bd["stages"].items()))

    # 14b. card vs CPU at smoke size -----------------------------------
    cfg_s = dataclasses.replace(get_config("paper-edge", smoke=True),
                                dtype_name="float32")
    params_s = lm.init_params(cfg_s, torch.Generator().manual_seed(seed),
                              device="cpu")
    rng14 = np.random.default_rng([seed, 14])
    prompts_s = [rng14.integers(0, cfg_s.vocab, int(n))
                 for n in rng14.integers(4, 40, 6)]
    smoke = {}
    for layout in ("ring", "paged"):
        bds = []
        for device in (dev, "cpu"):
            e = ServingEngine(cfg_s, params_s, ServeConfig(
                max_batch=4, max_len=64, kv_format="posit8",
                kv_layout=layout), policy="paper_edge_p8", device=device)
            e.serve([Request(uid=i, prompt=p, max_new=8)
                     for i, p in enumerate(prompts_s)])
            energy._COST_CACHE.clear()
            bds.append(EnergyAccountant(e).breakdown())
        card, cpu = bds
        assert card["stages"] == cpu["stages"], layout
        assert card["tokens"] == cpu["tokens"] == 48, layout
        assert card["joules_per_token"] == cpu["joules_per_token"], layout
        smoke[layout] = card["joules_per_token"]
    out["smoke_card_vs_cpu"] = {"joules_per_token": smoke, "equal": True}
    phase(f"phase 14b smoke card vs CPU (ring, paged): tables equal field "
          f"for field, J/token equal: {smoke}")
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
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels.posit_decode import decode_tile, posit_decode
    from repro_torch.kernels.posit_encode import encode_tile, posit_encode
    from repro_torch.models import lm
    from repro_torch.obs import EnergyAccountant
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

    # 2. K1 vs decode_tile: every code of every format, also from views
    # that start off a 16-byte boundary, at lengths not a multiple of 16 --
    for name in ALL_FORMATS:
        fmt = get_fmt(name)
        codes = torch.arange(1 << fmt.bits, dtype=torch.int64, device=dev)
        codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes).to(
            _build.code_dtype(fmt))
        nar = torch.zeros_like(codes, dtype=torch.bool)
        nar[1 << (fmt.bits - 1)] = True
        more = torch.cat([codes, codes.flip(0), codes[:37]])
        for cv in (codes, more[1:], more[3:-2], more[15:]):
            for out_dtype in (torch.float32, torch.bfloat16):
                before = LAUNCHES["posit_decode"]
                got = posit_decode(cv, fmt, out_dtype=out_dtype)
                assert LAUNCHES["posit_decode"] == before + 1
                want = decode_tile(cv, fmt, out_dtype)
                assert bits_equal(got, want), (name, out_dtype, cv.numel(),
                                               cv.data_ptr() % 16)
                if cv is codes:
                    assert torch.equal(torch.isnan(got), nar), name
    # ... and on 2^20 + 37 random codes: many CTAs, every load slot of a
    # thread (own generator: the later phases draw what they drew before)
    rng_k1 = np.random.default_rng([args.seed, 6])
    for name in ("posit4_1", "posit8_2", "posit16_2"):
        fmt = get_fmt(name)
        big = torch.from_numpy(rng_k1.integers(
            0, 1 << fmt.bits, (1 << 20) + 37).astype(np.int64)).to(dev)
        big = torch.where(big >= 1 << 15, big - (1 << 16), big).to(
            _build.code_dtype(fmt))
        for cv in (big, big[1:], big[3:-2], big[15:]):
            for out_dtype in (torch.float32, torch.bfloat16):
                before = LAUNCHES["posit_decode"]
                got = posit_decode(cv, fmt, out_dtype=out_dtype)
                assert LAUNCHES["posit_decode"] == before + 1
                assert bits_equal(got, decode_tile(cv, fmt, out_dtype)), (
                    name, out_dtype, cv.numel(), cv.data_ptr() % 16)
    phase(f"phase 2 K1 posit_decode bit-exact on every code of "
          f"{', '.join(ALL_FORMATS)} (f32 and bf16 out), also as views "
          f"c[1:], c[3:-2], c[15:] of every code twice and 37 more "
          f"(scalar heads and tails), and on 2^20 + 37 random posit4_1, "
          f"posit8_2 and posit16_2 codes and the same views; one launch "
          f"per call")

    # 3. K2 vs encode_tile: every f32 bit pattern for posit8_2 and
    # posit16_2; every format on sampled inputs, also from a view that
    # starts off a 16-byte boundary and at lengths not a multiple of 4 ---
    t3 = time.perf_counter()
    normal = rng.normal(0, 1, 1 << 16).astype(np.float32)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        1.4e-45, -1.17e-38, 1.18e-38, 3.4e38, -3.4e38],
                       np.float32)
    pats = rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(
        np.uint32).view(np.float32)
    x = torch.from_numpy(np.concatenate(
        [normal, normal * 1e-8, normal * 1e8, special, pats])).to(dev)
    views = (x, x[1:], x[:-1], x[3:-2])     # heads 0/3/0/1, tails 0/0/3/2
    for name in ALL_FORMATS:
        fmt = get_fmt(name)
        for xv in views:
            before = LAUNCHES["posit_encode"]
            assert bits_equal(posit_encode(xv, fmt), encode_tile(xv, fmt)), \
                (name, xv.numel(), xv.data_ptr() % 16)
            assert LAUNCHES["posit_encode"] == before + 1
    t_sampled = time.perf_counter() - t3
    chunk = 1 << 26
    for name in EXHAUSTIVE_FORMATS:
        fmt = get_fmt(name)
        for c0 in range(0, 1 << 32, chunk):
            p_ = torch.arange(c0, c0 + chunk, dtype=torch.int64, device=dev)
            xs = torch.where(p_ >= 1 << 31, p_ - (1 << 32), p_).to(
                torch.int32).view(torch.float32)
            assert torch.equal(posit_encode(xs, fmt), encode_tile(xs, fmt)), \
                (name, c0)
        del p_, xs
    torch.cuda.synchronize()
    phase(f"phase 3 K2 posit_encode bit-exact on all 2^32 f32 bit patterns "
          f"for {', '.join(EXHAUSTIVE_FORMATS)} (chunks of 2^26 from "
          f"torch.arange; {time.perf_counter() - t3 - t_sampled:.1f} s), and "
          f"for {', '.join(ALL_FORMATS)} on {x.numel()} inputs (normal at 1, "
          f"1e-8, 1e8; +-0, +-inf, NaN, subnormals; 2^20 random bit "
          f"patterns) as x, x[1:], x[:-1] and x[3:-2] (scalar heads and "
          f"tails); phase {time.perf_counter() - t3:.1f} s")

    # 4. K3 vs kv_append_rows_ref at the main path's shape -------------
    def fresh_ring(fmt, packed, lead=(B, W), src=rng):
        """Random codes and pow2 scales from ``src``: a ring (B, W, NKV, ...)
        or, with ``lead`` (R,), a flat pool (R, NKV, ...)."""
        dc = kvk.code_channels(HD, fmt, packed)
        hi = 1 << (8 if fmt.bits <= 8 else 16)
        codes = torch.from_numpy(src.integers(0, hi, lead + (NKV, dc))).to(
            dev)
        codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes) \
            if fmt.bits > 8 else codes
        codes = codes.to(_build.code_dtype(fmt))
        scales = torch.from_numpy(np.exp2(src.integers(
            -8, 8, lead + (NKV,))).astype(np.float32)).to(dev)
        return codes, scales

    def rows(t, spread=6, src=rng):
        mag = np.exp2(src.uniform(-spread, spread, (B, t, NKV, 1)))
        return torch.from_numpy((src.normal(0, 1, (B, t, NKV, HD)) * mag)
                                .astype(np.float32)).to(dev)

    pos_wrap = torch.tensor([0, 5, 1023, 1024, 1500, 2047, 3000, 77],
                            dtype=torch.int32, device=dev)
    # a prefill of T = 1024 from pos 1500 wraps inside the call; drawn
    # from its own generator, so the later phases see the same data
    rng_k3 = np.random.default_rng([args.seed, 4])
    cases = ((1, pos_wrap, rng),
             (W, torch.zeros(B, dtype=torch.int32, device=dev), rng),
             (W, torch.full((B,), 1500, dtype=torch.int32, device=dev),
              rng_k3))
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        for t, pos, src in cases:
            kc, ks = fresh_ring(fmt, packed, src=src)
            vc, vs = fresh_ring(fmt, packed, src=src)
            kn, vn = rows(t, src=src), rows(t, src=src)
            # f32 rows, and the model's bf16 rows as the step makes them: k
            # contiguous, v a strided view of the fused QKV output
            qkv = torch.cat([kn, kn, vn], dim=-1).to(torch.bfloat16)
            for k_in, v_in in ((kn, vn), (qkv[..., HD:2 * HD].contiguous(),
                                          qkv[..., 2 * HD:])):
                before = LAUNCHES["kv_append_rows"]
                got = kvk.kv_append_rows(kc.clone(), ks.clone(), vc.clone(),
                                         vs.clone(), k_in, v_in, pos, fmt,
                                         packed=packed)
                assert LAUNCHES["kv_append_rows"] == before + 1
                want = kvk.kv_append_rows_ref(
                    kc.clone(), ks.clone(), vc.clone(), vs.clone(),
                    k_in.float(), v_in.float(), pos, fmt, packed)
                for g, w_ in zip(got, want):
                    assert bits_equal(g, w_), (name, t, k_in.dtype)
                if t == 1:          # rows not written are unchanged
                    idx = pos_wrap.long() % W
                    keep = torch.ones((B, W), dtype=torch.bool, device=dev)
                    keep[torch.arange(B, device=dev), idx] = False
                    for g, orig in zip(got, (kc, ks, vc, vs)):
                        assert torch.equal(g[keep], orig[keep]), name
    phase("phase 4 K3 kv_append_rows bit-exact (codes, scales, untouched "
          f"rows) at B={B} W={W} nkv={NKV} hd={HD}, posit16/8/4, T=1 with "
          "wrapping pos, T=1024 from 0 and from 1500 (wrapping inside the "
          "call); f32 rows and the model's bf16 rows (v a strided view of a "
          "fused QKV tensor) against the plain version on the same values "
          "as f32")

    # 4b. K5 vs paged_kv_append_rows_ref into a full pool (the paged
    # phases draw from their own generator, so the ring phases see the
    # same data whether or not these phases run) -------------------------
    rng_pg = np.random.default_rng([args.seed, 1])

    def fresh_pool(fmt, packed):
        return fresh_ring(fmt, packed, (POOL_PAGES * PS,), rng_pg)

    # a seeded shuffle of the physical pages; slots 2 and 5 idle (all 0)
    table = torch.from_numpy((1 + rng_pg.permutation(B * PMAX)).reshape(
        B, PMAX).astype(np.int32)).to(dev)
    table_idle = table.clone()
    table_idle[[2, 5]] = 0
    pos_pg = torch.tensor([0, 15, 300, 1000, 1008, 77, 511, 64],
                          dtype=torch.int32, device=dev)
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        for t in (1, 16):
            dst = pkv.flat_dst_rows_chunk(table_idle, pos_pg, t, PS)
            kc, ks = fresh_pool(fmt, packed)
            vc, vs = fresh_pool(fmt, packed)
            kn, vn = rows(t, src=rng_pg), rows(t, src=rng_pg)
            # f32 rows, and the model's bf16 rows with v a strided view (as
            # the fused QKV projection's split gives it)
            kv_bf16 = torch.cat([kn, vn], dim=-1).to(torch.bfloat16)
            for k_in, v_in in ((kn, vn), (kv_bf16[..., :HD].contiguous(),
                                          kv_bf16[..., HD:])):
                got = pkv.paged_kv_append_rows(
                    kc.clone(), ks.clone(), vc.clone(), vs.clone(), k_in,
                    v_in, dst, fmt, packed=packed)
                want = pkv.paged_kv_append_rows_ref(
                    kc.clone(), ks.clone(), vc.clone(), vs.clone(), k_in,
                    v_in, dst, fmt, packed)
                for g, w_ in zip(got, want):    # every row past page 0
                    assert bits_equal(g[PS:], w_[PS:]), (name, t, k_in.dtype)
                keep = torch.ones(POOL_PAGES * PS, dtype=torch.bool,
                                  device=dev)
                keep[dst.reshape(-1).long()] = False
                keep[:PS] = False
                for g, orig in zip(got, (kc, ks, vc, vs)):
                    assert torch.equal(g[keep], orig[keep]), (name, t)
    phase(f"phase 4b K5 paged_kv_append_rows bit-exact (codes, scales on "
          f"rows past trash page 0; untouched rows) into {POOL_PAGES} pages "
          f"of {PS} rows, shuffled table with 2 idle slots, posit16/8/4, "
          "T=1 and T=16, f32 rows and bf16 rows (v a strided view)")

    # 5. K4 vs decode_attention_ref: K/V rows of O(1) magnitude (per-row
    # scales over 2^-2..2^2, as post-RoPE K/V at init), so 1e-5 is a few
    # f32 roundings of the output's scale ------------------------------
    cache_len = torch.tensor([1, 17, 128, 129, 500, 1000, 1023, 1024],
                             dtype=torch.int32, device=dev)
    # slots with nothing cached: every row masked, the mean of V
    empty_len = torch.tensor([0, 17, 0, 129, 500, 0, 1023, 1024],
                             dtype=torch.int32, device=dev)
    # K4's split boundaries (kvk.SPLIT_ROWS rows per CTA), 0, -1 and past W
    sr = kvk.SPLIT_ROWS
    ring_edges = [torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        [1, sr - 1, sr, sr + 1, 2 * sr - 1, 2 * sr, 2 * sr + 1, W - 1],
        [W, 0, W + 1, -1, 2 * W, W - sr, 3 * sr, 3 * sr + 1])]
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        kc, ks = fresh_ring(fmt, packed)
        vc, vs = fresh_ring(fmt, packed)
        kvk.kv_append_rows_ref(kc, ks, vc, vs, rows(W, 2), rows(W, 2),
                               torch.zeros(B, dtype=torch.int32, device=dev),
                               fmt, packed)
        q = torch.from_numpy(rng.normal(0, 1, (B, 1, NH, HD)).astype(
            np.float32)).to(dev)
        errs, errs_bf16 = [], []
        for cl in (cache_len, empty_len, *ring_edges):
            got = kvk.decode_attention(q, kc, ks, vc, vs, cl, fmt,
                                       packed=packed)
            want = kvk.decode_attention_ref(q, kc, ks, vc, vs, cl, fmt,
                                            packed)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs.append(float((got - want).abs().max()))
            # bf16 q against the plain version on the same bf16 q
            # (hd^-0.5 = 1/8 scales bf16 exactly): one bf16 rounding
            qb = q.to(torch.bfloat16)
            got = kvk.decode_attention(qb, kc, ks, vc, vs, cl, fmt,
                                       packed=packed)
            want = kvk.decode_attention_ref(qb, kc, ks, vc, vs, cl, fmt,
                                            packed)
            assert got.dtype == torch.bfloat16
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=2 ** -7)
            errs_bf16.append(float((got.float() - want.float()).abs().max()))
        if name == "posit8_2":
            err["decode_attention"] = errs[0]
        phase(f"phase 5 K4 decode_attention {name}: max |err| {errs[0]:.3e}"
              f", {errs[1]:.3e} with empty slots, {max(errs[2:]):.3e} at "
              f"cache_len on split ({sr}-row) edges, 0, -1 and past W "
              f"{[v.tolist() for v in ring_edges]} (rtol 1e-5, atol 1e-5); "
              f"bf16 q {max(errs_bf16):.3e} (rtol 2^-7, atol 2^-7)")

    # 5b. K6 vs paged_decode_attention_ref over the shuffled table ------
    table_bad = table.clone()                   # clipped to [0, num_pages)
    table_bad[0, 0], table_bad[3, 5], table_bad[7, 63] = -3, 10_000, -1
    # K6's split boundaries and page edges
    edge_lens = [torch.tensor(v, dtype=torch.int32, device=dev) for v in (
        [-1, PS - 1, PS, PS + 1, sr - 1, sr, sr + 1, W],
        [0, 1, 2 * sr - 1, 2 * sr, 2 * sr + 1, W - sr, W - 1, W])]
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        pool = []
        for _ in range(2):
            x = rows(POOL_PAGES * PS // B, 2, rng_pg).reshape(-1, NKV, HD)
            c, sc = kvk.encode_kv_rows(x, fmt, packed)
            pool += [c.to(_build.code_dtype(fmt)), sc[..., 0].contiguous()]
        q = torch.from_numpy(rng_pg.normal(0, 1, (B, 1, NH, HD)).astype(
            np.float32)).to(dev)
        errs = []
        for tb, sl in ((table, cache_len), (table, empty_len),
                       (table_bad, cache_len), (table, edge_lens[0]),
                       (table_bad, edge_lens[1])):
            got = pkv.paged_decode_attention(q, *pool, tb, sl, fmt,
                                             page_size=PS, packed=packed)
            want = pkv.paged_decode_attention_ref(q, *pool, tb, sl, fmt,
                                                  page_size=PS,
                                                  packed=packed)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            errs.append(float((got - want).abs().max()))
        if name == "posit8_2":
            err["paged_decode_attention"] = errs[0]
        phase(f"phase 5b K6 paged_decode_attention {name}: max |err| "
              f"{errs[0]:.3e}, {errs[1]:.3e} with empty slots, {errs[2]:.3e} "
              f"with out-of-range table entries, {max(errs[3:]):.3e} at "
              f"seq_lens on split ({sr}-row) and page edges "
              f"{[v.tolist() for v in edge_lens]} (rtol 1e-5, atol 1e-5)")

    # 6. main path: full-width paper-edge, posit8 ring, 8 requests -----
    cfg = get_config("paper-edge")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init_params(cfg, gen, device=dev)
    n_params = cfg.param_count()
    warm = rng.integers(0, cfg.vocab, 64)
    lens = rng.integers(64, 901, 8)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lens]

    def serve_main(scfg):
        """Serve the 8 prompts (max_new 32) through a fresh engine after a
        warm-up request, with every kernel count set to 0 just before the
        serve and read just after it."""
        eng = ServingEngine(cfg, params, scfg, policy="paper_edge_p8")
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
        eng.serve([Request(uid=-1, prompt=warm, max_new=3)])   # warm-up
        reqs = [Request(uid=i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)]
        eng.tracer.reset()
        eng.tracer.enable()
        steps0, tokens0 = eng.stats["decode_steps"], eng.stats["tokens"]
        calls = eng.metrics.counter("stage.prefill.calls")
        calls0 = calls.value
        stage_calls0 = EnergyAccountant(eng).calls_snapshot()
        torch.cuda.synchronize()
        reset_launches()
        stats = eng.serve(reqs)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        stage_calls = EnergyAccountant.calls_delta(
            EnergyAccountant(eng).calls_snapshot(), stage_calls0)
        eng.tracer.disable()
        st = eng.tracer.self_times()

        def stage_ms(stage):
            n = st[f"{stage}.device"]["count"]
            return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                          + st[f"{stage}.device"]["total_s"]) / n

        assert all(bool(f) for f in finite), "non-finite logits"
        assert all(len(r.out_tokens) == 32 for r in reqs)
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
        tokens = eng.stats["tokens"] - tokens0
        return {"eng": eng, "generate": generate_fn, "reqs": reqs,
                "launches": launches, "prefill_calls": calls.value - calls0,
                "energy_window": (stage_calls, tokens),
                "steps": eng.stats["decode_steps"] - steps0,
                "prefill_ms": stage_ms("prefill"),
                "decode_ms": stage_ms("generate"),
                "tok_s": tokens / stats["wall_s"]}

    ring = serve_main(ServeConfig(max_batch=8, max_len=1024,
                                  kv_format="posit8"))
    eng, main_launches, steps = ring["eng"], ring["launches"], ring["steps"]
    for k in ("kv_append_rows", "decode_attention"):
        assert main_launches[k] >= cfg.n_layers * steps, (k, main_launches)
    phase(f"phase 6 main path: paper-edge {cfg.n_layers}L d{cfg.d_model} "
          f"{cfg.n_heads}/{cfg.n_kv_heads}h hd{cfg.head_dim} vocab "
          f"{cfg.vocab} ({n_params / 1e6:.1f} M params, {cfg.dtype_name}), "
          f"posit8 ring, 8 requests of {sorted(int(n) for n in lens)} "
          f"prompt tokens, max_new 32: prefill {ring['prefill_ms']:.2f} "
          f"ms/call ({ring['prefill_calls']} calls), decode "
          f"{ring['decode_ms']:.3f} ms/step ({steps} steps), "
          f"{ring['tok_s']:.1f} tok/s, KV {eng.kv_cache_bytes()} B, "
          f"launches K3 {main_launches['kv_append_rows']} K4 "
          f"{main_launches['decode_attention']}")

    # 6b. where a decode step's time goes: one profiled window --------
    from torch.profiler import ProfilerActivity, profile
    n_prof = 5
    prof_busy = []          # each profile's device busy ms/step (or None)

    def profile_steps(step):
        """Wall per call of ``step`` over ``n_prof`` calls, wrapper launches
        per call, and device busy / idle share and kernel launches per call
        from a profiler trace."""
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / n_prof
        per_step = {k: v / n_prof for k, v in LAUNCHES.items()}
        n_kernels = {}
        per_kernel = {k: v / n_prof / 1e3
                      for k, v in device_events(prof, n_kernels).items()}
        copies = sum(n for k, n in n_kernels.items() if k.endswith("[copy]"))
        busy = sum(per_kernel.values())
        prof_busy.append(busy if per_kernel else None)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        # K4's or K6's two kernels (the step runs one of the two layouts)
        walk = sum(per_kernel.get(k, 0.0) for k in ("split_kernel",
                                                     "combine_kernel"))
        device = (f"device busy {busy:.3f} ms/step, idle share "
                  f"{1 - busy / wall_ms:.3f}; kernel launches "
                  f"{sum(n_kernels.values()) / n_prof:.1f}/step, of which "
                  f"copies {copies / n_prof:.1f}; split walk (split_kernel + "
                  f"combine_kernel) {walk:.3f} ms/step; top kernels "
                  f"(ms/step): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in top)) \
            if per_kernel else "device busy and idle share not measured " \
                               "(the profiler trace held no device events)"
        return wall_ms, per_step, device

    def ring_generate():
        eng.cache, logits = ring["generate"](eng.params, eng.cache)
        logits.float().cpu()

    wall_ms, per_step, device = profile_steps(ring_generate)
    # the same step with the K/V cast to f32 before every K3 call, as the
    # call sites did while K3 read only f32 rows
    k3_wrapper = kvk.kv_append_rows
    kvk.kv_append_rows = lambda kc, ks, vc, vs, k, v, *a, **kw: k3_wrapper(
        kc, ks, vc, vs, k.float(), v.float(), *a, **kw)
    try:
        _, _, device_cast = profile_steps(ring_generate)
    finally:
        kvk.kv_append_rows = k3_wrapper
    phase(f"phase 6b decode-step profile ({n_prof} generate calls at the "
          f"served positions): wall {wall_ms:.3f} ms/step, {device}; with "
          f"K/V cast to f32 before each K3 call: {device_cast}")

    # 6c. the paged main path: same weights and prompts, half the pool -
    paged = serve_main(ServeConfig(max_batch=8, max_len=1024,
                                   kv_format="posit8", kv_layout="paged",
                                   page_size=PS, num_pages=ENGINE_PAGES))
    eng_p, lp = paged["eng"], paged["launches"]
    n_l, steps_p = cfg.n_layers, paged["steps"]
    assert lp["paged_kv_append_rows"] == n_l * steps_p, lp
    assert lp["paged_decode_attention"] == n_l * steps_p, lp
    assert lp["decode_attention"] == 0, lp
    assert lp["kv_append_rows"] == n_l * paged["prefill_calls"], lp
    for k in ("paged_kv_append_rows", "paged_decode_attention"):
        main_launches[k] = lp[k]
        per_step[k] = lp[k] / steps_p
    eng_p.allocator.assert_consistent()
    assert eng_p.allocator.live_pages == 0
    reserved = (ENGINE_PAGES * PS * cfg.n_kv_heads * (cfg.head_dim + 4)
                * 2 * n_l)                      # posit8 codes + f32 scales
    assert eng_p.kv_cache_bytes() == reserved, eng_p.kv_cache_bytes()
    agree = [sum(a == b for a, b in zip(x.out_tokens, y.out_tokens))
             for x, y in zip(paged["reqs"], ring["reqs"])]
    worst = sum(-(-(len(r.prompt) + 32) // PS) for r in paged["reqs"])
    phase(f"phase 6c paged main path: posit8 pool of {ENGINE_PAGES} pages "
          f"x {PS} rows, same 8 prompts, max_new 32: prefill "
          f"{paged['prefill_ms']:.2f} ms/call ({paged['prefill_calls']} "
          f"calls), decode {paged['decode_ms']:.3f} ms/step ({steps_p} "
          f"steps), {paged['tok_s']:.1f} tok/s; worst-case reservations "
          f"{worst} of {ENGINE_PAGES - 1} pages; KV reserved {reserved} B "
          f"(ring {eng.kv_cache_bytes()} B), peak live "
          f"{eng_p.kv_cache_peak_live_bytes()} B "
          f"({eng_p.stats['peak_live_pages']} pages), evictions "
          f"{eng_p.stats['evictions']}; launches K3 {lp['kv_append_rows']} "
          f"K4 {lp['decode_attention']} K5 {lp['paged_kv_append_rows']} K6 "
          f"{lp['paged_decode_attention']}; greedy tokens equal to the ring "
          f"run's per request {agree} of 32 (not asserted)")

    # 6d. a paged decode step's profile: the 8 prompts readmitted (those
    # whose reservations fit), 5 engine steps (page growth, generate,
    # sampling), then drained -------------------------------------------
    eng_p.add_requests([Request(uid=100 + i, prompt=p, max_new=32)
                        for i, p in enumerate(prompts)])
    n_active = sum(r is not None for r in eng_p.slot_req)
    wall_p, _, device_p = profile_steps(eng_p.step)
    busy_6d = prof_busy[-1]
    eng_p.serve([])
    eng_p.allocator.assert_consistent()
    assert eng_p.allocator.live_pages == 0
    phase(f"phase 6d paged decode-step profile ({n_prof} engine steps, "
          f"{n_active} slots active at the prompt lengths): wall "
          f"{wall_p:.3f} ms/step, {device_p}")

    # 7. the whole slice, card vs CPU at float32, ring and paged -------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype_name="float32")
    params32 = lm.init_params(cfg32, gen, device=dev)
    prompts32 = [rng.integers(0, cfg.vocab, n) for n in (19, 40)]

    def snapshot(tree, device="cpu"):
        """A copy of a decode state on ``device`` (tensors cloned, others
        kept)."""
        if isinstance(tree, dict):
            return {k: snapshot(v, device) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(snapshot(v, device) for v in tree)
        if isinstance(tree, torch.Tensor):
            return tree.detach().to(device, copy=True)
        return tree

    def signed_codes(c):
        """posit8 codes as signed integers: their order is the posits'."""
        c = c.to(torch.int16)
        return torch.where(c >= 128, c - 256, c)

    p8_kv = get_fmt("posit8_2")
    near_zero = 2.0 ** -12      # of the row's scale: posit8 keeps ~2 bits

    def code_flips(a, b):
        """Codes two devices wrote for one set of K/V values.  Each code
        that differs must be the neighbour of its counterpart in posit
        order, or, near zero (|values| far below the row's scale, where
        posit8's spacing falls under f32 noise and a sign may cross), decode
        within 2^-12 of the row's scale of it.  Returns (differ, near
        zero)."""
        sa, sb = signed_codes(a), signed_codes(b)
        far = (sa - sb).abs() > 1
        gap = (decode_tile(a[far], p8_kv) - decode_tile(b[far], p8_kv)).abs()
        assert bool((gap <= near_zero).all()), float(gap.max())
        return int((sa != sb).sum()), int(far.sum())

    def card_vs_cpu(label, **layout):
        """(a) The CPU runs its first two decode steps from the card's
        cache (codes, scales, page table and input tokens copied over); in
        each layer the row the CPU just wrote is then replaced by the card's
        (its codes are held as in (b)), so every step reads identical caches
        and the logits are held to the card's.  (b) The caches each device
        wrote from its own prefill: scales equal, codes held by
        ``code_flips`` on < 0.1 % of the written codes.  The greedy tokens
        of the two independent runs are counted."""
        runs = {}
        for device in ("cuda", "cpu"):     # the engine moves the params
            e32 = ServingEngine(cfg32, params32, ServeConfig(
                max_batch=2, max_len=64, kv_format="posit8", **layout),
                policy="paper_edge_p8", device=device)
            rec = {"logits": [], "tok": [], "states": []}
            gen_fn = e32.engine.generate

            def generate_logged(params, state, _g=gen_fn, _r=rec):
                if len(_r["tok"]) < 3:      # after insert, then per step
                    _r["states"].append(snapshot(state))
                _r["tok"].append(state["tok"].detach().cpu().clone())
                state, logits = _g(params, state)
                _r["logits"].append(logits.detach().cpu())
                return state, logits

            e32.engine.generate = generate_logged
            rq = [Request(uid=i, prompt=pr, max_new=8)
                  for i, pr in enumerate(prompts32)]
            e32.serve(rq)
            runs[device] = (rec, [r.out_tokens for r in rq], e32, gen_fn)
        card, cpu = runs["cuda"][0], runs["cpu"][0]
        cut = PS if layout else 0          # pool: past trash page 0
        # (a) two CPU decode steps from the card's cache
        e_cpu, cpu_generate = runs["cpu"][2], runs["cpu"][3]
        mod, fn_name = (pkv, "paged_kv_append") if layout else \
            (kvk, "kv_append_rows")
        cpu_write = getattr(mod, fn_name)
        state = snapshot(card["states"][0])
        dmax, row_flips = 0.0, [0, 0]

        def card_rows(after, layer):
            def write(kc, ks, vc, vs, *a, **kw):
                cpu_write(kc, ks, vc, vs, *a, **kw)
                lay = next(layer)
                for t, name in ((kc, "k"), (ks, "k_scale"), (vc, "v"),
                                (vs, "v_scale")):
                    want = after[name][lay]
                    if name.endswith("scale"):
                        assert torch.equal(t[cut:], want[cut:]), (label, lay)
                    else:
                        flips = code_flips(t[cut:], want[cut:])
                        row_flips[0] += flips[0]
                        row_flips[1] += flips[1]
                    t.copy_(want)
            return write

        try:
            for i in range(2):
                layer = iter(range(cfg32.n_layers))
                setattr(mod, fn_name, card_rows(
                    card["states"][i + 1]["blocks"][0], layer))
                state["tok"] = card["tok"][i].clone()
                if layout:                  # the pages the card's step had
                    state["page_table"] = card["states"][i][
                        "page_table"].clone()
                state, logits = cpu_generate(e_cpu.params, state)
                assert next(layer, None) is None    # every layer's row
                torch.testing.assert_close(logits, card["logits"][i],
                                           rtol=1e-3, atol=1e-3)
                dmax = max(dmax, float((logits - card["logits"][i]).abs()
                                       .max()))
        finally:
            setattr(mod, fn_name, cpu_write)
        # (b) the caches each device wrote from its own prefill
        c0, p0 = card["states"][0]["blocks"][0], cpu["states"][0]["blocks"][0]
        for k in ("k_scale", "v_scale"):
            assert torch.equal(c0[k][:, cut:], p0[k][:, cut:]), (label, k)
        flips = [code_flips(c0[k][:, cut:], p0[k][:, cut:])
                 for k in ("k", "v")]
        codes_diff = sum(f[0] for f in flips)
        written = (int(card["states"][0]["pos"].sum()) * cfg32.n_layers
                   * cfg32.n_kv_heads * cfg32.head_dim * 2)
        assert codes_diff < 1e-3 * written, (label, codes_diff, written)
        same = [sum(a == b for a, b in zip(x, y))
                for x, y in zip(runs["cuda"][1], runs["cpu"][1])]
        phase(f"{label} card vs CPU (float32, TF32 off): (a) CPU decoding "
              f"from the card's cache and rows, first two steps' logits "
              f"within rtol 1e-3 atol 1e-3 (max |diff| {dmax:.3e}); the "
              f"rows those steps wrote: scales equal, {row_flips[0]} of "
              f"{2 * 2 * cfg32.n_layers * cfg32.n_kv_heads * cfg32.head_dim * 2}"
              f" codes differ ({row_flips[1]} of them near zero); (b) caches "
              f"from each device's own prefill: scales equal, {codes_diff} "
              f"of {written} written K/V codes differ "
              f"({sum(f[1] for f in flips)} near zero, the rest one posit "
              f"step); independent runs' greedy tokens equal per request "
              f"{same} of 8 (not asserted)")

    card_vs_cpu("phase 7 ring")
    card_vs_cpu("phase 7b paged", kv_layout="paged", page_size=PS)

    # 11a. the speculative verify pass at float32 (own generator: the later
    # phases draw what they drew before) ----------------------------------
    from repro_torch.core.transprecision import TCPolicy
    from repro_torch.models import serve_model as sm
    from repro_torch.serve.engine_api import (rollback_paged_cache,
                                              rollback_ring_cache)
    from repro_torch.serve.speculative import SpeculativeEngine
    rng_sp = np.random.default_rng([args.seed, 11])
    n_l, t_sp = cfg.n_layers, 5                 # gamma + 1 = 5
    params32_cpu = snapshot(params32)
    sp_toks = torch.from_numpy(rng_sp.integers(0, cfg.vocab, (B, 256)))
    sp_lens = torch.from_numpy(rng_sp.integers(100, 257, B).astype(np.int32))
    sp_chunk = torch.from_numpy(rng_sp.integers(0, cfg.vocab, (B, t_sp)))
    written = B * t_sp * n_l * NKV * HD * 2     # K and V codes per verify

    def held(a, b, cut):
        """Caches two runs wrote from one cache: scales equal, codes by
        ``code_flips`` on < 0.1 % of the written codes (rows past ``cut``).
        Returns (codes that differ, of them near zero)."""
        a, b = a["blocks"][0], b["blocks"][0]
        for k in ("k_scale", "v_scale"):
            assert torch.equal(a[k][:, cut:].cpu(), b[k][:, cut:].cpu()), k
        f = [code_flips(a[k][:, cut:].cpu(), b[k][:, cut:].cpu())
             for k in ("k", "v")]
        assert f[0][0] + f[1][0] < 1e-3 * written, f
        return f[0][0] + f[1][0], f[0][1] + f[1][1]

    verified, msgs = {}, []
    for layout in ("ring", "paged"):
        pol = TCPolicy(name=f"verify_{layout}", kv_format="posit8",
                       kv_layout=layout, kv_page_size=PS)
        cut = PS if layout == "paged" else 0
        _, c0 = sm.prefill(params32, {"tokens": sp_toks.to(dev)}, cfg32, W,
                           pol, true_len=sp_lens.to(dev))
        torch.cuda.synchronize()
        reset_launches()
        lv, card = sm.verify_step(params32, snapshot(c0, dev),
                                  sp_chunk.to(dev), cfg32, pol)
        torch.cuda.synchronize()
        append = "paged_kv_append_rows" if cut else "kv_append_rows"
        want_l = {"posit_decode": 2 * n_l, append: n_l}
        assert {k: v for k, v in LAUNCHES.items() if v} == want_l, LAUNCHES
        # (1) the CPU's verify from the same cache
        lv_cpu, cpu = sm.verify_step(params32_cpu, snapshot(c0), sp_chunk,
                                     cfg32, pol)
        torch.testing.assert_close(lv.cpu(), lv_cpu, rtol=1e-3, atol=1e-3)
        d_cpu = float((lv.cpu() - lv_cpu).abs().max())
        f_cpu = held(card, cpu, cut)
        # (2) five sequential decode steps on the card from the same cache
        seq, seq_logits = snapshot(c0, dev), []
        for t in range(t_sp):
            lg, seq = sm.decode_step(params32, seq, sp_chunk[:, t:t + 1].to(
                dev), cfg32, pol)
            seq_logits.append(lg)
        seq_logits = torch.stack(seq_logits, 1)
        torch.testing.assert_close(lv, seq_logits, rtol=1e-3, atol=1e-3)
        d_seq = float((lv - seq_logits).abs().max())
        f_seq = held(card, seq, cut)
        assert torch.equal(card["pos"], seq["pos"])
        # (3) K3 / K5 at T = 5 from the model's bf16 rows (v a strided view
        # of a fused QKV output), per-slot pos wrapping the ring, bit-exact
        qkv = torch.from_numpy(rng_sp.normal(0, 2, (B, t_sp, NH + 2 * NKV,
                                                    HD)).astype(np.float32))
        qkv = qkv.to(dev).to(torch.bfloat16)
        k_in, v_in = qkv[:, :, NH:NH + NKV], qkv[:, :, NH + NKV:]
        pos_t = torch.from_numpy(rng_sp.integers(0, W, B).astype(np.int32))
        pos_t[0] = W - 2                        # writes wrap to rows 0..2
        pos_t = pos_t.to(dev)
        fn, ref, index = ((pkv.paged_kv_append_rows,
                           pkv.paged_kv_append_rows_ref,
                           pkv.flat_dst_rows_chunk(table_idle, pos_t, t_sp,
                                                   PS)) if cut else
                          (kvk.kv_append_rows, kvk.kv_append_rows_ref, pos_t))
        base = [c0["blocks"][0][k][0] for k in ("k", "k_scale", "v",
                                                 "v_scale")]
        before = LAUNCHES[append]
        got = fn(*[x.clone() for x in base], k_in, v_in, index, p8_kv)
        assert LAUNCHES[append] == before + 1
        want = ref(*[x.clone() for x in base], k_in.float(), v_in.float(),
                   index, p8_kv)
        for g, w_ in zip(got, want):
            assert bits_equal(g[cut:], w_[cut:]), layout
        verified[layout] = (pol, cut, card)
        msgs.append(f"{layout}: verify vs the CPU's verify max |diff| "
                    f"{d_cpu:.3e}, written codes differing {f_cpu[0]} of "
                    f"{written} ({f_cpu[1]} near zero); vs 5 sequential card "
                    f"decode steps max |diff| {d_seq:.3e}, codes differing "
                    f"{f_seq[0]} ({f_seq[1]} near zero); launches {want_l}")
    phase(f"phase 11a verify_step (float32, TF32 off, B={B}, T={t_sp}, "
          f"prompts {sp_lens.tolist()}, logits rtol/atol 1e-3, scales equal, "
          f"codes one posit step apart on < 0.1 %; K3/K5 at T={t_sp} from "
          "bf16 rows with per-slot pos bit-exact): " + "; ".join(msgs))

    # 11b. rollback on the card vs the CPU, on the verified caches ------
    pre = torch.from_numpy(sp_lens.numpy().astype(np.int64))   # pre-verify
    keep = torch.from_numpy(rng_sp.integers(1, t_sp + 1, B))
    new_pos = (pre + keep).numpy()
    new_pos[3] = 0                              # a slot freed this round
    for layout in ("ring", "paged"):
        pol, cut, card = verified[layout]
        cpu = snapshot(card)
        if cut:
            tbl = card["page_table"].cpu().long()
            scrub = np.zeros(B * t_sp, np.int64)    # padded w/ trash row 0
            n = 0
            for i in range(B):
                if i == 3:
                    continue
                for p in range(int(new_pos[i]), int(pre[i]) + t_sp):
                    scrub[n] = int(tbl[i, p // PS]) * PS + p % PS
                    n += 1
            rollback_paged_cache(card, new_pos, scrub)
            rollback_paged_cache(cpu, new_pos, scrub)
            scrubbed = n
        else:
            window_end = (pre + t_sp).numpy()
            scrub_from = new_pos.copy()
            scrub_from[3] = window_end[3]
            rollback_ring_cache(card, new_pos, window_end, scrub_from, t_sp)
            rollback_ring_cache(cpu, new_pos, window_end, scrub_from, t_sp)
            scrubbed = int((window_end - scrub_from).sum())
        assert card["pos"].tolist() == cpu["pos"].tolist() == new_pos.tolist()
        for k, leaf in card["blocks"][0].items():
            assert bits_equal(leaf[:, cut:].cpu(), cpu["blocks"][0][k][:, cut:]
                              ), (layout, k)
        msgs.append(f"{layout} {scrubbed} rows x {n_l} layers scrubbed")
    phase(f"phase 11b rollback_ring_cache / rollback_paged_cache on the card "
          f"bit-exact against the CPU on every row outside trash page 0: "
          f"{msgs[-2]}, {msgs[-1]}")

    # 11c. speculative serving at full width, bf16: BF16 target with a
    # posit8 KV, draft posit8_2 weights and a posit8 ring; phase 6's 8
    # prompts, each cell beside a baseline of the same config -----------
    spec_counts = ("decode_steps", "tokens", "prefills", "spec_rounds",
                   "draft_steps", "drafts_proposed", "drafts_accepted")
    path_kernels = ("posit_decode", "kv_append_rows", "decode_attention",
                    "paged_kv_append_rows")

    def serve_cell(scfg, gamma=None):
        """Serve the 8 prompts (max_new 32) through a fresh baseline
        (``gamma`` None) or speculative engine after a warm-up request, every
        kernel count set to 0 just before the serve and read just after;
        also the serve's stage calls and tokens (the energy window)."""
        e_ = (ServingEngine(cfg, params, scfg) if gamma is None else
              SpeculativeEngine(cfg, params, scfg, gamma=gamma))
        e_.serve([Request(uid=-1, prompt=warm, max_new=3)])
        keys = [k for k in spec_counts if gamma or k in e_.stats]
        c0 = {k: e_.stats[k] for k in keys}
        stage_calls0 = EnergyAccountant(e_).calls_snapshot()
        rq = [Request(uid=i, prompt=p, max_new=32)
              for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        e_.serve(rq)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        window = (EnergyAccountant.calls_delta(
            EnergyAccountant(e_).calls_snapshot(), stage_calls0),
            e_.stats["tokens"] - c0["tokens"])
        assert all(len(r.out_tokens) == 32 for r in rq)
        assert all(0 <= t < cfg.vocab for r in rq for t in r.out_tokens)
        if e_.paged:
            e_.allocator.assert_consistent()
            assert e_.allocator.live_pages == 0
        counts = {k: e_.stats[k] - c0[k] for k in keys}
        return e_, rq, launches, counts, wall, window

    spec_cells, spec_launches = {}, {k: 0 for k in path_kernels}
    for layout, extra in (("ring", {}),
                          ("paged", {"kv_layout": "paged", "page_size": PS,
                                     "num_pages": ENGINE_PAGES})):
        scfg = ServeConfig(max_batch=8, max_len=W, kv_format="posit8",
                           **extra)
        _, b_rq, _, b_n, b_wall, _ = serve_cell(scfg)
        for gamma in (2, 4):
            e_, rq, lc, n, wall, window = serve_cell(scfg, gamma)
            need = ["posit_decode", "kv_append_rows", "decode_attention"]
            need += ["paged_kv_append_rows"] if layout == "paged" else []
            for k in need:
                assert lc[k] > 0, (layout, gamma, k, lc)
                spec_launches[k] += lc[k]
            assert lc["posit_decode"] == 2 * n_l * n["spec_rounds"], lc
            decode_tok = n["tokens"] - n["prefills"]
            agree = sum(a == b for x, y in zip(rq, b_rq)
                        for a, b in zip(x.out_tokens, y.out_tokens))
            # a profiled window of 5 rounds on the prompts readmitted
            e_.add_requests([Request(uid=100 + i, prompt=p, max_new=32)
                             for i, p in enumerate(prompts)])
            r_wall, r_launch, r_device = profile_steps(e_.step)
            e_.serve([])
            if e_.paged:
                e_.allocator.assert_consistent()
                assert e_.allocator.live_pages == 0
            cell = {
                "acceptance": n["drafts_accepted"] / n["drafts_proposed"],
                "target_steps_per_token": n["decode_steps"] / decode_tok,
                "draft_steps_per_token": n["draft_steps"] / decode_tok,
                "wall_s": {"baseline": b_wall, "speculative": wall},
                "tok_s": {"baseline": b_n["tokens"] / b_wall,
                          "speculative": n["tokens"] / wall},
                "kv_bytes": e_.kv_cache_bytes(),
                "kv_bytes_draft_ring": e_._draft_kv_bytes(),
                "counts": n, "launches": {k: lc[k] for k in path_kernels},
                "launches_per_round_profiled": {
                    k: r_launch[k] for k in path_kernels},
                "round_wall_ms_profiled": r_wall,
                "tokens_equal_to_baseline": agree}
            spec_cells[f"{layout}_gamma{gamma}"] = cell
            if layout == "ring" and gamma == 2:     # priced in phase 14
                spec_ring = (e_,) + window
            phase(f"phase 11c speculative {layout} gamma {gamma}: acceptance "
                  f"{cell['acceptance']:.4f}, target steps/token "
                  f"{cell['target_steps_per_token']:.4f}, draft steps/token "
                  f"{cell['draft_steps_per_token']:.4f}; wall "
                  f"{b_wall:.3f} s baseline / {wall:.3f} s speculative, "
                  f"{cell['tok_s']['baseline']:.1f} / "
                  f"{cell['tok_s']['speculative']:.1f} tok/s; KV "
                  f"{cell['kv_bytes']} B with the draft ring "
                  f"({cell['kv_bytes_draft_ring']} B); counts {n}; launches "
                  f"{cell['launches']}; profiled rounds: wall {r_wall:.3f} "
                  f"ms/round, launches/round "
                  f"{cell['launches_per_round_profiled']}, {r_device}; "
                  f"tokens equal to the baseline's stream {agree} of "
                  f"{8 * 32} (not asserted)")
            del e_
    print(json.dumps({"speculative": spec_cells}), flush=True)
    main_launches["posit_decode"] = spec_launches["posit_decode"]

    # 13. the orchestrator and its robustness (own generator) ----------
    print(json.dumps({"orchestrator": phase13(
        dev, args.seed, cfg, params, cfg32, params32, prompts, warm,
        profile_steps, prof_busy, busy_6d)}), flush=True)

    # 14. modeled energy per token of the served runs (own generator) --
    print(json.dumps({"energy": phase14(dev, args.seed, {
        "6_ring": (eng,) + ring["energy_window"],
        "6c_paged": (eng_p,) + paged["energy_window"],
        "11c_ring_gamma2": spec_ring})}),
        flush=True)
    del spec_ring

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
    # K5/K6: one full pool per layer, every slot's 1024 rows written
    # through the shuffled table
    kc_p = torch.zeros((layers, POOL_PAGES * PS, NKV, HD), dtype=torch.uint8,
                       device=dev)
    ks_p = torch.ones((layers, POOL_PAGES * PS, NKV), device=dev)
    vc_p, vs_p = kc_p.clone(), ks_p.clone()
    dst_all = pkv.flat_dst_rows_chunk(
        table, torch.zeros(B, dtype=torch.int32, device=dev), W, PS)
    for i in range(layers):
        pkv.paged_kv_append_rows(kc_p[i], ks_p[i], vc_p[i], vs_p[i],
                                 rows(W, src=rng_pg), rows(W, src=rng_pg),
                                 dst_all, p8)
    dst_step = pkv.flat_dst_rows(table, pos_step, PS)
    pages_read = int(((cache_len + PS - 1) // PS).sum())

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

    def k5(i, plain=False):
        fn = pkv.paged_kv_append_ref if plain else pkv.paged_kv_append
        return fn(kc_p[i], ks_p[i], vc_p[i], vs_p[i], k_step, v_step,
                  dst_step, p8, packed=False)

    def k6(i, plain=False):
        fn = (pkv.paged_decode_attention_ref if plain
              else pkv.paged_decode_attention)
        return fn(q_step, kc_p[i], ks_p[i], vc_p[i], vs_p[i], table,
                  cache_len, p8, page_size=PS, packed=False)

    # 8b. K4's device time (the split walk over ring rows) against the
    # 64-row blocks each slot walks
    walk_us = {}
    for n_rows in (64, 256, 1024):
        cl_n = torch.full((B,), n_rows, dtype=torch.int32, device=dev)
        walk_us[n_rows // 64] = 1e3 * graph_ms(
            lambda i, _cl=cl_n: kvk.decode_attention(
                q_step, kc_l[i], ks_l[i], vc_l[i], vs_l[i], _cl, p8), layers)
    phase(f"phase 8b K4 device µs per call by 64-row blocks walked per "
          f"slot (B=8, {kvk.SPLIT_ROWS}-row splits over ring rows): "
          + ", ".join(f"{k}: {v:.2f}" for k, v in walk_us.items())
          + f"; {(walk_us[16] - walk_us[1]) / 15:.2f} µs per block")
    # 8c. K6 over the same numbers of rows per slot, through the table
    split_us = {}
    for n_rows in (64, 256, 1024):
        cl_n = torch.full((B,), n_rows, dtype=torch.int32, device=dev)
        split_us[n_rows // 64] = 1e3 * graph_ms(
            lambda i, _cl=cl_n: pkv.paged_decode_attention(
                q_step, kc_p[i], ks_p[i], vc_p[i], vs_p[i], table, _cl, p8,
                page_size=PS), layers)
    slope_k6 = (split_us[16] - split_us[1]) / 15
    phase("phase 8c K6 device µs per call by 64-row blocks per slot (B=8, "
          f"{pkv.SPLIT_ROWS}-row splits): "
          + ", ".join(f"{k}: {v:.2f} (K4 {walk_us[k]:.2f})"
                      for k, v in split_us.items())
          + f"; {slope_k6:.2f} µs per block (K4 "
          f"{(walk_us[16] - walk_us[1]) / 15:.2f})")

    # 8d. one paged decode layer's append as the step calls it, from the
    # model's bf16 K/V (v a strided view of the fused QKV output): the
    # casts to f32 and K5 (the call sequence before K5 read bf16) against
    # K5 alone; and K5 at a paged prefill's T = 1024, B = 1, bf16
    qkv_step = torch.cat([k_step, k_step, v_step], dim=-1).to(torch.bfloat16)
    kb_step = qkv_step[..., HD:2 * HD].contiguous()
    vb_step = qkv_step[..., 2 * HD:]

    def k5_step(i, cast):
        kin, vin = ((kb_step.float(), vb_step.float()) if cast
                    else (kb_step, vb_step))
        return pkv.paged_kv_append(kc_p[i], ks_p[i], vc_p[i], vs_p[i], kin,
                                   vin, dst_step, p8)

    append_us = {
        "casts_and_k5": 1e3 * graph_ms(lambda i: k5_step(i, True), layers),
        "k5_bf16": 1e3 * graph_ms(lambda i: k5_step(i, False), layers)}
    t_pf = 1024
    kv_pf = rows(t_pf, src=rng_pg)[:1].to(torch.bfloat16)
    dst_pf = pkv.flat_dst_rows_chunk(
        table[:1], torch.zeros(1, dtype=torch.int32, device=dev), t_pf, PS)
    append_us["k5_t1024_bf16"] = 1e3 * graph_ms(
        lambda i: pkv.paged_kv_append_rows(kc_p[i], ks_p[i], vc_p[i],
                                           vs_p[i], kv_pf, kv_pf, dst_pf, p8),
        layers)
    # each bf16 row read once, its codes and scale written once, dst read
    pf_bound_us = 1e6 * (2 * t_pf * NKV * (HD * 2 + HD + 4) + t_pf * 4) \
        / H100_BYTES_PER_S
    phase(f"phase 8d one paged decode layer's append from bf16 K/V (B=8, "
          f"posit8): casts to f32 + K5 {append_us['casts_and_k5']:.2f} µs, "
          f"K5 alone {append_us['k5_bf16']:.2f} µs; K5 at T={t_pf}, B=1, "
          f"bf16 (a paged prefill) {append_us['k5_t1024_bf16']:.2f} µs "
          f"against its bytes bound {pf_bound_us:.3f} µs")

    # 8e. one ring decode layer's append as the step calls it, from the
    # model's bf16 K/V (the same views): the casts to f32 and K3 (the call
    # sequence before K3 read bf16) against K3 alone; and K3 at a ring
    # prefill's T = 1024, B = 1, bf16 (own generator)
    def k3_step(i, cast):
        kin, vin = ((kb_step.float(), vb_step.float()) if cast
                    else (kb_step, vb_step))
        return kvk.kv_append_rows(kc_l[i], ks_l[i], vc_l[i], vs_l[i], kin,
                                  vin, pos_step, p8)

    ring_append_us = {
        "casts_and_k3": 1e3 * graph_ms(lambda i: k3_step(i, True), layers),
        "k3_bf16": 1e3 * graph_ms(lambda i: k3_step(i, False), layers)}
    rng_8e = np.random.default_rng([args.seed, 5])
    kv_rpf = torch.from_numpy(rng_8e.normal(0, 1, (1, t_pf, NKV, HD)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    pos0 = torch.zeros(1, dtype=torch.int32, device=dev)
    ring_append_us["k3_t1024_bf16"] = 1e3 * graph_ms(
        lambda i: kvk.kv_append_rows(kc_l[i][:1], ks_l[i][:1], vc_l[i][:1],
                                     vs_l[i][:1], kv_rpf, kv_rpf, pos0, p8),
        layers)
    # each bf16 row read once, its codes and scale written once, pos read
    rpf_bound_us = 1e6 * (2 * t_pf * NKV * (HD * 2 + HD + 4) + 4) \
        / H100_BYTES_PER_S
    phase(f"phase 8e one ring decode layer's append from bf16 K/V (B=8, "
          f"posit8): casts to f32 + K3 {ring_append_us['casts_and_k3']:.2f} "
          f"µs, K3 alone {ring_append_us['k3_bf16']:.2f} µs; K3 at T={t_pf}, "
          f"B=1, bf16 (a ring prefill) {ring_append_us['k3_t1024_bf16']:.2f} "
          f"µs against its bytes bound {rpf_bound_us:.3f} µs")

    q_bytes = q_step.element_size()
    byts = {
        "posit_decode": n_codes * (1 + 4),
        "posit_encode": n_codes * (4 + 1),
        "kv_append_rows": 2 * B * NKV * (HD * 4 + HD + 4) + B * 4,
        # live rows, cache_len, q and out (q's dtype)
        "decode_attention": 2 * live * NKV * (HD + 4) + B * 4
        + 2 * B * NH * HD * q_bytes,
        "paged_kv_append_rows": 2 * B * NKV * (HD * 4 + HD + 4) + B * 4,
        # live rows, seq_lens, the table entries the walk reads, q and out
        "paged_decode_attention": 2 * live * NKV * (HD + 4) + B * 4
        + pages_read * 4 + 2 * B * NH * HD * q_bytes,
    }
    flops = {"decode_attention": live * NH * 4 * HD,
             "paged_decode_attention": live * NH * 4 * HD}
    fns = {"posit_decode": k1, "posit_encode": k2, "kv_append_rows": k3,
           "decode_attention": k4, "paged_kv_append_rows": k5,
           "paged_decode_attention": k6}
    out = []
    for name, fn in fns.items():
        ms = graph_ms(fn, layers)
        plain_ms = time_ms(lambda i: fn(i, plain=True), layers, iters=3,
                           reps=3)
        t_bytes = byts[name] / H100_BYTES_PER_S * 1e3
        t_ops = flops.get(name, 0) / H100_F32_FLOPS * 1e3
        src, repl = KERNELS[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": main_launches[name],
            "launches_per_decode_step": per_step[name],
            "launches_speculative": spec_launches.get(name, 0),
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}
        out.append(entry)
    # K1 at the shape timed: bit-exact against decode_tile (x_sets)
    for i in range(layers):
        assert bits_equal(posit_decode(code_sets[i], p8), x_sets[i]), i
        assert bits_equal(posit_decode(code_sets[i], p8,
                                       out_dtype=torch.bfloat16),
                          x_sets[i].to(torch.bfloat16)), i
    # K1 to bf16 (2 B written per code) beside its f32 entry
    k1_bf16_ms = graph_ms(lambda i: posit_decode(
        code_sets[i], p8, out_dtype=torch.bfloat16), layers)
    out[0]["bf16_out"] = {
        "ms": k1_bf16_ms,
        "bound_ms": n_codes * (1 + 2) / H100_BYTES_PER_S * 1e3,
        "bound_by": "bytes"}
    phase("phase 8 K1 posit_decode device µs per call (2,097,152 posit8_2 "
          f"codes, bit-exact to f32 and bf16): f32 out "
          f"{1e3 * out[0]['ms']:.2f} (bytes bound "
          f"{1e3 * out[0]['bound_ms']:.2f}), bf16 out {1e3 * k1_bf16_ms:.2f} "
          f"(bytes bound {1e3 * out[0]['bf16_out']['bound_ms']:.2f})")
    # 9. K7 vs its plain version on the card (own generator: phases 2-8
    # draw what they drew before) ------------------------------------------
    from repro_torch import quickstart
    from repro_torch.core.formats import POSIT8_2, POSIT16_2
    from repro_torch.core.quant import quantize
    from repro_torch.core.transprecision import PAPER_EDGE
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels import posit_matmul as pmm
    from repro_torch.kernels.ops import qt_matmul
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_plain)
    from repro_torch.models.common import rms_norm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train.step import (TrainState, init_train_state,
                                        make_train_step)
    assert not torch.backends.cuda.matmul.allow_tf32   # off since phase 7
    rng_mm = np.random.default_rng([args.seed, 2])
    mm_tol = dict(rtol=2e-5, atol=2e-4)

    def nan_free_err(got, want):
        return float((got - want).abs().nan_to_num(0.0).max())

    n_cases = 0
    paths = {"tensor_core": 0, "split_k": 0}
    xo = pmm.SKINNY_MAX_M            # the crossover and its neighbours
    for name in ("posit8_2", "posit8_0", "posit8_1", "posit16_2",
                 "posit16_1", "posit16_0"):
        fmt = get_fmt(name)
        for m, n, k in ((16, 16, 16), (100, 60, 130), (33, 17, 47),
                        (1, 200, 7), (8192, 4096, 768), (8, 4096, 768),
                        (16, 4096, 768), (17, 4096, 768), (xo, 4096, 768),
                        (xo + 1, 4096, 768), (128, 4096, 768),
                        (8, 32000, 768)):
            w = torch.from_numpy(rng_mm.normal(0, 1, (k, n)).astype(
                np.float32)).to(dev)
            codes = encode_tile(w, fmt)
            codes[k // 2, n // 2] = 0x80 if fmt.bits == 8 else -0x8000  # NaR
            x = torch.from_numpy(rng_mm.normal(0, 1, (m, k)).astype(
                np.float32)).to(dev)
            sv = torch.from_numpy(rng_mm.uniform(0.5, 2.0, n).astype(
                np.float32)).to(dev)
            for scale in (None, 2.0, sv, sv[None]):
                for xd, cd in ((torch.float32, torch.float32),
                               (torch.bfloat16, torch.float32),
                               (torch.float32, torch.bfloat16)):
                    got = posit_matmul(x.to(xd), codes, fmt, scale,
                                       compute_dtype=cd)
                    paths["tensor_core" if m > xo and pmm.tensor_core_ok(
                        x.to(xd), codes) else "split_k"] += 1
                    want = posit_matmul_plain(x.to(xd), codes, fmt, scale,
                                              compute_dtype=cd)
                    torch.testing.assert_close(got, want, equal_nan=True,
                                               **mm_tol)
                    assert torch.isnan(got[:, n // 2]).all()
                    assert not torch.isnan(got[:, :n // 2]).any()
                    err["posit_matmul"] = max(err["posit_matmul"],
                                              nan_free_err(got, want))
                    n_cases += 1
            before = LAUNCHES["posit_matmul"]
            try:
                posit_matmul(x, codes, fmt, sv[:, None])
            except ValueError as e:
                assert "scale" in str(e), e
            else:
                raise AssertionError("an (N, 1) scale did not raise")
            assert LAUNCHES["posit_matmul"] == before
    assert all(paths.values()), paths
    phase(f"phase 9 K7 posit_matmul: {n_cases} cases (posit8_2/8_0/8_1/"
          f"16_2/16_1/16_0; (m, n, k) (16,16,16) (100,60,130) (33,17,47) (1,200,7) "
          f"(8192,4096,768) (8,4096,768), M = 16, 17, {xo}, {xo + 1}, 128 at "
          f"(4096, 768) around the crossover M = {xo}, (8,32000,768); scale "
          f"None / scalar / (N,) / (1,N); x f32, x bf16, compute bf16; a NaR "
          f"column; {paths['tensor_core']} on the tensor-core path, "
          f"{paths['split_k']} split-K) within rtol 2e-5 atol 2e-4 of the "
          f"plain version, max |err| {err['posit_matmul']:.3e}; NaR column "
          f"NaN in both; (N,1) scale raises before any launch")

    # 9b. the crossover: both paths by M at the kernels line's shape (x f32
    # times wi, 768 x 4096 posit8_2, (1, N) scale)
    w_x = quantize(params["blocks"][0]["wi"][0], POSIT8_2, axis=0)
    dec_x = decode_tile(w_x.data, POSIT8_2)
    crossover = {}
    for mrows in (8, 32, 48, 64, 128, 512):
        xs_c = [torch.from_numpy(rng_mm.normal(0, 1, (mrows, cfg.d_model))
                                 .astype(np.float32)).to(dev)
                for _ in range(4)]
        crossover[mrows] = {
            f"{p_}_us": 1e3 * graph_ms(
                lambda i, _p=p_: posit_matmul(xs_c[i], w_x.data, POSIT8_2,
                                              w_x.scale, path=_p), 4)
            for p_ in ("split_k", "tensor_core")}
        crossover[mrows]["decoded_matmul_us"] = 1e3 * graph_ms(
            lambda i: torch.matmul(xs_c[i], dec_x) * w_x.scale, 4)
    phase("phase 9b K7 device µs by M, split-K / tensor-core / decoded-W "
          "torch.matmul (x f32, wi 768 x 4096 posit8_2): "
          + "; ".join(f"M={m_}: {v['split_k_us']:.2f} / "
                      f"{v['tensor_core_us']:.2f} / "
                      f"{v['decoded_matmul_us']:.2f}"
                      for m_, v in crossover.items())
          + f"; the wrapper takes split-K up to M = {xo}")

    # 10. the quickstart path at full width on the card ------------------
    rng_qs = np.random.default_rng([args.seed, 3])
    torch.cuda.synchronize()
    reset_launches()
    xq, cq, bq = quickstart.codec_roundtrip("cuda")
    _, cq_cpu, bq_cpu = quickstart.codec_roundtrip("cpu")
    assert torch.equal(cq.cpu(), cq_cpu) and torch.equal(bq.cpu(), bq_cpu)
    # part 2: every layer's six matrices (posit8_2) and the head
    # (posit16_2) through qt_matmul on hidden states of 8 x 1024 tokens
    blk0 = params["blocks"][0]
    toks = torch.from_numpy(rng_qs.integers(0, cfg.vocab, (8, 1024))).to(dev)
    hid = rms_norm(params["embed"][toks], blk0["ln"][0]).reshape(
        -1, cfg.d_model)                                   # (8192, 768) bf16
    qs_err = 0.0
    part2 = []                       # (x, W) of every call, for its timing

    def qt_checked(xin, wq):
        nonlocal qs_err
        part2.append((xin, wq))
        got = qt_matmul(xin, wq)
        want = posit_matmul_plain(xin, wq.data, wq.fmt, wq.scale)
        torch.testing.assert_close(got, want, **mm_tol)
        qs_err = max(qs_err, float((got - want).abs().max()))
        return got

    for i in range(cfg.n_layers):
        lp = lm.layer_params(blk0, i)
        for name in ("wq", "wk", "wv", "wo"):
            qt_checked(hid, quantize(lp[name], POSIT8_2, axis=0))
        gate, up = qt_checked(hid, quantize(lp["wi"], POSIT8_2,
                                            axis=0)).chunk(2, dim=-1)
        qt_checked(torch.nn.functional.silu(gate) * up,
                   quantize(lp["wo_mlp"], POSIT8_2, axis=0))
    qt_checked(hid, quantize(params["lm_head"], POSIT16_2, axis=0))
    # part 2's device time: its calls replayed as one CUDA graph; these
    # replays are not the path's run, so the K7 count is put back after
    k7_count = LAUNCHES["posit_matmul"]
    part2_ms = len(part2) * graph_ms(lambda i: qt_matmul(*part2[i]),
                                     len(part2), iters=len(part2), reps=3)
    LAUNCHES["posit_matmul"] = k7_count
    del part2
    # part 3: five PAPER_EDGE train steps of full-width paper-edge
    opt_cfg = AdamWConfig(total_steps=10)
    tstate = init_train_state(cfg, opt_cfg, PAPER_EDGE, generator=gen,
                              device=dev)
    tstep = make_train_step(cfg, opt_cfg, PAPER_EDGE)
    pipe = make_pipeline(cfg, global_batch=8, seq_len=1024, seed=args.seed,
                         device=dev)
    batches = [pipe(s) for s in range(5)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_ms = [], [], []

    def train_step(s):
        nonlocal tstate
        tstate, m = tstep(tstate, batches[s])
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))

    for s in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        train_step(s)
        ev1.record()
        torch.cuda.synchronize()
        step_ms.append(ev0.elapsed_time(ev1))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in (3, 4):
            train_step(s)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / 2
    peak = torch.cuda.max_memory_allocated()
    qs_launches = dict(LAUNCHES)
    per_op = {k: v / 2 / 1e3 for k, v in device_events(prof).items()}
    busy = sum(per_op.values())
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:6]
    train_device = (f"device busy {busy:.3f} ms/step, idle share "
                    f"{1 - busy / prof_wall:.3f}; top ops (ms/step): "
                    + ", ".join(f"{k} {v:.3f}" for k, v in top)) \
        if per_op else ("device busy and idle share not measured (the "
                        "profiler trace held no device events)")
    with torch.no_grad():
        loss_after = float(lm.loss_fn(tstate.params, batches[0], cfg,
                                      PAPER_EDGE)[0])
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms)), (
        losses, gnorms)
    assert loss_after < losses[0], (loss_after, losses)
    assert qs_launches["posit_matmul"] == 6 * cfg.n_layers + 1, qs_launches
    main_launches["posit_matmul"] = qs_launches["posit_matmul"]
    per_step["posit_matmul"] = 0
    ms_step = statistics.median(step_ms[1:])
    phase(f"phase 10 quickstart path at full width: part 1 P(8,2) codes "
          f"{cq.tolist()} equal to the CPU codec's; part 2 "
          f"{qs_launches['posit_matmul']} qt_matmul launches (12 layers x "
          f"wq wk wv wo wi wo_mlp posit8_2 + head posit16_2, M = 8192) "
          f"within rtol 2e-5 atol 2e-4 of the plain version (max |err| "
          f"{qs_err:.3e}), {part2_ms:.3f} ms of device time for the "
          f"{qs_launches['posit_matmul']} calls (one CUDA graph); part 3 "
          f"{len(losses)} PAPER_EDGE train steps "
          f"(bf16 params, f32 master, batch 8 x 1024): loss "
          f"{[round(v, 4) for v in losses]}, grad norm "
          f"{[round(v, 4) for v in gnorms]}, loss on step 1's batch after 5 "
          f"steps {loss_after:.4f}; {ms_step:.2f} ms/step (CUDA events, "
          f"steps 2-3; per step {[round(v, 2) for v in step_ms]}), "
          f"{8192 / ms_step * 1e3:.0f} tokens/s, peak memory {peak} B; "
          f"profiled steps 4-5: wall {prof_wall:.2f} ms/step, "
          f"{train_device}; other launches "
          f"{ {k: v for k, v in qs_launches.items() if k != 'posit_matmul'} }")

    # 10b. one train step, card vs CPU, float32, TF32 off -----------------
    cfg_t32 = dataclasses.replace(cfg, dtype_name="float32")
    p_card = lm.init_params(cfg_t32, gen, device=dev)
    p_cpu = snapshot(p_card)
    stepped = {}
    for device, p in (("cuda", p_card), ("cpu", p_cpu)):
        t0 = time.perf_counter()
        st, m = make_train_step(cfg_t32, opt_cfg, PAPER_EDGE)(
            TrainState(p, adamw_init(p)),
            make_pipeline(cfg_t32, global_batch=2, seq_len=256,
                          seed=args.seed, device=device)(0))
        stepped[device] = (st, m, time.perf_counter() - t0)
    (sc, mc, tc), (sp, mp, tp) = stepped["cuda"], stepped["cpu"]
    np.testing.assert_allclose(float(mc["loss"]), float(mp["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(mc["grad_norm"]),
                               float(mp["grad_norm"]), rtol=1e-3)
    leaf_diff, beyond = {}, 0
    for label_, tree_c, tree_p in (("params", sc.params, sp.params),
                                   ("master", sc.opt["master"],
                                    sp.opt["master"])):
        for key in ("embed", "final_norm", "lm_head"):
            d_ = (tree_c[key].cpu() - tree_p[key]).abs()
            leaf_diff[f"{label_}.{key}"] = float(d_.max())
            beyond += int((d_ > 1e-5).sum())
        for key, leaf in tree_c["blocks"][0].items():
            d_ = (leaf.cpu() - tree_p["blocks"][0][key]).abs()
            leaf_diff[f"{label_}.{key}"] = float(d_.max())
            beyond += int((d_ > 1e-5).sum())
    # both steps fake-quantize identical weights (a posit midpoint flip
    # needs inputs that differ), so no updated element may leave 1e-5
    assert beyond == 0, (beyond, leaf_diff)
    phase(f"phase 10b train step card vs CPU (float32, TF32 off, batch 2 x "
          f"256, same params): loss {float(mc['loss']):.6f} vs "
          f"{float(mp['loss']):.6f} (rtol 1e-4, |diff| "
          f"{abs(float(mc['loss']) - float(mp['loss'])):.3e}), grad norm "
          f"{float(mc['grad_norm']):.6f} vs {float(mp['grad_norm']):.6f} "
          f"(rtol 1e-3); updated params and master within atol 1e-5, "
          f"elements beyond 0; max |diff| per leaf "
          + ", ".join(f"{k} {v:.2e}" for k, v in leaf_diff.items())
          + f"; step {tc:.1f} s card, {tp:.1f} s CPU")

    # kernels line, K7: x (M, 768) f32 times one layer's wi (768 x 4096,
    # posit8_2, (1, N) scale), argument sets rotated over the 12 layers
    gen_mm = torch.Generator(device=dev).manual_seed(args.seed + 2)
    w_sets = [quantize(blk0["wi"][i], POSIT8_2, axis=0)
              for i in range(layers)]
    dec_sets = [decode_tile(w.data, POSIT8_2) for w in w_sets]
    mk, nk = cfg.d_model, 2 * cfg.d_ff
    k7 = {}
    for mrows in (8192, 8):
        xs = [torch.randn((mrows, mk), generator=gen_mm, device=dev)
              for _ in range(layers)]

        def k7_call(i, plain=False, _xs=xs):
            fn = posit_matmul_plain if plain else posit_matmul
            return fn(_xs[i], w_sets[i].data, POSIT8_2, w_sets[i].scale)

        def decoded_matmul(i, _xs=xs):
            return torch.matmul(_xs[i], dec_sets[i]) * w_sets[i].scale

        t_bytes = ((mrows * mk * 4 + mk * nk + nk * 4 + mrows * nk * 4)
                   / H100_BYTES_PER_S * 1e3)
        # x f32 is three bf16 pieces, posit8 weights one: 3 passes
        t_ops = 3 * 2 * mrows * mk * nk / H100_BF16_FLOPS * 1e3
        k7[mrows] = {
            "ms": graph_ms(k7_call, layers),
            "plain_ms": time_ms(lambda i: k7_call(i, plain=True), layers,
                                iters=3, reps=3),
            "decoded_matmul_ms": graph_ms(decoded_matmul, layers),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_f32_simt_ms": max(
                t_bytes, 2 * mrows * mk * nk / H100_F32_FLOPS * 1e3),
            "path": "tensor_core" if mrows > pmm.SKINNY_MAX_M else "split_k"}
        del xs
    src, repl = KERNELS["posit_matmul"]
    out.append({
        "name": "posit_matmul", "route": "cuda", "source": src,
        "replaces": repl, "launches": main_launches["posit_matmul"],
        "launches_per_decode_step": 0, "launches_speculative": 0,
        "max_abs_err": err["posit_matmul"], **k7[8192],
        "library_ms": None,
        "shape": "x (8192, 768) f32 x wi (768, 4096) posit8_2, (1, N) scale",
        "decoded_matmul_note": "torch.matmul of x by the decoded f32 W, "
                               "times the scale: a labelled reference, not "
                               "the same function",
        "bound_note": "bound_ms: 3 bf16 tensor-core passes (x f32 as three "
                      "bf16 pieces) or the bytes; bound_f32_simt_ms: the "
                      "same product at the f32 SIMT peak",
        "m8": k7[8],
        "crossover": {"split_k_max_m": pmm.SKINNY_MAX_M,
                      "times_us_by_m": crossover},
        "quickstart_part2_ms": part2_ms})
    phase("kernels line, K7 device µs per call (CUDA graph of 20 calls): "
          + "; ".join(f"M={m_}: {1e3 * v['ms']:.2f} ({v['path']}; bound "
                      f"{1e3 * v['bound_ms']:.2f} by {v['bound_by']}, f32 "
                      f"SIMT bound {1e3 * v['bound_f32_simt_ms']:.2f}, plain "
                      f"{1e3 * v['plain_ms']:.2f}, decoded-W torch.matmul "
                      f"{1e3 * v['decoded_matmul_ms']:.2f})"
                      for m_, v in k7.items()))
    # 12. the rest of training at full width: the posit gradient wire (K2
    # in its normalising mode, then K1, on every gradient leaf), the
    # Trainer with checkpoints, a crash and a restore, and remat "dots"
    # (own generators) ----------------------------------------------------
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.core import quant as tquant
    from repro_torch.core.posit import encode_f32
    from repro_torch.core.transprecision import MIXED_TC
    from repro_torch.optim import compression as wire
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.fault_tolerance import CrashBarrier
    p16 = get_fmt("posit16_2")
    wire_fmt = MIXED_TC.grad_wire
    assert wire_fmt == "posit16_2"
    rng12 = np.random.default_rng([args.seed, 12])

    # 12a. K2's wire mode against core.posit.encode_f32 (subnormals
    # normalised: +-minpos) on every f32 bit pattern for posit8_2 and
    # posit16_2, and for every format on sampled inputs and views
    t12 = time.perf_counter()
    for name in EXHAUSTIVE_FORMATS:
        fmt = get_fmt(name)
        for c0 in range(0, 1 << 32, chunk):
            p_ = torch.arange(c0, c0 + chunk, dtype=torch.int64, device=dev)
            xs = torch.where(p_ >= 1 << 31, p_ - (1 << 32), p_).to(
                torch.int32).view(torch.float32)
            assert torch.equal(posit_encode(xs, fmt, subnormals="normalize"),
                               encode_f32(xs, fmt)), (name, c0)
        del p_, xs
    torch.cuda.synchronize()
    t_exh = time.perf_counter() - t12
    sub = rng12.integers(1, 1 << 23, 1 << 16, dtype=np.uint64).astype(
        np.uint32) | (rng12.integers(0, 2, 1 << 16, dtype=np.uint64).astype(
            np.uint32) << np.uint32(31))
    xw = torch.from_numpy(np.concatenate([
        rng12.standard_t(3, 1 << 16).astype(np.float32) * 2.0 ** -16,
        sub.view(np.float32),
        rng12.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(
            np.uint32).view(np.float32)])).to(dev)
    for name in ALL_FORMATS:
        fmt = get_fmt(name)
        for xv in (xw, xw[1:], xw[:-1], xw[3:-2]):
            before = LAUNCHES["posit_encode"]
            assert torch.equal(posit_encode(xv, fmt, subnormals="normalize"),
                               encode_f32(xv, fmt)), (name, xv.numel(),
                                                      xv.data_ptr() % 16)
            assert LAUNCHES["posit_encode"] == before + 1
        # the flush mode, the kernels' rule, still gives 0 there
        assert not posit_encode(xw[1 << 16:2 << 16], fmt).any(), name
    phase(f"phase 12a K2 posit_encode wire mode (subnormals normalised) "
          f"bit-exact against encode_f32 on all 2^32 f32 bit patterns for "
          f"{', '.join(EXHAUSTIVE_FORMATS)} ({t_exh:.1f} s), and for "
          f"{', '.join(ALL_FORMATS)} on {xw.numel()} inputs (gradient-like "
          f"at 2^-16, 2^16 subnormals, 2^20 random patterns) as x, x[1:], "
          f"x[:-1], x[3:-2]; the flush mode gives 0 on every subnormal")
    del xw

    # 12b. the wire on one full-width step's gradients (MIXED_TC, batch 8 x
    # 1024, bf16): kernels against the plain versions on the card, from
    # identical gradients and residuals
    opt12 = AdamWConfig(lr=1e-3, total_steps=6, warmup_steps=1)
    pipe12 = make_pipeline(cfg, global_batch=8, seq_len=1024,
                           seed=args.seed, device=dev)
    gen12 = torch.Generator(device=dev).manual_seed(args.seed + 12)
    st12 = init_train_state(cfg, opt12, MIXED_TC, generator=gen12,
                            device=dev)
    leaves12 = tree_leaves(st12.params)
    for p in leaves12:
        p.requires_grad_(True)
    loss12, _ = lm.loss_fn(st12.params, pipe12(0), cfg, MIXED_TC)
    grads12 = list(torch.autograd.grad(loss12, leaves12))
    for p in leaves12:
        p.requires_grad_(False)
    del st12, leaves12
    n_grad = sum(g.numel() for g in grads12)
    assert len(grads12) == 11 and n_grad == n_params, (len(grads12), n_grad)
    _, r0 = wire.compress_grads(grads12, wire_fmt)   # one step's residual
    torch.cuda.synchronize()
    reset_launches()
    deq_k, res_k = wire.error_feedback_update(grads12, r0, wire_fmt)
    torch.cuda.synchronize()
    wire_launches = {k: v for k, v in LAUNCHES.items() if v}
    assert wire_launches == {"posit_encode": 11, "posit_decode": 11}, \
        wire_launches
    wires_k, res_k2 = wire.compress_grads(grads12, wire_fmt, r0)
    for i, (g, r) in enumerate(zip(grads12, r0)):
        g32 = g.to(torch.float32) + r
        qt = tquant.quantize(g32, p16, axis=None)       # plain: encode_f32
        deq = tquant.dequantize(qt)                     # plain: decode
        assert bits_equal(wires_k[i].scale, qt.scale), i
        assert torch.equal(wires_k[i].data, qt.data), i
        assert bits_equal(deq_k[i], deq), i
        assert bits_equal(res_k[i], g32 - deq), i
        assert bits_equal(res_k2[i], g32 - deq), i
        assert torch.isfinite(deq).all() and torch.isfinite(res_k[i]).all()
    del deq_k, res_k, res_k2, g32, qt, deq
    # the wire's time per step: CUDA events around the eager call, and its
    # device busy time by kernel from a profiler trace
    wire_ms = time_ms(lambda i: wire.error_feedback_update(
        grads12, r0, wire_fmt), 1, iters=3, reps=5)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wire.error_feedback_update(grads12, r0, wire_fmt)
        torch.cuda.synchronize()
    wire_ops = {k: v / 1e3 for k, v in device_events(prof).items()}
    wire_busy = sum(wire_ops.values())
    wire_top = sorted(wire_ops.items(), key=lambda kv: -kv[1])[:6]
    wire_device = (f"device busy {wire_busy:.3f} ms; top (ms): "
                   + ", ".join(f"{k} {v:.3f}" for k, v in wire_top)) \
        if wire_ops else "device busy not measured (no device events)"
    # K2 and K1 at the largest leaf, wi (12 x 768 x 4096)
    i_wi = max(range(11), key=lambda i: grads12[i].numel())
    n_wi = grads12[i_wi].numel()
    x_wi = (grads12[i_wi].to(torch.float32) + r0[i_wi]) \
        / wires_k[i_wi].scale
    codes_wi = posit_encode(x_wi, p16, subnormals="normalize")
    assert torch.equal(codes_wi, wires_k[i_wi].data)
    k2_wi_ms = graph_ms(lambda i: posit_encode(x_wi, p16,
                                               subnormals="normalize"), 1)
    k1_wi_ms = graph_ms(lambda i: posit_decode(codes_wi, p16), 1)
    wi_bound_ms = n_wi * (4 + 2) / H100_BYTES_PER_S * 1e3
    k2_wi_plain_ms = time_ms(lambda i: encode_f32(x_wi, p16), 1, iters=1,
                             reps=3)
    k1_wi_plain_ms = time_ms(lambda i: decode_tile(codes_wi, p16), 1,
                             iters=1, reps=3)
    wire_b = wire.wire_bytes(grads12, wire_fmt)
    assert wire_b == n_params * 2 and wire.wire_bytes(grads12, None) \
        == n_params * 4
    del grads12, r0, wires_k, x_wi, codes_wi

    def three_steps(policy):
        """Three train steps of a fresh full-width state under ``policy``:
        ms of each (CUDA events), the losses and the peak memory over what
        was allocated before the state was built."""
        gen_s = torch.Generator(device=dev).manual_seed(args.seed + 12)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        st = init_train_state(cfg, opt12, policy, generator=gen_s,
                              device=dev)
        step = make_train_step(cfg, opt12, policy)
        ms, losses = [], []
        for s in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            st, m = step(st, pipe12(s))
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated()
        assert all(np.isfinite(losses)), losses
        return {"ms": ms, "losses": losses, "peak_bytes": peak,
                "peak_over_base_bytes": peak - base}

    # in turns (without, with, with, without): the host-bound step's time
    # drifts within a call; ms/step is the median of steps 2-3 of both runs
    runs = [three_steps(pol) for pol in (PAPER_EDGE, MIXED_TC, MIXED_TC,
                                         PAPER_EDGE)]
    no_wire, with_wire = runs[0], runs[1]
    for r, other in ((no_wire, runs[3]), (with_wire, runs[2])):
        assert r["losses"] == other["losses"], (r, other)
        r["ms"] = [r["ms"], other["ms"]]
        r["ms_per_step"] = statistics.median(r["ms"][0][1:]
                                             + r["ms"][1][1:])
    phase(f"phase 12b the posit16_2 wire on one full-width step's gradients "
          f"(MIXED_TC, bf16, batch 8 x 1024, {n_grad} values in 11 leaves): "
          f"scales, codes, decoded gradients and residuals bit-exact against "
          f"the plain versions on the card (quant.quantize / dequantize) on "
          f"all 11 leaves; launches per wire {wire_launches}; wire bytes "
          f"{wire_b} (f32 {n_params * 4}); the wire {wire_ms:.3f} ms per "
          f"step (CUDA events, eager), {wire_device}; at wi ({n_wi} values) "
          f"K2 {1e3 * k2_wi_ms:.2f} µs, K1 {1e3 * k1_wi_ms:.2f} µs (CUDA "
          f"graph; bytes bound {1e3 * wi_bound_ms:.2f} each; plain "
          f"{1e3 * k2_wi_plain_ms:.0f} / {1e3 * k1_wi_plain_ms:.0f} µs); "
          f"train step {no_wire['ms_per_step']:.2f} ms without the wire "
          f"(PAPER_EDGE), {with_wire['ms_per_step']:.2f} ms with it "
          f"(MIXED_TC) (CUDA events, median of steps 2-3 of two runs in "
          f"turns; {no_wire['ms']} / {with_wire['ms']}); peak memory {no_wire['peak_bytes']} / "
          f"{with_wire['peak_bytes']} B, over the state's base "
          f"{no_wire['peak_over_base_bytes']} / "
          f"{with_wire['peak_over_base_bytes']} B")

    # 12c. the Trainer at full width under MIXED_TC: 6 steps straight, then
    # checkpoints every 3 steps, a crash at step 4 and a fresh Trainer that
    # restores and finishes; checkpoints under build/ (removed after)
    ck_root = ROOT / "build" / f"chip_smoke_ckpt_{os.getpid()}"
    shutil.rmtree(ck_root, ignore_errors=True)
    tkw = dict(steps=6, global_batch=8, seq_len=1024, seed=args.seed,
               log_every=1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out1 = Trainer(cfg, TrainerConfig(**tkw), opt12, policy=MIXED_TC,
                   device=dev).run()
    straight_s = time.perf_counter() - t0
    train_launches = {k: v for k, v in LAUNCHES.items() if v}
    assert train_launches == {"posit_encode": 66, "posit_decode": 66}, \
        train_launches
    losses1 = [h["loss"] for h in out1["history"]]
    assert len(losses1) == 6 and all(np.isfinite(losses1)), losses1
    with torch.no_grad():
        loss_first = float(lm.loss_fn(out1["state"].params, pipe12(0), cfg,
                                      MIXED_TC)[0])
    assert loss_first < losses1[0], (loss_first, losses1)
    dts = [h["s_per_step"] for h in out1["history"]]
    del out1
    ck_cfg = TrainerConfig(checkpoint_dir=str(ck_root / "run"),
                           checkpoint_every=3, **tkw)
    tr2 = Trainer(cfg, ck_cfg, opt12, policy=MIXED_TC, device=dev,
                  crash_barrier=CrashBarrier(crash_at_steps=[4]))
    crashed = None
    try:
        tr2.run()
    except CrashBarrier.SimulatedFault as e:      # the injected fault
        crashed = str(e)
    assert crashed is not None
    tr2.ckpt.wait()
    assert tr2.ckpt.steps() == [3], tr2.ckpt.steps()
    del tr2
    tr3 = Trainer(cfg, ck_cfg, opt12, policy=MIXED_TC, device=dev)
    state3, start3 = tr3.restore_or_init()
    assert start3 == 3 and int(state3.opt["step"]) == 3
    with np.load(ck_root / "run" / "step_3" / "arrays.npz") as z:
        saved = {k: z[k] for k in z.files}
    restored = _flatten(state3)
    assert restored.keys() == saved.keys() and len(saved) == 5 * 11 + 1
    for k, t in restored.items():
        got = t.cpu()           # bf16 is float32 on disk: exact both ways
        if got.dtype == torch.bfloat16:
            got = got.to(torch.float32)
        assert bits_equal(got, torch.from_numpy(saved[k])), k
    ck_bytes = (ck_root / "run" / "step_3" / "arrays.npz").stat().st_size
    del state3, saved, restored
    out3 = tr3.run()
    losses3 = [h["loss"] for h in out3["history"]]
    np.testing.assert_allclose(out3["metrics"]["loss"], losses1[-1],
                               rtol=1e-5)
    assert tr3.ckpt.steps() == [3, 6], tr3.ckpt.steps()
    # save (the synchronous snapshot), write (the thread) and restore times
    # of one checkpoint of the final state
    shutil.rmtree(ck_root / "run")
    mgr = CheckpointManager(str(ck_root / "timed"), keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgr.save(out3["state"], 6, blocking=False)
    save_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    mgr.wait()
    write_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    mgr.restore(out3["state"])
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    del out3, tr3, mgr
    shutil.rmtree(ck_root)
    phase(f"phase 12c Trainer at full width (MIXED_TC, bf16, batch 8 x "
          f"1024, AdamW lr 1e-3): straight 6 steps, losses "
          f"{[round(v, 5) for v in losses1]} (finite; on the first batch "
          f"{losses1[0]:.5f} -> {loss_first:.5f}), {straight_s:.1f} s, "
          f"step dt {[round(v, 3) for v in dts]} s (CUDA events), "
          f"launches {train_launches} (11 K2 + 11 K1 per step); crash "
          f"injected at step 4 ({crashed!r}) after a checkpoint at 3, a "
          f"fresh Trainer restored step 3 bit for bit (56 leaves) and "
          f"finished: losses {[round(v, 5) for v in losses3]}, final "
          f"{losses3[-1]:.6f} vs {losses1[-1]:.6f} straight (rtol 1e-5); "
          f"checkpoint {ck_bytes} B; save {save_ms:.1f} ms (snapshot to "
          f"host), write {write_ms:.1f} ms (thread), restore "
          f"{restore_ms:.1f} ms")

    # 12d. full-width steps under remat "dots" and "none" against "full"
    # from one state: the same ops, so the same losses and updates; each
    # one's step time and peak memory
    gen_d = torch.Generator(device=dev).manual_seed(args.seed + 13)
    st_full = init_train_state(cfg, opt12, MIXED_TC, generator=gen_d,
                               device=dev)
    remat = {label: {"cfg": dataclasses.replace(cfg, remat=label),
                     "st": st_full if label == "full" else TrainState(
                         snapshot(st_full.params, dev),
                         snapshot(st_full.opt, dev),
                         snapshot(st_full.ef_residual, dev)),
                     "loss": [], "ms": []}
             for label in ("full", "dots", "none")}
    # two steps each, in turns (full, dots, none, none, dots, full); peak
    # memory of each one's first step
    for s_, label in ((0, "full"), (0, "dots"), (0, "none"), (1, "none"),
                      (1, "dots"), (1, "full")):
        r = remat[label]
        step = make_train_step(r["cfg"], opt12, MIXED_TC)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        _, m = step(r["st"], pipe12(s_))
        e1.record()
        torch.cuda.synchronize()
        r["loss"].append(float(m["loss"]))
        r["ms"].append(e0.elapsed_time(e1))
        if s_ == 0:
            r["peak_bytes"] = torch.cuda.max_memory_allocated()
            r["peak_over_base_bytes"] = r["peak_bytes"] - base
    remat_diff = {}
    for label in ("dots", "none"):
        assert remat[label]["loss"] == remat["full"]["loss"], remat
        remat_diff[label] = 0.0
        for a, b in zip(tree_leaves([st_full.params, st_full.opt["master"]]),
                        tree_leaves([remat[label]["st"].params,
                                     remat[label]["st"].opt["master"]])):
            remat_diff[label] = max(remat_diff[label], float(
                (a.float() - b.float()).abs().max()))
        assert remat_diff[label] <= 1e-5, remat_diff
    for r in remat.values():
        del r["cfg"], r["st"]
    del st_full
    phase(f"phase 12d remat dots and none vs full, two full-width MIXED_TC "
          f"steps each from one state, in turns: losses equal "
          f"({[round(v, 6) for v in remat['full']['loss']]}), updated "
          f"params and master max |diff| dots {remat_diff['dots']:.2e}, none "
          f"{remat_diff['none']:.2e} (atol 1e-5); steps full "
          f"{[round(v, 1) for v in remat['full']['ms']]} / dots "
          f"{[round(v, 1) for v in remat['dots']['ms']]} / none "
          f"{[round(v, 1) for v in remat['none']['ms']]} ms (CUDA events); "
          f"peak memory of the first step {remat['full']['peak_bytes']} / "
          f"{remat['dots']['peak_bytes']} / {remat['none']['peak_bytes']} B, "
          f"over the states' base {remat['full']['peak_over_base_bytes']} / "
          f"{remat['dots']['peak_over_base_bytes']} / "
          f"{remat['none']['peak_over_base_bytes']} B")
    print(json.dumps({"training": {
        "wire": {"format": wire_fmt, "values": n_grad, "wire_bytes": wire_b,
                 "f32_bytes": n_params * 4, "launches": wire_launches,
                 "ms_per_step_events": wire_ms,
                 "device_busy_ms": wire_busy if wire_ops else None,
                 "k2_wi_ms": k2_wi_ms, "k1_wi_ms": k1_wi_ms,
                 "wi_bound_ms": wi_bound_ms},
        "train_step": {"no_wire": no_wire, "wire": with_wire},
        "trainer": {"losses_straight": losses1, "losses_restored": losses3,
                    "step_dt_s": dts, "launches": train_launches,
                    "checkpoint_bytes": ck_bytes, "save_ms": save_ms,
                    "write_ms": write_ms, "restore_ms": restore_ms},
        "remat": remat}}), flush=True)
    for entry, name in ((out[0], "posit_decode"), (out[1], "posit_encode")):
        entry["launches_train"] = {"per_step": train_launches[name] // 6,
                                   "total": train_launches[name]}
        entry["wire_wi"] = {
            "ms": k1_wi_ms if name == "posit_decode" else k2_wi_ms,
            "plain_ms": (k1_wi_plain_ms if name == "posit_decode"
                         else k2_wi_plain_ms),
            "bound_ms": wi_bound_ms, "bound_by": "bytes",
            "shape": f"wi gradient, {n_wi} values, posit16_2 (K2 in wire "
                     f"mode)"}
    out[1]["launches"] = train_launches["posit_encode"]

    print(json.dumps({"kernels": out}), flush=True)

    # last line ---------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
