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
guard, runs the serve launcher, serves the full-width MoE model
``granite-moe-1b-a400m`` in both layouts, the full-width SSM model
``mamba2-2.7b`` and the full-width hybrid model ``recurrentgemma-9b`` in
the ring, the full-width vision-language model ``qwen2-vl-2b`` in both
layouts and speculatively and the full-width speech encoder-decoder
``whisper-large-v3``, serves full-width paper-edge through the
KV-sequence-sharded distributed decode (one NCCL rank, then two gloo
ranks spawned on the one card), runs the TALU's exact posit arithmetic
on the card and builds paper-edge's decode_32k cell there against the
meta-device dry run's reckoning, times every kernel and prints one JSON
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
``{"energy": ...}`` JSON line.  Phase 15 runs after 14 (own generators):
15a ``granite-moe-1b-a400m`` at full width and depth (24 layers, 32
experts top-8, bf16 seeded weights, ``paper_edge_p8``) serving phase 6's
eight prompts, 32 tokens each, in the ring and then the paged layout (one
exact-length prefill per prompt: MoE routing sees every row of a call),
each with a profiled window of five engine steps, 8 slots live; 15b card
vs CPU at float32 on the MoE smoke config, ring and paged; 15c
``moe_ffn``'s einsum and scatter dispatch on the card at the longest
prompt's shape; a ``{"moe": ...}`` JSON line.  Phase 16 runs after 15
(own generators): 16a ``mamba2-2.7b`` at full width and depth (64
layers, d 2560, bf16 seeded weights, ``paper_edge_p8``, ring) serving
eight prompts of 96-768 tokens (each at most the 256-token chunk or a
multiple of it), 32 tokens each, one exact-length prefill per prompt,
with a profiled window of five engine steps, 8 slots live; 16b card vs
CPU at float32 on the mamba2 smoke config (a two-chunk prefill, then two
decode steps from the card's state); 16c the refusals on the card; an
``{"ssm": ...}`` JSON line.  Phase 17 runs after 16 (own generators):
17a ``recurrentgemma-9b`` at full width and depth (38 layers, d 4096, 16
query heads of 256 over 1 KV head, window 2048, bf16 seeded weights,
``paper_edge_p8``, ring, max_len 4096) serving eight prompts of
182-3,500 tokens (four past the window: their prefills wrap the ring),
32 tokens each, one exact-length prefill per prompt, with a profiled
window of five engine steps, 8 slots live; 17b K3 and K4 alone at its
shapes (hd 256, 16 query heads per KV head, 2048-row rings) in three
formats, with times; 17c card vs CPU at float32 on the recurrentgemma
smoke config (prompts that wrap its 16-row ring, then decode steps from
the card's state); 17d the refusals on the card; a ``{"hybrid": ...}``
JSON line.  Phase 18 runs after 17 (own generators): 18a ``qwen2-vl-2b``
at full width and depth (28 layers, d 1536, 12 query heads of 128 over 2
KV heads, M-RoPE, tied 151,936-row table, bf16 seeded weights,
``paper_edge_p8``, max_len 1024) serving phase 6's eight prompts, 32
tokens each, one exact-length prefill per prompt, in the ring and the
paged layout, each with a profiled window of five engine steps, then the
``SpeculativeEngine`` (ring, gamma 2) over four of them, then a prefill
over seeded (8, 256, 1536) patch embeddings and 16 decode steps; 18b
``whisper-large-v3`` at full width and depth (32 encoder and 32 decoder
layers, d 1280, 20 heads of 64, bf16 seeded weights, ``paper_edge_p8``,
max_len 448): 8 clips of seeded (1500, 1280) frame embeddings with the
4-token start-of-transcript prompt, one ``prefill`` and 64 greedy
``decode_step`` calls, a profiled window of five, the plain
cross-attention timed alone, then the paged layout for a prefill and 8
steps; 18c K3/K4 and K5/K6 alone at hd 128 with 6 query heads per KV head
and at hd 64 over 20 KV heads, in three formats, with times; 18d both
smoke configs card vs CPU at float32; 18e the refusals on the card; a
``{"vlm_audio": ...}`` JSON line.  Phase 19 runs after 18 (own
generators): full-width paper-edge (``paper_edge_p8``, phase 6's eight
prompts x 32 tokens, max_len 1024) served first by the undistributed
engine, ring and a posit8 pool of 258 16-row pages, at float32 and
bf16; 19a one rank over NCCL (world 1, the production backend), ring,
float32, through the distributed decode attention; 19b two processes
spawned on the one card over gloo (a ``file://`` init in a temporary
directory; NCCL refuses two ranks on one device), each holding half the
KV sequence, both layouts and dtypes, with windows of decode steps for
the step's wall, the profiler's kernel names and the combine's
synchronised time; a ``{"distributed": ...}`` JSON line.  Phase 20 runs
after 19: 20a the exact posit arithmetic (``core.posit.mul`` / ``add`` /
``sub`` on every pair of P(8,0) and P(8,2) codes, 2^20 seeded P(16,1)
pairs, ``thermometer_decode`` of every P(8,2) code, ``matmul_exact`` of
P(8,2) codes at (8, 768) x (768, 768) with its wall and kernel launches)
and the TALU cycle simulator on every Table III cell; 20b paper-edge's
``decode_32k`` cell (128 slots, 32,768-row rings, every row live) built
on the card under bf16 and then posit8 KV, its allocated bytes against
``launch/dryrun``'s reckoning for one card, and two decode steps; an
``{"arith_dryrun": ...}`` JSON line.  Phase 12 runs
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
  MoE (15a)      every request finishes with its 32 tokens, no error, no
                 page leaked; K3 + K4 (ring) or K5 + K6 (paged) launched
                 24 times per decode step (once per layer) and K3 24 times
                 per prefill, by the wrappers' counts over the served run
                 and the profiled window, and by the profiler's kernel
                 names (append_kernel, split_kernel, combine_kernel) where
                 its trace holds all three.
  MoE (15b)      phase 7's rules (a) and (b) on the MoE smoke config, the
                 CPU's steps taken from the card's pre-step states; the
                 router's idx_k equal on both devices on every row whose
                 top-k gap exceeds 1e-4, in the first two prefills and in
                 (a)'s steps.
  MoE (15c)      einsum vs scatter at float32, TF32 off: rtol 1e-4, atol
                 1e-4 of the output's largest magnitude; aux equal.
  SSM (16a)      every request finishes with its 32 tokens, no error;
                 every prefill and decode logit finite; the recurrent
                 state 1,358,692,352 B, the KV-cache bytes 0; none of
                 K1-K7 launched, by the wrappers' counts over the served
                 run and the profiled window and by the profiler's kernel
                 names.
  SSM (16b)      card vs CPU at float32, TF32 off: the prefill's logits,
                 final SSD state and conv state, then two decode steps'
                 logits and states (each from the card's state), within
                 rtol 1e-3, atol 1e-3.
  SSM (16c)      a CUDA SSM engine builds under posit8 KV; the paged
                 layout and SpeculativeEngine raise ValueError, a 40-token
                 smoke prompt AssertionError.
  hybrid (17a)   every request finishes with its 32 tokens, no error;
                 every prefill and decode logit finite; KV cache
                 102,236,160 B, recurrent state 8,519,680 B; K3 12 per
                 decode step and per prefill, K4 12 per decode step, K1,
                 K2, K5-K7 0, by the wrappers' counts over the served run
                 and the profiled window and by the profiler's kernel
                 names where its trace holds K3's and K4's.
  hybrid (17b)   K3 bit-exact against kv_append_rows_ref from f32 and
                 bf16 rows (rows not written unchanged at T = 1); K4
                 rtol 1e-5, atol 1e-5 (bf16 q 2^-7) against
                 decode_attention_ref, at hd 256 and 16 query heads.
  hybrid (17c)   card vs CPU at float32, TF32 off: logits, h and conv
                 within rtol 1e-3, atol 1e-3; ring scales equal, codes
                 differing on < 0.1 %, each one posit step or near zero.
  hybrid (17d)   a CUDA hybrid engine builds and serves under posit8 KV;
                 paged, SpeculativeEngine and a true_len prefill raise
                 ValueError.
  vlm (18a)      every request finishes with its 32 tokens, no error;
                 every prefill and decode logit finite (the engines' and
                 the embeddings prefill's and steps'); ring KV
                 121,110,528 B; K3 + K4 28 per ring decode step and K3
                 28 per prefill, K5 + K6 28 per paged decode step, K1 56
                 per speculative round, K2 and K7 0, by the wrappers'
                 counts over the served runs and the profiled windows,
                 and by the profiler's kernel names where its trace holds
                 K3's and K4's.
  audio (18b)    every logit finite; self K/V 311,951,360 B, cross K/V
                 1,966,080,000 B, memory 30,720,000 B; K3 32 in the
                 prefill and 32 per decode step, K4 32 per step; paged:
                 K5 32 per prefill and step, K6 32 per step; K1, K2, K7
                 0; the timed cross-attention call equal to the decode
                 step's bit for bit.
  KV (18c)       K3 and K5 bit-exact against their plain versions from f32
                 and bf16 rows (rows not written unchanged at T = 1); K4
                 and K6 rtol 1e-5, atol 1e-5 (bf16 q 2^-7), at hd 128 with
                 6 query heads per KV head and at hd 64 over 20 KV heads.
  vlm, audio (18d) card vs CPU at float32, TF32 off: logits, memory, xk
                 and xv within rtol 1e-3, atol 1e-3; ring scales equal,
                 codes differing on < 0.1 %, each one posit step or near
                 zero.
  refusals (18e) a CUDA vlm engine serves; a CUDA audio engine builds and
                 its first admission, SpeculativeEngine for it, a
                 true_len prefill of vlm embeddings and of audio, and an
                 audio prefill over packed weights raise ValueError.
  distributed (19) every request gets its 32 tokens, every logit finite;
                 float32 streams (19a, and both 19b ranks, ring and
                 paged) equal to the undistributed engine's; both ranks'
                 streams equal at bf16, whose first decode step's logits
                 are within 0.1 of the undistributed engine's (the port's
                 bf16 parity tolerance; tokens that agree counted); a
                 rank's ring KV 26,738,688 B and pool KV half the
                 undistributed engine's; 24 collectives a decode step,
                 25,344 B a layer (304,128 B a step at max_len 512 and
                 1024); K5 12 and K1 24 per decode step, K3 12 per
                 prefill, the rest 0, by the wrappers' counts and, where
                 its trace holds them, the profiler's kernel names.
  arithmetic (20a) bit-exact: card against the CPU run of the same
                 functions, the P(8,*) tables and 4 matmul entries also
                 against ``posit_ref`` (the latter as its sequential
                 add(mul) chain); TALU cycles equal to TABLE3.
  dry run (20b)  each part of each build (params, cache, token batch): the
                 card's requested bytes equal to the dry run's argument
                 bytes for that part under ``make_host_mesh(1)``;
                 allocated over all within 1e-4; logits finite; K3 and K4
                 12 launches a step under posit8 KV, none under bf16; K3
                 on layer 0's 32,768-row ring at B 128 bit-exact to its
                 plain version (pos W: the wrap; seeded positions), K4
                 there within 1e-5 (f32 q, ragged lengths) and 2^-7 (bf16
                 q, full); the card's memory back to its base after both.
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
K3-K6 also carry ``launches_moe`` (15a: per layout, the served run's
count and the profiled window's per decode step); every entry carries
``launches_ssm``, its count over 16a's served run (0: a mamba2 step runs
no kernel of the port), and ``launches_hybrid``, its count over 17a's
served run and per decode step (K3 and K4 12, the rest 0); K3's and
K4's entries carry ``hd256``, 17b's times at the hybrid's shapes beside
their bounds; every entry carries ``launches_vlm`` (18a: the ring,
paged, speculative and embeddings runs' counts and per decode step) and
``launches_audio`` (18b: the prefill's, 64 ring steps', per step and the
paged prefill and 8 steps'), and K3-K6's ``hd128_grp6`` and
``hd64_grp1``, 18c's posit8 times at those shapes beside their bounds;
every entry carries ``launches_distributed`` (19a's served run, 19b rank
0's ring and paged float32 runs, and per decode step) and
``launches_decode_32k`` (20b: per decode step, bf16 and posit8 KV);
K2's ``launches`` are
the training path's (12c: the Trainer's 6 steps);
K1's and K2's entries carry ``launches_train`` (per step and total, 12c)
and ``wire_wi``, their time at the wire's largest leaf (wi's gradient,
37,748,736 values, posit16_2) against its bytes bound.  The decode-step and
train-step profiles (device busy, idle share) come from a torch.profiler
trace and read "not measured" where the trace holds no device events.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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

    names = ("rms_norm", "_qkv", "_einsum", "_ffn")
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


MOE_ARCH = "granite-moe-1b-a400m"
# the KV kernels a MoE decode step runs: K3 + K4 (ring), K5 + K6 (paged)
MOE_KERNELS = ("kv_append_rows", "decode_attention", "paged_kv_append_rows",
               "paged_decode_attention")


def tensor_bytes(tree) -> int:
    """Bytes of every tensor leaf of ``tree``."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(tensor_bytes(v) for v in tree)
    return 0


def op_device_ms(prof, n: int, top: int = 8):
    """The ``top`` aten ops by self device ms per call over ``n`` calls in a
    profiler trace taken with CPU and CUDA activity (an op's kernels
    charged to the op that launched them)."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((e.key, us / n / 1e3))
    return dict(sorted(rows, key=lambda r: -r[1])[:top])


def route_gaps(params, tokens, top_k):
    """Per row of ``tokens``: the smallest gap between neighbouring sorted
    router gates over the top k + 1 (the order ``_route`` keeps and the
    k-th / (k+1)-th boundary), from the router product in float64."""
    import torch
    g = torch.softmax(tokens.double() @ params["router"].double(), dim=-1)
    top = torch.sort(g, dim=-1, descending=True).values[:, :top_k + 1]
    return (top[:, :-1] - top[:, 1:]).min(dim=-1).values


def phase15a(dev, seed, prompts, warm, card: str) -> dict:
    """15a. ``granite-moe-1b-a400m`` at full width and depth (bf16 seeded
    weights, ``paper_edge_p8``: posit8 weights hoisted, posit8 KV), max
    batch 8, max_len 1024, phase 6's eight prompts, 32 new tokens each,
    ring then paged (full pool of 16-row pages).  Every request finishes
    with 32 tokens and no error; K3 + K4 (ring) and K5 + K6 (paged) launch
    once per layer of every decode step (and K3 once per layer of every
    prefill), by the wrappers' counts over the served run and over a
    profiled window of engine steps, and by the profiler's kernel names
    (``append_kernel``, ``split_kernel``) where its trace holds them.
    Prints the decode step's wall, device busy, idle share and launches,
    prefill ms per prompt, peak memory and the weight-bytes bound, each
    line with ``card`` (the card's name and power limit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg = get_config(MOE_ARCH)
    n_l = cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    params = lm.init_params(cfg, gen, device=dev)
    # a decode step reads every weight once: the einsum dispatch runs all
    # experts (C = 2 at T = 8), and the tied head reads the whole table
    w_bytes = tensor_bytes(params)
    bound_ms = 1e3 * w_bytes / H100_BYTES_PER_S
    out = {"card": card, "arch": MOE_ARCH, "params": cfg.param_count(),
           "weight_bytes_per_step": w_bytes, "bound_ms": bound_ms,
           "bound_by": "bytes"}
    n_prof = 5
    for layout, kw in (("ring", {}),
                       ("paged", {"kv_layout": "paged", "page_size": PS})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=B, max_len=W, kv_format="posit8", **kw),
            policy="paper_edge_p8", device=dev)
        eng.serve([Request(uid=-1, prompt=warm, max_new=3)])   # warm-up
        peak_build = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reqs = [Request(uid=i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)]
        eng.tracer.reset()
        eng.tracer.enable()
        steps0, pre0 = eng.stats["decode_steps"], eng.stats["prefills"]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        eng.tracer.disable()
        st = eng.tracer.self_times()
        steps = eng.stats["decode_steps"] - steps0
        prefills = eng.stats["prefills"] - pre0
        assert all(r.done and r.error is None and len(r.out_tokens) == 32
                   for r in reqs), layout
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
        assert prefills == len(prompts), prefills     # one per prompt
        if layout == "ring":
            want = {"kv_append_rows": n_l * (steps + prefills),
                    "decode_attention": n_l * steps,
                    "paged_kv_append_rows": 0, "paged_decode_attention": 0}
        else:
            want = {"kv_append_rows": n_l * prefills, "decode_attention": 0,
                    "paged_kv_append_rows": n_l * steps,
                    "paged_decode_attention": n_l * steps}
            eng.allocator.assert_consistent()
            assert eng.allocator.live_pages == 0
        assert {k: launches[k] for k in want} == want, (layout, launches)

        def stage_ms(stage):
            n = st[f"{stage}.device"]["count"]
            return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                          + st[f"{stage}.device"]["total_s"]) / n

        # a profiled window: the 8 prompts readmitted (one exact-length
        # prefill each), then n_prof engine steps with 8 slots live
        eng._admit([Request(uid=100 + i, prompt=p, max_new=32)
                    for i, p in enumerate(prompts)])
        assert all(r is not None for r in eng.slot_req), layout
        torch.cuda.synchronize()
        reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n_prof):
                eng.step()
            torch.cuda.synchronize()
            step_ms = 1e3 * (time.perf_counter() - t0) / n_prof
        per_step = {k: LAUNCHES[k] / n_prof for k in MOE_KERNELS}
        kv = (("kv_append_rows", "decode_attention") if layout == "ring"
              else ("paged_kv_append_rows", "paged_decode_attention"))
        assert all(per_step[k] == n_l for k in kv), (layout, per_step)
        n_kernels = {}
        per_kernel = {k: v / n_prof / 1e3
                      for k, v in device_events(prof, n_kernels).items()}
        traced = {k: n_kernels.get(k, 0) / n_prof
                  for k in ("append_kernel", "split_kernel",
                            "combine_kernel")}
        if per_kernel and all(traced.values()):
            assert traced == {k: n_l for k in traced}, (layout, traced)
        busy = sum(per_kernel.values()) if per_kernel else None
        gemm = sum(v for k, v in per_kernel.items()
                   if any(t in k.lower() for t in ("gemm", "nvjet", "xmma",
                                                    "cutlass")))
        top = sorted(per_kernel.items(), key=lambda kv_: -kv_[1])[:6]
        # where the device time goes by op: two more steps traced with the
        # host's ops too (a slower window: its wall is not reported)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_ops:
            for _ in range(2):
                eng.step()
            torch.cuda.synchronize()
        ops = op_device_ms(prof_ops, 2)
        eng.serve([])                                   # drain
        peak = torch.cuda.max_memory_allocated()
        out[layout] = {
            "steps": steps, "prefills": prefills, "serve_wall_s": wall,
            "tok_s": 8 * 32 / wall, "prefill_ms": stage_ms("prefill"),
            "decode_ms": stage_ms("generate"),
            "launches": {k: launches[k] for k in MOE_KERNELS},
            "profiled": {
                "step_wall_ms": step_ms, "wrapper_launches_per_step":
                    per_step,
                "traced_kernels_per_step": traced,
                "device_busy_ms": busy,
                "idle_share": None if busy is None else 1 - busy / step_ms,
                "gemm_ms": gemm if per_kernel else None,
                "kernel_launches_per_step":
                    sum(n_kernels.values()) / n_prof if per_kernel else None,
                "top_kernels_ms": dict(top), "top_ops_ms": ops},
            "peak_memory_bytes": peak, "peak_memory_build_bytes": peak_build}
        device = (f"device busy {busy:.3f} ms/step (weight-bytes bound "
                  f"{bound_ms:.3f} ms), of which GEMMs {gemm:.3f}, idle "
                  f"share {1 - busy / step_ms:.3f}; kernel launches "
                  f"{sum(n_kernels.values()) / n_prof:.1f}/step; traced "
                  f"per step {traced}; top kernels (ms/step): "
                  + ", ".join(f"{k} {v:.3f}" for k, v in top)
                  + "; top ops by self device ms/step: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in ops.items())
                  if per_kernel else "device busy and idle share not "
                  "measured (the profiler trace held no device events)")
        phase(f"phase 15a [{card}] {MOE_ARCH} {layout}: {n_l}L "
              f"d{cfg.d_model} "
              f"{cfg.n_heads}/{cfg.n_kv_heads}h hd{cfg.head_dim} "
              f"{cfg.moe_experts} experts top-{cfg.moe_topk} d_ff "
              f"{cfg.d_ff} vocab {cfg.vocab} ({cfg.param_count()} params, "
              f"bf16, posit8 weights and KV), 8 prompts of "
              f"{sorted(len(p) for p in prompts)} tokens, 32 new each: "
              f"{prefills} prefills {stage_ms('prefill'):.2f} ms/prompt, "
              f"{steps} decode steps {stage_ms('generate'):.3f} ms/step, "
              f"{8 * 32 / wall:.1f} tok/s; launches "
              f"{ {k: launches[k] for k in MOE_KERNELS} }; profiled engine "
              f"step (8 slots live): wall {step_ms:.3f} ms/step, wrapper "
              f"launches/step {per_step}, {device}; peak memory {peak} B "
              f"serving ({peak_build} B building the engine: hoisting)")
        del eng
    out["launches_per_decode_step"] = n_l
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase15b(dev, seed, snapshot, code_flips) -> dict:
    """15b. Card vs CPU at float32 (TF32 off) on the MoE smoke config, by
    phase 7/7b's rules, ring and paged: (a) the CPU's decode steps 1 and 2
    from the card's pre-step states within rtol 1e-3, atol 1e-3 of the
    card's logits; (b) the caches each device wrote from its own prefills:
    scales equal, codes by ``code_flips`` on < 0.1 % of the written codes;
    and the router's ``idx_k`` equal on the two devices, in those prefills
    and in (a)'s steps, on every row whose top-k gap exceeds 1e-4 (the
    smallest gap printed)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg = dataclasses.replace(get_config(MOE_ARCH, smoke=True),
                              dtype_name="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed),
                            device="cpu")
    rng15 = np.random.default_rng([seed, 15])
    prompts = [rng15.integers(0, cfg.vocab, n) for n in (19, 40, 27)]
    routes, key = {}, [None]
    route = moe_mod._route

    def recorded(p, tokens, top_k, cf):
        r = route(p, tokens, top_k, cf)
        routes.setdefault(key[0], []).append(
            (r[1].cpu(), route_gaps(p, tokens, top_k).cpu()))
        return r

    def keyed(fn, tag, dev_):
        n = [0]

        def run(*a):
            key[0] = (dev_, tag, n[0])
            n[0] += 1
            return fn(*a)
        return run

    def agree(a, b):
        """(rows compared, smallest gap) over two route records; idx_k
        equal wherever the gap exceeds 1e-4."""
        rows, smallest = 0, float("inf")
        assert len(a) == len(b) == cfg.n_layers
        for (ia, ga), (ib, _) in zip(a, b):
            far = ga > 1e-4
            assert torch.equal(ia[far], ib[far]), (ia, ib, ga)
            rows += int(ga.numel())
            smallest = min(smallest, float(ga.min()))
        return rows, smallest

    out = {}
    moe_mod._route = recorded
    try:
        for layout, kw in (("ring", {}),
                           ("paged", {"kv_layout": "paged",
                                      "page_size": PS})):
            runs = {}
            for device in ("cuda", "cpu"):
                e = ServingEngine(cfg, params, ServeConfig(
                    max_batch=2, max_len=64, kv_format="posit8", **kw),
                    policy="paper_edge_p8",
                    device=dev if device == "cuda" else "cpu")
                rec = {"logits": [], "tok": [], "states": []}
                gen_fn = e.engine.generate

                def generate_logged(params_, state, _g=gen_fn, _r=rec):
                    if len(_r["tok"]) < 3:
                        _r["states"].append(snapshot(state))
                    _r["tok"].append(state["tok"].detach().cpu().clone())
                    state, logits = _g(params_, state)
                    _r["logits"].append(logits.detach().cpu())
                    return state, logits

                e.engine.generate = keyed(generate_logged, "gen", device)
                e.engine.prefill = keyed(e.engine.prefill, "prefill",
                                         device)
                rq = [Request(uid=i, prompt=p, max_new=8)
                      for i, p in enumerate(prompts)]
                e.serve(rq)
                assert all(len(r.out_tokens) == 8 for r in rq)
                runs[device] = (rec, [r.out_tokens for r in rq], e, gen_fn)
            card, cpu = runs["cuda"][0], runs["cpu"][0]
            cut = PS if kw else 0
            # the two prefills before the first step: independent runs
            rows, smallest = 0, float("inf")
            for n in range(2):
                r, s = agree(routes[("cuda", "prefill", n)],
                             routes[("cpu", "prefill", n)])
                rows, smallest = rows + r, min(smallest, s)
            # (a) the CPU's steps 1 and 2 from the card's pre-step states
            e_cpu, cpu_generate = runs["cpu"][2], runs["cpu"][3]
            dmax = 0.0
            for i in range(2):
                state = snapshot(card["states"][i])
                state["tok"] = card["tok"][i].clone()
                key[0] = ("replay", "gen", i)
                _, logits = cpu_generate(e_cpu.params, state)
                torch.testing.assert_close(logits, card["logits"][i],
                                           rtol=1e-3, atol=1e-3)
                dmax = max(dmax, float((logits - card["logits"][i]).abs()
                                       .max()))
                r, s = agree(routes[("cuda", "gen", i)],
                             routes[("replay", "gen", i)])
                rows, smallest = rows + r, min(smallest, s)
            # (b) the caches each device wrote from its own prefills
            c0 = card["states"][0]["blocks"][0]
            p0 = cpu["states"][0]["blocks"][0]
            for k in ("k_scale", "v_scale"):
                assert torch.equal(c0[k][:, cut:], p0[k][:, cut:]), (
                    layout, k)
            flips = [code_flips(c0[k][:, cut:], p0[k][:, cut:])
                     for k in ("k", "v")]
            codes_diff = sum(f[0] for f in flips)
            written = (int(card["states"][0]["pos"].sum()) * cfg.n_layers
                       * cfg.n_kv_heads * cfg.head_dim * 2)
            assert codes_diff < 1e-3 * written, (layout, codes_diff,
                                                 written)
            same = [sum(a == b for a, b in zip(x, y))
                    for x, y in zip(runs["cuda"][1], runs["cpu"][1])]
            out[layout] = {"logits_max_abs_diff": dmax,
                           "codes_differ": codes_diff, "written": written,
                           "routed_rows": rows, "smallest_gap": smallest,
                           "tokens_equal": same}
            phase(f"phase 15b {layout} card vs CPU, MoE smoke (float32, "
                  f"TF32 off): (a) CPU steps from the card's states within "
                  f"rtol 1e-3 atol 1e-3 (max |diff| {dmax:.3e}); (b) "
                  f"scales equal, {codes_diff} of {written} written K/V "
                  f"codes differ; idx_k equal on every routed row with a "
                  f"top-k gap > 1e-4 ({rows} rows over the two prefills "
                  f"and two steps; smallest gap {smallest:.3e}); greedy "
                  f"tokens equal per request {same} of 8 (not asserted)")
            routes.clear()
    finally:
        moe_mod._route = route
    return out


def phase15c(dev, seed, n_tok) -> dict:
    """15c. ``moe_ffn``'s einsum and scatter dispatch on the card at a
    full-width prefill's shape (one prompt of ``n_tok`` tokens, d 1024, 32
    experts top-8; at 894 tokens cap 279, where ``auto`` picks scatter),
    on one seeded
    layer's experts: float32 (TF32 off) outputs within rtol 1e-4, atol
    1e-4 of the output's largest magnitude, aux equal; both paths timed in
    bf16 (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    cfg = get_config(MOE_ARCH)
    gen = torch.Generator(device=dev).manual_seed(seed + 151)
    p32 = moe_mod.init_moe(cfg.d_model, cfg.d_ff, cfg.moe_experts,
                           torch.float32, dev, gen)
    x32 = torch.randn((1, n_tok, cfg.d_model), generator=gen, device=dev)
    cap = moe_mod.capacity(n_tok, cfg.moe_topk, cfg.moe_experts,
                           cfg.capacity_factor)
    auto = moe_mod.dispatch_for(n_tok, cfg.moe_experts, cap)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        res = {d: moe_mod.moe_ffn(p32, x32, top_k=cfg.moe_topk,
                                  capacity_factor=cfg.capacity_factor,
                                  dispatch=d)
               for d in ("einsum", "scatter")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (a, aux_a), (b, aux_b) = res["einsum"], res["scatter"]
    scale = float(a.abs().max())
    torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4 * scale)
    assert float(aux_a) == float(aux_b)
    diff = float((a - b).abs().max())
    pb = {k: v.to(torch.bfloat16) if k != "router" else v
          for k, v in p32.items()}
    xb = x32.to(torch.bfloat16)
    ms = {d: time_ms(lambda i, _d=d: moe_mod.moe_ffn(
        pb, xb, top_k=cfg.moe_topk, capacity_factor=cfg.capacity_factor,
        dispatch=_d), 1, iters=5, reps=3) for d in ("einsum", "scatter")}
    phase(f"phase 15c moe_ffn einsum vs scatter on the card at T = {n_tok}, "
          f"cap {cap}, auto picks {auto} (float32, TF32 off): max |diff| "
          f"{diff:.3e} on outputs "
          f"up to {scale:.3e}, aux equal; bf16 ms per call einsum "
          f"{ms['einsum']:.3f}, scatter {ms['scatter']:.3f}")
    del p32, pb, x32, xb, res
    return {"tokens": n_tok, "cap": cap, "auto": auto, "max_abs_diff": diff,
            "scale": scale, "ms_bf16": ms}


SSM_ARCH = "mamba2-2.7b"
# every kernel of the port, by the profiler's short name (K1, K2, K3/K5,
# K4/K6 and K7's two paths with their combine)
PORT_KERNEL_NAMES = ("posit_decode_kernel", "posit_encode_kernel",
                     "append_kernel", "split_kernel", "combine_kernel",
                     "tc_kernel", "skinny_kernel")
SSM_PROMPT_LENS = (96, 182, 200, 256, 256, 512, 512, 768)


def phase16a(dev, seed, card: str) -> dict:
    """16a. ``mamba2-2.7b`` at full width and depth (64 layers, d 2560,
    bf16 seeded weights, the published config uncut), ``paper_edge_p8``
    (posit8 in_proj / out_proj hoisted; the posit8 KV format has no K/V
    to hold), ring layout, max batch 8, max_len 1024: eight prompts of
    ``SSM_PROMPT_LENS`` tokens (each at most ``ssm_chunk`` or a multiple
    of it, as the chunked scan requires), 32 new tokens each, one
    exact-length prefill per prompt.  Asserts every request finishes with
    its 32 tokens and no error, every prefill and decode logit is finite,
    the recurrent state is 8 slots x (80 x 64 x 128 f32 + 3 x 5376 bf16)
    x 64 layers = 1,358,692,352 B, and none of K1-K7 launches (the
    wrappers' counts over the served run and the profiled window, and the
    profiler's kernel names).  Prints the decode step's wall, device
    busy, idle share and launches per step over a profiled window of 5
    engine steps with 8 slots live, the top ops by device ms, prefill ms
    per prompt, tok/s, weight and state bytes, and peak memory, each line
    with ``card``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg = get_config(SSM_ARCH)
    n_l = cfg.n_layers
    rng16 = np.random.default_rng([seed, 16])
    prompts = [rng16.integers(0, cfg.vocab, n) for n in SSM_PROMPT_LENS]
    warm = rng16.integers(0, cfg.vocab, 64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed + 16)
    params = lm.init_params(cfg, gen, device=dev)
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=B, max_len=W, kv_format="posit8"),
        policy="paper_edge_p8", device=dev)
    del params
    nonfinite = []
    generate, prefill = eng.engine.generate, eng.engine.prefill

    def generate_checked(params_, state):
        state, logits = generate(params_, state)
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append("generate")
        return state, logits

    def prefill_checked(params_, tokens, lengths=None):
        prefix = prefill(params_, tokens, lengths)
        if not bool(torch.isfinite(prefix["logits"]).all()):
            nonfinite.append("prefill")
        return prefix

    eng.engine.generate, eng.engine.prefill = generate_checked, \
        prefill_checked
    eng.serve([Request(uid=-1, prompt=warm, max_new=3)])     # warm-up
    torch.cuda.synchronize()
    peak_build = torch.cuda.max_memory_allocated()
    w_bytes = tensor_bytes(eng.params)
    state_bytes = tensor_bytes(eng.cache["blocks"])
    assert state_bytes == 1_358_692_352, state_bytes
    assert eng.kv_cache_bytes() == 0
    # a decode step reads every weight once (the tied head the whole
    # table) and reads and writes the whole recurrent state
    bound_ms = 1e3 * (w_bytes + 2 * state_bytes) / H100_BYTES_PER_S
    torch.cuda.reset_peak_memory_stats()
    reqs = [Request(uid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    eng.tracer.reset()
    eng.tracer.enable()
    steps0, pre0 = eng.stats["decode_steps"], eng.stats["prefills"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.tracer.disable()
    st = eng.tracer.self_times()
    steps = eng.stats["decode_steps"] - steps0
    prefills = eng.stats["prefills"] - pre0
    assert not nonfinite, nonfinite
    assert all(r.done and r.error is None and len(r.out_tokens) == 32
               for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    assert prefills == len(prompts), prefills      # one per prompt
    assert not any(launches.values()), launches    # no K1-K7

    def stage_ms(stage):
        n = st[f"{stage}.device"]["count"]
        return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                      + st[f"{stage}.device"]["total_s"]) / n

    # a profiled window: the 8 prompts readmitted (one exact-length
    # prefill each), then n_prof engine steps with 8 slots live
    n_prof = 5
    eng._admit([Request(uid=100 + i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)])
    assert all(r is not None for r in eng.slot_req)
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    assert not any(LAUNCHES.values()), dict(LAUNCHES)
    assert not nonfinite, nonfinite
    n_kernels = {}
    per_kernel = {k: v / n_prof / 1e3
                  for k, v in device_events(prof, n_kernels).items()}
    ported = {k: n for k, n in n_kernels.items()
              if k.split("[")[0] in PORT_KERNEL_NAMES}
    assert not ported, ported
    busy = sum(per_kernel.values()) if per_kernel else None
    top = sorted(per_kernel.items(), key=lambda kv_: -kv_[1])[:6]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_ops:
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
    ops = op_device_ms(prof_ops, 2)
    eng.serve([])                                       # drain
    peak = torch.cuda.max_memory_allocated()
    out = {
        "card": card, "arch": SSM_ARCH, "params": cfg.param_count(),
        "prompt_lens": list(SSM_PROMPT_LENS), "steps": steps,
        "prefills": prefills, "serve_wall_s": wall, "tok_s": 8 * 32 / wall,
        "prefill_ms": stage_ms("prefill"), "decode_ms": stage_ms("generate"),
        "launches": launches,
        "weight_bytes": w_bytes, "state_bytes": state_bytes,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "profiled": {
            "step_wall_ms": step_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / step_ms,
            "kernel_launches_per_step":
                sum(n_kernels.values()) / n_prof if per_kernel else None,
            "port_kernels_traced": ported,
            "top_kernels_ms": dict(top), "top_ops_ms": ops},
        "peak_memory_bytes": peak, "peak_memory_build_bytes": peak_build}
    device = (f"device busy {busy:.3f} ms/step (bytes bound {bound_ms:.3f} "
              f"ms: weights + state read and written), idle share "
              f"{1 - busy / step_ms:.3f}; kernel launches "
              f"{sum(n_kernels.values()) / n_prof:.1f}/step, none of "
              f"K1-K7; top kernels (ms/step): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top)
              + "; top ops by self device ms/step: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ops.items())
              if per_kernel else "device busy and idle share not measured "
              "(the profiler trace held no device events)")
    phase(f"phase 16a [{card}] {SSM_ARCH}: {n_l}L d{cfg.d_model} "
          f"ssm state {cfg.ssm_state} headdim {cfg.ssm_headdim} chunk "
          f"{cfg.ssm_chunk} vocab {cfg.vocab} ({cfg.param_count()} params, "
          f"bf16, posit8 in/out projections), ring, 8 prompts of "
          f"{list(SSM_PROMPT_LENS)} tokens, 32 new each: {prefills} "
          f"exact-length prefills {stage_ms('prefill'):.2f} ms/prompt, "
          f"{steps} decode steps {stage_ms('generate'):.3f} ms/step, "
          f"{8 * 32 / wall:.1f} tok/s; every logit finite; K1-K7 launches "
          f"0; profiled engine step (8 slots live): wall {step_ms:.3f} "
          f"ms/step, {device}; weights {w_bytes} B, recurrent state "
          f"{state_bytes} B; peak memory {peak} B serving ({peak_build} B "
          f"building the engine: hoisting)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase16b(dev, seed) -> dict:
    """16b. Card vs CPU at float32 (TF32 off) on the mamba2 smoke config,
    ``paper_edge_p8`` per-call weight hook: a 64-token prompt (two chunks
    of 32, so the inter-chunk scan runs) prefilled on both devices, its
    logits, final SSD state and conv state within rtol 1e-3, atol 1e-3;
    then two decode steps, each from the card's state on both devices
    (logits and new states within the same tolerance)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm, serve_model
    cfg = dataclasses.replace(get_config(SSM_ARCH, smoke=True),
                              dtype_name="float32")
    policy = get_policy("paper_edge_p8")
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed + 16),
                            device="cpu")
    params_d = tree_to(params, dev)
    tokens = torch.as_tensor(np.random.default_rng([seed, 161]).integers(
        0, cfg.vocab, (1, 64)))
    tol = dict(rtol=1e-3, atol=1e-3)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    dmax = {}

    def close(name, card_t, cpu_t):
        card_t = card_t.cpu()
        torch.testing.assert_close(card_t, cpu_t, **tol)
        dmax[name] = max(dmax.get(name, 0.0),
                         float((card_t - cpu_t).abs().max()))

    try:
        lc, cc = serve_model.prefill(params_d, {"tokens": tokens.to(dev)},
                                     cfg, 128, policy)
        lp, cp = serve_model.prefill(params, {"tokens": tokens}, cfg, 128,
                                     policy)
        close("prefill_logits", lc, lp)
        for k in ("state", "conv"):
            close(f"prefill_{k}", cc["blocks"][0][k], cp["blocks"][0][k])
        tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
        for _ in range(2):
            cpu_cache = tree_to(cc, "cpu")
            lc, cc = serve_model.decode_step(params_d, cc, tok, cfg, policy)
            lp, cp = serve_model.decode_step(params, cpu_cache, tok.cpu(),
                                             cfg, policy)
            close("decode_logits", lc, lp)
            for k in ("state", "conv"):
                close(f"decode_{k}", cc["blocks"][0][k], cp["blocks"][0][k])
            tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    phase(f"phase 16b mamba2 smoke card vs CPU (float32, TF32 off, "
          f"paper_edge_p8): a 64-token prompt in two chunks, then two "
          f"decode steps from the card's state: logits, SSD state and conv "
          f"state within rtol 1e-3 atol 1e-3 (max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in dmax.items()) + ")")
    return {"max_abs_diff": dmax, "prompt_tokens": 64,
            "chunk": cfg.ssm_chunk}


def tree_to(tree, device):
    """A copy of every tensor leaf of ``tree`` on ``device``."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree


def phase16c(dev, seed) -> dict:
    """16c. What the port refuses on the card, as the reference cannot do
    it: a CUDA SSM engine builds under a posit8 KV policy (the KV kernels'
    contracts do not apply to a stack with no attention block), the paged
    layout is refused at construction (``ValueError``), so is a
    ``SpeculativeEngine`` (``ValueError``: verify needs an attention-only
    stack), and a 40-token smoke prompt (not a multiple of the 32-token
    chunk) raises the chunked scan's ``AssertionError``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serve.speculative import SpeculativeEngine
    cfg = get_config(SSM_ARCH, smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 162), device=dev)
    scfg = ServeConfig(max_batch=2, max_len=64, kv_format="posit8")
    eng = ServingEngine(cfg, params, scfg, policy="paper_edge_p8",
                        device=dev)
    refused = {}
    for name, build in (
            ("paged", lambda: ServingEngine(
                cfg, params, dataclasses.replace(scfg, kv_layout="paged",
                                                 page_size=8),
                policy="paper_edge_p8", device=dev)),
            ("speculative", lambda: SpeculativeEngine(
                cfg, params, scfg, policy="paper_edge_p8", device=dev))):
        try:
            build()
        except ValueError as e:
            refused[name] = str(e)[:120]
        else:
            raise AssertionError(f"{name}: a {SSM_ARCH} engine was built")
    prompt = np.random.default_rng([seed, 162]).integers(0, cfg.vocab, 40)
    try:
        eng.serve([Request(uid=0, prompt=prompt, max_new=2)])
    except AssertionError as e:
        refused["prompt_40"] = f"AssertionError {e}"
    else:
        raise AssertionError("a 40-token prompt was prefilled")
    phase(f"phase 16c refusals on the card: a CUDA {SSM_ARCH} smoke engine "
          f"builds under posit8 KV; refused: "
          + "; ".join(f"{k}: {v}" for k, v in refused.items()))
    return {"cuda_engine_builds": True, "refused": refused}


HYBRID_ARCH = "recurrentgemma-9b"
# eight prompts, four longer than the 2048-row window: their prefills wrap
# the ring (K3 from row S - W) and their decode steps read full rings
HYBRID_PROMPT_LENS = (182, 640, 1200, 1900, 2300, 2800, 3200, 3500)
HYBRID_MAX_LEN = 4096
HYBRID_KERNELS = ("kv_append_rows", "decode_attention")
# 12 layers x 8 slots x 2048 rows x 2 x (256 codes + 4 scale bytes), half
# of a 4096-row ring; 26 layers x 8 x (4096 x 4 + 3 x 4096 x 2)
HYBRID_KV_BYTES = 102_236_160
HYBRID_STATE_BYTES = 8_519_680


def rec_state_bytes(cache, cfg) -> int:
    """Bytes of a hybrid cache's recurrent blocks (``h`` and ``conv``)."""
    blocks = [b for t, b in zip(cfg.period, cache["blocks"]) if t == "rec"]
    blocks += [b for t, b in zip(cfg.tail_types, cache.get("tail", ()))
               if t == "rec"]
    return tensor_bytes(blocks)


def phase17a(dev, seed, card: str) -> dict:
    """17a. ``recurrentgemma-9b`` at full width and depth (38 layers: 12
    periods of (rec, rec, local attn) and 2 recurrent tail blocks, d 4096,
    16 heads of 256 over 1 KV head, bf16 seeded weights, the published
    config uncut), ``paper_edge_p8`` (posit8 attention and MLP weights
    hoisted; the recurrent projections unhooked, as the reference serves
    them; posit8 KV), ring, max batch 8, max_len 4096 (2048-row rings):
    eight prompts of ``HYBRID_PROMPT_LENS`` tokens, 32 new tokens each,
    one exact-length prefill per prompt.  Asserts every request finishes
    with its 32 tokens and no error, every prefill and decode logit is
    finite, the KV cache is 12 layers x 8 slots x 2048 rows x 2 x (256
    codes + 4 scale bytes) = 102,236,160 B, the recurrent state 26 layers
    x 8 x (4096 x 4 + 3 x 4096 x 2) = 8,519,680 B, and K3 launches 12
    times per decode step and per prefill, K4 12 times per decode step,
    K1, K2, K5, K6 and K7 never (the wrappers' counts over the served run
    and over a profiled window of 5 engine steps with 8 slots live, and
    the profiler's kernel names).  Prints the decode step's wall, device
    busy, idle share and launches, device ms by op, prefill ms per
    prompt, tok/s and peak memory building and serving, each line with
    ``card``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    cfg = get_config(HYBRID_ARCH)
    n_attn = cfg.block_types.count("attn")
    w = min(cfg.window, HYBRID_MAX_LEN)
    rng17 = np.random.default_rng([seed, 17])
    prompts = [rng17.integers(0, cfg.vocab, n) for n in HYBRID_PROMPT_LENS]
    warm = rng17.integers(0, cfg.vocab, 64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    params = lm.init_params(cfg, gen, device=dev)
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=B, max_len=HYBRID_MAX_LEN, kv_format="posit8"),
        policy="paper_edge_p8", device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    nonfinite, prefill_ms = [], []
    generate, prefill = eng.engine.generate, eng.engine.prefill

    def generate_checked(params_, state):
        state, logits = generate(params_, state)
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append("generate")
        return state, logits

    def prefill_checked(params_, tokens, lengths=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefix = prefill(params_, tokens, lengths)
        if not bool(torch.isfinite(prefix["logits"]).all()):
            nonfinite.append("prefill")
        prefill_ms.append((int(tokens.shape[1]),
                           1e3 * (time.perf_counter() - t0)))
        return prefix

    eng.engine.generate, eng.engine.prefill = generate_checked, \
        prefill_checked
    eng.serve([Request(uid=-1, prompt=warm, max_new=3)])     # warm-up
    torch.cuda.synchronize()
    peak_build = torch.cuda.max_memory_allocated()
    w_bytes = tensor_bytes(eng.params)
    kv_bytes = eng.kv_cache_bytes()
    state_bytes = rec_state_bytes(eng.cache, cfg)
    assert kv_bytes == HYBRID_KV_BYTES == n_attn * B * w * 2 * (
        cfg.n_kv_heads * (cfg.head_dim + 4)), kv_bytes
    assert state_bytes == HYBRID_STATE_BYTES == (
        cfg.block_types.count("rec") * B * cfg.d_model
        * (4 + (cfg.conv_kernel - 1) * 2)), state_bytes
    torch.cuda.reset_peak_memory_stats()
    reqs = [Request(uid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts)]
    prefill_ms.clear()
    eng.tracer.reset()
    eng.tracer.enable()
    steps0, pre0 = eng.stats["decode_steps"], eng.stats["prefills"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    eng.tracer.disable()
    st = eng.tracer.self_times()
    steps = eng.stats["decode_steps"] - steps0
    prefills = eng.stats["prefills"] - pre0
    assert not nonfinite, nonfinite
    assert all(r.done and r.error is None and len(r.out_tokens) == 32
               for r in reqs)
    assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
    assert prefills == len(prompts), prefills      # one per prompt
    want = {k: 0 for k in launches}
    want.update(kv_append_rows=n_attn * (steps + prefills),
                decode_attention=n_attn * steps)
    assert launches == want, launches
    served_prefill_ms = list(prefill_ms)

    def stage_ms(stage):
        n = st[f"{stage}.device"]["count"]
        return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                      + st[f"{stage}.device"]["total_s"]) / n

    # a profiled window: the 8 prompts readmitted (one exact-length
    # prefill each), then n_prof engine steps with 8 slots live
    n_prof = 5
    eng._admit([Request(uid=100 + i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)])
    assert all(r is not None for r in eng.slot_req)
    # the window's least bytes: every weight once, the rows each slot's
    # K4 reads (min(pos + 1, W) per slot and layer, codes + scales, K and
    # V), the row K3 writes, the recurrent state read and written
    pos = eng.cache["pos"].long()
    rows_read = int(torch.clamp(pos + 1 + n_prof // 2, max=w).sum())
    kv_row = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    bound_ms = 1e3 * (w_bytes + n_attn * (rows_read + B) * kv_row
                      + 2 * state_bytes) / H100_BYTES_PER_S
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    per_step = {k: v / n_prof for k, v in LAUNCHES.items()}
    assert per_step == {k: (n_attn if k in HYBRID_KERNELS else 0)
                        for k in per_step}, per_step
    assert not nonfinite, nonfinite
    n_kernels = {}
    per_kernel = {k: v / n_prof / 1e3
                  for k, v in device_events(prof, n_kernels).items()}
    traced = {k: n_kernels.get(k, 0) / n_prof for k in PORT_KERNEL_NAMES}
    if per_kernel and all(traced[k] for k in ("append_kernel",
                                              "split_kernel",
                                              "combine_kernel")):
        assert traced == {k: (n_attn if k in ("append_kernel",
                                              "split_kernel",
                                              "combine_kernel") else 0)
                          for k in traced}, traced
    busy = sum(per_kernel.values()) if per_kernel else None
    top = sorted(per_kernel.items(), key=lambda kv_: -kv_[1])[:6]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_ops:
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
    ops = op_device_ms(prof_ops, 2)
    peak = torch.cuda.max_memory_allocated()
    # what one decode step and one prefill of the longest prompt hold
    # above the engine's resident bytes (weights, caches)
    transient = {}
    for label, fn in (("decode_step", eng.step), ("prefill_3500", lambda: (
            eng.engine.prefill(eng.params, torch.from_numpy(
                prompts[-1][None]).to(dev)), None)[1])):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        transient[label] = torch.cuda.max_memory_allocated() - base
    eng.serve([])                                       # drain
    out = {
        "card": card, "arch": HYBRID_ARCH, "params": cfg.param_count(),
        "prompt_lens": list(HYBRID_PROMPT_LENS), "window": w,
        "max_len": HYBRID_MAX_LEN, "steps": steps, "prefills": prefills,
        "serve_wall_s": wall, "tok_s": 8 * 32 / wall,
        "build_s": build_s, "prefill_ms": stage_ms("prefill"),
        "prefill_ms_by_len": served_prefill_ms,
        "decode_ms": stage_ms("generate"), "launches": launches,
        "launches_per_decode_step": {k: per_step[k] for k in
                                     HYBRID_KERNELS},
        "weight_bytes": w_bytes, "kv_cache_bytes": kv_bytes,
        "rec_state_bytes": state_bytes,
        "bound_ms": bound_ms, "bound_by": "bytes",
        "profiled": {
            "step_wall_ms": step_ms, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / step_ms,
            "kernel_launches_per_step":
                sum(n_kernels.values()) / n_prof if per_kernel else None,
            "traced_port_kernels_per_step": traced,
            "top_kernels_ms": dict(top), "top_ops_ms": ops},
        "peak_memory_bytes": peak, "peak_memory_build_bytes": peak_build,
        "transient_bytes": transient}
    device = (f"device busy {busy:.3f} ms/step (bytes bound {bound_ms:.3f} "
              f"ms: weights, the K/V rows read and written, the recurrent "
              f"state), idle share {1 - busy / step_ms:.3f}; kernel launches "
              f"{sum(n_kernels.values()) / n_prof:.1f}/step; traced port "
              f"kernels per step { {k: v for k, v in traced.items() if v} }; "
              f"top kernels (ms/step): "
              + ", ".join(f"{k} {v:.3f}" for k, v in top)
              + "; top ops by self device ms/step: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ops.items())
              if per_kernel else "device busy and idle share not measured "
              "(the profiler trace held no device events)")
    phase(f"phase 17a [{card}] {HYBRID_ARCH}: {cfg.n_layers}L "
          f"d{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads}h hd{cfg.head_dim} "
          f"window {cfg.window} pattern {cfg.period} + {cfg.n_tail} tail, "
          f"d_ff {cfg.d_ff} vocab {cfg.vocab} ({cfg.param_count()} params, "
          f"bf16, posit8 attn/MLP weights and KV), ring W {w}, 8 prompts "
          f"of {list(HYBRID_PROMPT_LENS)} tokens, 32 new each: {prefills} "
          f"exact-length prefills {stage_ms('prefill'):.2f} ms/prompt "
          f"(by length: "
          + ", ".join(f"{n}: {ms:.1f}" for n, ms in served_prefill_ms)
          + f" ms), {steps} decode steps {stage_ms('generate'):.3f} "
          f"ms/step, {8 * 32 / wall:.1f} tok/s; every logit finite; "
          f"launches {launches}; profiled engine step (8 slots live): wall "
          f"{step_ms:.3f} ms/step, wrapper launches/step "
          f"{ {k: per_step[k] for k in HYBRID_KERNELS} }, {device}; "
          f"weights {w_bytes} B, KV cache {kv_bytes} B, recurrent state "
          f"{state_bytes} B; built in {build_s:.1f} s; peak memory {peak} B "
          f"serving ({peak_build} B building the engine: init + hoisting, "
          f"then a warm-up); above the resident bytes, one decode step "
          f"holds {transient['decode_step']} B, a 3,500-token prefill "
          f"{transient['prefill_3500']} B")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase17b(dev, seed) -> dict:
    """17b. K3 and K4 alone at the hybrid's shapes (B 8, W 2048, 1 KV
    head of 256, 16 query heads), each against its plain version:
    posit16 (512-B code rows), posit8 and packed posit4.  K3 bit-exact
    from f32 and from bf16 rows (on the same values as f32), at T = 1 on
    positions that cross the ring's end (rows not written unchanged) and
    at T = W from ``S - W`` for prompts longer than the window (a prefill's
    call, wrapping inside it); K4 within rtol 1e-5, atol 1e-5 at
    ``cache_len`` = W and below it, and with a bf16 q within 2^-7 of the
    plain version on the same q.  Times both (posit8 and posit16, CUDA
    graph replays over 12 layers' rings, past the L2) beside their bytes
    bounds."""
    import torch
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import _build
    from repro_torch.kernels import kv_cache as kvk
    hb, hw, hkv, hhd, hnh = B, 2048, 1, 256, 16
    rng17 = np.random.default_rng([seed, 171])

    def ring(fmt, packed):
        dc = kvk.code_channels(hhd, fmt, packed)
        hi = 1 << (8 if fmt.bits <= 8 else 16)
        codes = torch.from_numpy(rng17.integers(0, hi, (hb, hw, hkv, dc))
                                 ).to(dev)
        if fmt.bits > 8:
            codes = torch.where(codes >= 1 << 15, codes - (1 << 16), codes)
        scales = torch.from_numpy(np.exp2(rng17.integers(
            -8, 8, (hb, hw, hkv))).astype(np.float32)).to(dev)
        return codes.to(_build.code_dtype(fmt)), scales

    def rows(t, spread=6):
        mag = np.exp2(rng17.uniform(-spread, spread, (hb, t, hkv, 1)))
        return torch.from_numpy((rng17.normal(0, 1, (hb, t, hkv, hhd)) * mag)
                                .astype(np.float32)).to(dev)

    # T = 1 across the ring's end; T = W from S - W (S = 2049 .. 3500)
    pos_end = torch.tensor([2047, 2048, 4095, 4096, 0, 1, 6143, 2046],
                           dtype=torch.int32, device=dev)
    lens = torch.tensor([2049, 2100, 2500, 3000, 3500, 2048 + 1023,
                         2048 + 2047, 4096], dtype=torch.int32, device=dev)
    pos_pf = lens - hw
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        for t, pos in ((1, pos_end), (hw, pos_pf)):
            kc, ks = ring(fmt, packed)
            vc, vs = ring(fmt, packed)
            kn, vn = rows(t), rows(t)
            kv = torch.cat([kn, vn], dim=-1).to(torch.bfloat16)
            for k_in, v_in in ((kn, vn), (kv[..., :hhd].contiguous(),
                                          kv[..., hhd:])):
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
                if t == 1:
                    keep = torch.ones((hb, hw), dtype=torch.bool,
                                      device=dev)
                    keep[torch.arange(hb, device=dev),
                         pos_end.long() % hw] = False
                    for g, orig in zip(got, (kc, ks, vc, vs)):
                        assert torch.equal(g[keep], orig[keep]), name
    errs = {}
    cls = (torch.full((hb,), hw, dtype=torch.int32, device=dev),
           torch.tensor([hw, 1, 127, 128, 129, 1000, 2047, hw],
                        dtype=torch.int32, device=dev))
    for name, packed in KV_FORMATS:
        fmt = get_fmt(name)
        kc, ks = ring(fmt, packed)
        vc, vs = ring(fmt, packed)
        kvk.kv_append_rows_ref(kc, ks, vc, vs, rows(hw, 2), rows(hw, 2),
                               torch.zeros(hb, dtype=torch.int32, device=dev),
                               fmt, packed)
        q = torch.from_numpy(rng17.normal(0, 1, (hb, 1, hnh, hhd)).astype(
            np.float32)).to(dev)
        e, eb = 0.0, 0.0
        for cl in cls:
            got = kvk.decode_attention(q, kc, ks, vc, vs, cl, fmt,
                                       packed=packed)
            want = kvk.decode_attention_ref(q, kc, ks, vc, vs, cl, fmt,
                                            packed)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
            e = max(e, float((got - want).abs().max()))
            qb = q.to(torch.bfloat16)
            got = kvk.decode_attention(qb, kc, ks, vc, vs, cl, fmt,
                                       packed=packed)
            want = kvk.decode_attention_ref(qb, kc, ks, vc, vs, cl, fmt,
                                            packed)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=2 ** -7, atol=2 ** -7)
            eb = max(eb, float((got.float() - want.float()).abs().max()))
        errs[name] = {"f32_q": e, "bf16_q": eb}
    # times at the decode step's shapes: 12 layers' rings (posit8: 8 MB of
    # K + V codes each, past the 50 MB L2 together), bf16 rows and q
    n_l = 12
    times = {}
    for name in ("posit8_2", "posit16_2"):
        fmt = get_fmt(name)
        code_b = 1 if fmt.bits <= 8 else 2
        rings = [ring(fmt, False) + ring(fmt, False) for _ in range(n_l)]
        k1 = rows(1).to(torch.bfloat16)
        v1 = rows(1).to(torch.bfloat16)
        qb = torch.from_numpy(rng17.normal(0, 1, (hb, 1, hnh, hhd)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        k3_us = 1e3 * graph_ms(lambda i: kvk.kv_append_rows(
            rings[i][0], rings[i][1], rings[i][2], rings[i][3], k1, v1,
            pos_end, fmt), n_l)
        k4_us = 1e3 * graph_ms(lambda i: kvk.decode_attention(
            qb, rings[i][0], rings[i][1], rings[i][2], rings[i][3], cls[0],
            fmt), n_l)
        # K3: bf16 rows read, codes + scales written, pos read; K4: every
        # live row's codes and scales (K and V) read, q read, out written
        k3_bound = 1e6 * (2 * hb * hkv * (hhd * 2 + hhd * code_b + 4)
                          + hb * 4) / H100_BYTES_PER_S
        live = int(cls[0].sum())
        k4_bound = 1e6 * (2 * live * hkv * (hhd * code_b + 4)
                          + 2 * hb * hnh * hhd * 2 + hb * 4) \
            / H100_BYTES_PER_S
        times[name] = {"k3_us": k3_us, "k3_bound_us": k3_bound,
                       "k4_us": k4_us, "k4_bound_us": k4_bound}
        del rings
    phase(f"phase 17b K3 and K4 at the hybrid's shapes (B {hb}, W {hw}, "
          f"{hkv} KV head of {hhd}, {hnh} query heads; posit16 512-B rows, "
          f"posit8, packed posit4): K3 bit-exact from f32 and bf16 rows at "
          f"T=1 across the ring's end {pos_end.tolist()} and at T={hw} "
          f"from S - W for S {lens.tolist()}; K4 at cache_len {hw} and "
          f"{cls[1].tolist()} max |err| "
          + ", ".join(f"{k} {v['f32_q']:.2e} (bf16 q {v['bf16_q']:.2e})"
                      for k, v in errs.items())
          + " (rtol/atol 1e-5; bf16 q 2^-7); device µs per call: "
          + "; ".join(f"{k}: K3 {v['k3_us']:.2f} (bound "
                      f"{v['k3_bound_us']:.3f}), K4 {v['k4_us']:.2f} (bound "
                      f"{v['k4_bound_us']:.3f})" for k, v in times.items()))
    return {"max_abs_err": errs, "times": times,
            "k4_split_smem_bytes": 4 * (256 + hnh * hhd
                                        + hnh * kvk.SPLIT_ROWS
                                        + kvk.SPLIT_ROWS * (hhd + 4))}


def posit8_flips(a, b) -> tuple:
    """Posit8 codes two devices wrote for one set of K/V values: each code
    that differs is its counterpart's neighbour in posit order or, near
    zero, decodes within 2^-12 (of the row's scale) of it.  Returns
    (differ, near zero)."""
    import torch
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels.posit_decode import decode_tile

    def signed(c):
        c = c.to(torch.int16)
        return torch.where(c >= 128, c - 256, c)

    sa, sb = signed(a), signed(b)
    far = (sa - sb).abs() > 1
    fmt = get_fmt("posit8_2")
    gap = (decode_tile(a[far], fmt) - decode_tile(b[far], fmt)).abs()
    assert bool((gap <= 2.0 ** -12).all()), float(gap.max())
    return int((sa != sb).sum()), int(far.sum())


def phase17c(dev, seed) -> dict:
    """17c. Card vs CPU at float32 (TF32 off) on the recurrentgemma smoke
    config (a 16-token window), ``paper_edge_p8`` per-call weight hook,
    posit8 KV ring: a 40-token prompt and a 12-token one (the first wraps
    the ring) prefilled on both devices: logits, ``h`` and ``conv``
    within rtol 1e-3, atol 1e-3, ring scales equal and codes by
    ``posit8_flips`` on < 0.1 % of them; then 6 decode steps (the second
    prompt's ring wraps), each from the card's state on both devices, held
    the same way."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm, serve_model
    cfg = dataclasses.replace(get_config(HYBRID_ARCH, smoke=True),
                              dtype_name="float32")
    policy = get_policy("paper_edge_p8")
    params = lm.init_params(cfg, torch.Generator().manual_seed(seed + 17),
                            device="cpu")
    params_d = tree_to(params, dev)
    rng = np.random.default_rng([seed, 172])
    tol = dict(rtol=1e-3, atol=1e-3)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    dmax, flips = {}, [0, 0, 0]

    def parts(cache):
        out = {}
        for part in ("blocks", "tail"):
            for i, blk in enumerate(cache.get(part, ())):
                out.update({f"{part}{i}.{k}": v for k, v in blk.items()})
        return out

    def close(label, card_c, cpu_c, card_l, cpu_l):
        card_l = card_l.cpu()
        torch.testing.assert_close(card_l, cpu_l, **tol)
        dmax[label + "_logits"] = max(dmax.get(label + "_logits", 0.0),
                                      float((card_l - cpu_l).abs().max()))
        cc, cp = parts(card_c), parts(cpu_c)
        for k, v in cc.items():
            v, p = v.cpu(), cp[k]
            if k.endswith(("scale",)):
                assert torch.equal(v, p), (label, k)
            elif k.endswith((".k", ".v")):
                n, far = posit8_flips(v, p)
                flips[0] += n
                flips[1] += far
                flips[2] += v.numel()
            else:
                torch.testing.assert_close(v, p, **tol)
                key = f"{label}_{k.split('.')[-1]}"
                dmax[key] = max(dmax.get(key, 0.0),
                                float((v - p).abs().max()))

    try:
        for s in (40, 12):
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, s)))
            lc, cc = serve_model.prefill(params_d, {"tokens": tokens.to(
                dev)}, cfg, 64, policy)
            lp, cp = serve_model.prefill(params, {"tokens": tokens}, cfg, 64,
                                         policy)
            close("prefill", cc, cp, lc, lp)
            tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
            for _ in range(6):
                cpu_cache = tree_to(cc, "cpu")
                lc, cc = serve_model.decode_step(params_d, cc, tok, cfg,
                                                 policy)
                lp, cp = serve_model.decode_step(params, cpu_cache,
                                                 tok.cpu(), cfg, policy)
                close("decode", cc, cp, lc, lp)
                tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
            assert int(cc["pos"]) > cfg.window
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert flips[0] < 1e-3 * flips[2], flips
    phase(f"phase 17c recurrentgemma smoke card vs CPU (float32, TF32 off, "
          f"paper_edge_p8, posit8 KV, window {cfg.window}): prompts of 40 "
          f"and 12 tokens, then 6 decode steps each from the card's state "
          f"(both rings wrap): logits, h and conv within rtol 1e-3 atol "
          f"1e-3 (max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in dmax.items())
          + f"); ring scales equal, {flips[0]} of {flips[2]} codes differ "
          f"({flips[1]} near zero, the rest one posit step)")
    return {"max_abs_diff": dmax, "codes_differ": flips[0],
            "codes_near_zero": flips[1], "codes_compared": flips[2]}


def phase17d(dev, seed) -> dict:
    """17d. What the port refuses on the card, as the reference does: a
    CUDA recurrentgemma smoke engine builds under posit8 KV and serves;
    the paged layout is refused at construction (``ValueError``: a sliding
    window), so is a ``SpeculativeEngine`` (``ValueError``: verify needs
    an attention-only stack), and a bucketed (``true_len``) prefill
    (``ValueError``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm, serve_model
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serve.speculative import SpeculativeEngine
    cfg = get_config(HYBRID_ARCH, smoke=True)
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 173), device=dev)
    scfg = ServeConfig(max_batch=2, max_len=64, kv_format="posit8")
    eng = ServingEngine(cfg, params, scfg, policy="paper_edge_p8",
                        device=dev)
    prompt = np.random.default_rng([seed, 173]).integers(0, cfg.vocab, 30)
    req = Request(uid=0, prompt=prompt, max_new=4)
    eng.serve([req])
    assert req.done and req.error is None and len(req.out_tokens) == 4
    refused = {}
    tokens = torch.as_tensor(np.stack([prompt[:16], prompt[:16]])).to(dev)
    for name, build in (
            ("paged", lambda: ServingEngine(
                cfg, params, dataclasses.replace(scfg, kv_layout="paged",
                                                 page_size=8),
                policy="paper_edge_p8", device=dev)),
            ("speculative", lambda: SpeculativeEngine(
                cfg, params, scfg, policy="paper_edge_p8", device=dev)),
            ("true_len", lambda: serve_model.prefill(
                params, {"tokens": tokens}, cfg, 64,
                get_policy("paper_edge_p8"), true_len=[9, 16]))):
        try:
            build()
        except ValueError as e:
            refused[name] = str(e)[:120]
        else:
            raise AssertionError(f"{name}: {HYBRID_ARCH} was not refused")
    phase(f"phase 17d refusals on the card: a CUDA {HYBRID_ARCH} smoke "
          f"engine builds under posit8 KV and serves; refused: "
          + "; ".join(f"{k}: {v}" for k, v in refused.items()))
    return {"cuda_engine_serves": True, "refused": refused}


VLM_ARCH = "qwen2-vl-2b"
AUDIO_ARCH = "whisper-large-v3"
KV_KERNELS = ("kv_append_rows", "decode_attention", "paged_kv_append_rows",
              "paged_decode_attention")
# 28 layers x 8 slots x 1024 rows x 2 KV heads x 2 x (128 codes + 4 scale
# bytes)
VLM_KV_BYTES = 121_110_528
# Whisper's decoder context, and its start-of-transcript prompt in
# large-v3's vocabulary (<|startoftranscript|> <|en|> <|transcribe|>
# <|notimestamps|>)
AUDIO_MAX_LEN = 448
AUDIO_PROMPT = (50258, 50259, 50360, 50364)
# self K/V: 32 layers x 8 x 448 rows x 20 heads x 2 x (64 codes + 4 scale
# bytes); cross K/V: 32 x 8 x 1500 x 20 x 64 bf16, xk and xv; memory: 8 x
# 1500 x 1280 bf16
AUDIO_KV_BYTES = 311_951_360
AUDIO_CROSS_BYTES = 1_966_080_000
AUDIO_MEMORY_BYTES = 30_720_000


def checked_stages(eng, nonfinite: list) -> None:
    """Wrap an engine's ``generate`` and ``prefill`` stages so every
    logit they return is checked finite (a failure is listed in
    ``nonfinite``)."""
    import torch
    generate, prefill = eng.engine.generate, eng.engine.prefill

    def generate_checked(params_, state):
        state, logits = generate(params_, state)
        if not bool(torch.isfinite(logits).all()):
            nonfinite.append("generate")
        return state, logits

    def prefill_checked(params_, tokens, lengths=None):
        prefix = prefill(params_, tokens, lengths)
        if not bool(torch.isfinite(prefix["logits"]).all()):
            nonfinite.append("prefill")
        return prefix

    eng.engine.generate, eng.engine.prefill = generate_checked, \
        prefill_checked


def profiled_steps(step, n: int, n_l: int, kernels) -> dict:
    """``n`` calls of ``step`` (engine steps or decode steps, 8 slots
    live) under the profiler: the wall per step, the wrappers' launches
    per step (each of ``kernels`` asserted at ``n_l``, the rest of K1-K7
    at 0), the traced port kernels per step (asserted too where the trace
    holds all three KV kernel names), device busy and idle share, and two
    more steps traced with the host's ops for device ms by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES, reset_launches
    torch.cuda.synchronize()
    reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / n
    per_step = {k: v / n for k, v in LAUNCHES.items()}
    assert per_step == {k: (n_l if k in kernels else 0)
                        for k in per_step}, per_step
    n_kernels = {}
    per_kernel = {k: v / n / 1e3
                  for k, v in device_events(prof, n_kernels).items()}
    traced = {k: n_kernels.get(k, 0) / n for k in PORT_KERNEL_NAMES}
    kv_names = ("append_kernel", "split_kernel", "combine_kernel")
    if per_kernel and all(traced[k] for k in kv_names):
        assert traced == {k: (n_l if k in kv_names else 0)
                          for k in traced}, traced
    busy = sum(per_kernel.values()) if per_kernel else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_ops:
        for _ in range(2):
            step()
        torch.cuda.synchronize()
    return {"step_wall_ms": step_ms,
            "wrapper_launches_per_step": {k: per_step[k] for k in kernels},
            "traced_port_kernels_per_step": traced,
            "device_busy_ms": busy,
            "idle_share": None if busy is None else 1 - busy / step_ms,
            "kernel_launches_per_step":
                sum(n_kernels.values()) / n if per_kernel else None,
            "top_kernels_ms": dict(sorted(per_kernel.items(),
                                          key=lambda kv_: -kv_[1])[:6]),
            "top_ops_ms": op_device_ms(prof_ops, 2)}


def device_line(p: dict, bound_ms: float) -> str:
    """A profiled window's device numbers, for a phase line."""
    if p["device_busy_ms"] is None:
        return ("device busy and idle share not measured (the profiler "
                "trace held no device events)")
    return (f"device busy {p['device_busy_ms']:.3f} ms/step (bytes bound "
            f"{bound_ms:.3f} ms), idle share {p['idle_share']:.3f}; kernel "
            f"launches {p['kernel_launches_per_step']:.1f}/step; traced port "
            f"kernels per step "
            f"{ {k: v for k, v in p['traced_port_kernels_per_step'].items() if v} }"
            f"; top kernels (ms/step): "
            + ", ".join(f"{k} {v:.3f}" for k, v in p["top_kernels_ms"].items())
            + "; top ops by self device ms/step: "
            + ", ".join(f"{k} {v:.3f}" for k, v in p["top_ops_ms"].items()))


def phase18a(dev, seed, prompts, warm, card: str) -> dict:
    """18a. ``qwen2-vl-2b`` at full width and depth (28 layers, d 1536, 12
    query heads of 128 over 2 KV heads, M-RoPE, tied 151,936-row table,
    1,543,853,568 params, bf16 seeded weights, the published config
    uncut), ``paper_edge_p8`` (posit8 attention and MLP weights hoisted,
    posit8 KV), max batch 8, max_len 1024: phase 6's eight prompts, 32 new
    tokens each, one exact-length prefill per prompt (the reference does
    not bucket vlm), through ``ServingEngine.serve`` in the ring and then
    the paged layout, each with a profiled window of 5 engine steps with 8
    slots live; then the ``SpeculativeEngine`` (ring, gamma 2) over four of
    the prompts; then one ``prefill`` over seeded patch embeddings (8, 256,
    1536), the stub frontend's, and 16 greedy ``decode_step`` calls.
    Asserts every request finishes with its 32 tokens and no error, every
    logit finite, ring KV bytes 121,110,528, and by the wrappers' counts
    (and the profiler's names where its trace holds them) K3 + K4 28 per
    ring decode step and K3 28 per prefill, K5 + K6 28 per paged decode
    step, K1 56 per speculative round, K2 and K7 never."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm, serve_model
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serve.speculative import SpeculativeEngine
    cfg = get_config(VLM_ARCH)
    n_l = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 18), device=dev)
    torch.cuda.synchronize()
    out = {"card": card, "arch": VLM_ARCH, "params": cfg.param_count(),
           "init_s": time.perf_counter() - t_build}
    nonfinite = []
    kv_row = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)   # K and V, one row
    for layout, kw in (("ring", {}),
                       ("paged", {"kv_layout": "paged", "page_size": PS})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=B, max_len=W, kv_format="posit8", **kw),
            policy="paper_edge_p8", device=dev)
        assert not eng.engine.bucketed
        checked_stages(eng, nonfinite)
        eng.serve([Request(uid=-1, prompt=warm, max_new=3)])   # warm-up
        peak_build = torch.cuda.max_memory_allocated()
        w_bytes = tensor_bytes(eng.params)
        if layout == "ring":
            assert eng.kv_cache_bytes() == VLM_KV_BYTES == n_l * B * W \
                * kv_row, eng.kv_cache_bytes()
        torch.cuda.reset_peak_memory_stats()
        reqs = [Request(uid=i, prompt=p, max_new=32)
                for i, p in enumerate(prompts)]
        eng.tracer.reset()
        eng.tracer.enable()
        steps0, pre0 = eng.stats["decode_steps"], eng.stats["prefills"]
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        eng.tracer.disable()
        st = eng.tracer.self_times()
        steps = eng.stats["decode_steps"] - steps0
        prefills = eng.stats["prefills"] - pre0
        assert not nonfinite, nonfinite
        assert all(r.done and r.error is None and len(r.out_tokens) == 32
                   for r in reqs), layout
        assert all(0 <= t < cfg.vocab for r in reqs for t in r.out_tokens)
        assert prefills == len(prompts), prefills     # one per prompt
        want = {k: 0 for k in launches}
        if layout == "ring":
            want.update(kv_append_rows=n_l * (steps + prefills),
                        decode_attention=n_l * steps)
            kernels = ("kv_append_rows", "decode_attention")
        else:
            want.update(kv_append_rows=n_l * prefills,
                        paged_kv_append_rows=n_l * steps,
                        paged_decode_attention=n_l * steps)
            kernels = ("paged_kv_append_rows", "paged_decode_attention")
            eng.allocator.assert_consistent()
            assert eng.allocator.live_pages == 0
        assert launches == want, (layout, launches)

        def stage_ms(stage):
            n = st[f"{stage}.device"]["count"]
            return 1e3 * (st[f"{stage}.dispatch"]["total_s"]
                          + st[f"{stage}.device"]["total_s"]) / n

        # a profiled window: the 8 prompts readmitted, then 5 engine steps
        # with 8 slots live; its least bytes: every weight once (the tied
        # table included: the head reads it whole), the rows each slot's
        # K4 / K6 reads and the row K3 / K5 writes
        eng._admit([Request(uid=100 + i, prompt=p, max_new=32)
                    for i, p in enumerate(prompts)])
        assert all(r is not None for r in eng.slot_req), layout
        rows_read = int(sum(min(len(p) + 3, W) for p in prompts))
        bound_ms = 1e3 * (w_bytes + n_l * (rows_read + B) * kv_row) \
            / H100_BYTES_PER_S
        prof = profiled_steps(eng.step, 5, n_l, kernels)
        assert not nonfinite, nonfinite
        eng.serve([])                                   # drain
        peak = torch.cuda.max_memory_allocated()
        out[layout] = {
            "steps": steps, "prefills": prefills, "serve_wall_s": wall,
            "tok_s": 8 * 32 / wall, "prefill_ms": stage_ms("prefill"),
            "decode_ms": stage_ms("generate"), "launches": launches,
            "kv_cache_bytes": eng.kv_cache_bytes(), "weight_bytes": w_bytes,
            "bound_ms": bound_ms, "bound_by": "bytes", "profiled": prof,
            "peak_memory_bytes": peak, "peak_memory_build_bytes": peak_build}
        phase(f"phase 18a [{card}] {VLM_ARCH} {layout}: {n_l}L "
              f"d{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads}h "
              f"hd{cfg.head_dim} M-RoPE d_ff {cfg.d_ff} vocab {cfg.vocab} "
              f"tied ({cfg.param_count()} params, bf16, posit8 attn/MLP "
              f"weights and KV), 8 prompts of "
              f"{sorted(len(p) for p in prompts)} tokens, 32 new each: "
              f"{prefills} exact-length prefills {stage_ms('prefill'):.2f} "
              f"ms/prompt, {steps} decode steps {stage_ms('generate'):.3f} "
              f"ms/step, {8 * 32 / wall:.1f} tok/s; every logit finite; "
              f"launches { {k: v for k, v in launches.items() if v} }; KV "
              f"cache {eng.kv_cache_bytes()} B; profiled engine step (8 "
              f"slots live): wall {prof['step_wall_ms']:.3f} ms/step, "
              f"wrapper launches/step {prof['wrapper_launches_per_step']}, "
              f"{device_line(prof, bound_ms)}; weights {w_bytes} B; peak "
              f"memory {peak} B serving ({peak_build} B building the "
              f"engine: hoisting, then a warm-up)")
        del eng

    # the speculative engine, ring, gamma 2, over four prompts
    gc.collect()
    torch.cuda.empty_cache()
    spec = SpeculativeEngine(cfg, params, ServeConfig(
        max_batch=B, max_len=W, kv_format="posit8"), policy="paper_edge_p8",
        gamma=2, device=dev)
    checked_stages(spec, nonfinite)
    spec.serve([Request(uid=-1, prompt=warm, max_new=3)])
    counts = ("spec_rounds", "drafts_proposed", "drafts_accepted", "tokens",
              "prefills", "decode_steps")
    c0 = {k: spec.stats[k] for k in counts}
    reqs = [Request(uid=i, prompt=p, max_new=32)
            for i, p in enumerate(prompts[:4])]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    spec.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n = {k: spec.stats[k] - c0[k] for k in counts}
    assert not nonfinite, nonfinite
    assert all(r.done and r.error is None and len(r.out_tokens) == 32
               for r in reqs)
    assert launches["posit_decode"] == 2 * n_l * n["spec_rounds"], launches
    assert launches["kv_append_rows"] > 0 and launches["decode_attention"] > 0
    assert all(launches[k] == 0 for k in ("posit_encode", "posit_matmul",
                                          "paged_kv_append_rows",
                                          "paged_decode_attention")), launches
    out["speculative_ring_gamma2"] = {
        "prompts": 4, "wall_s": wall, "tok_s": n["tokens"] / wall,
        "acceptance": n["drafts_accepted"] / max(n["drafts_proposed"], 1),
        "counts": n, "launches": launches,
        "posit_decode_per_round": launches["posit_decode"] / n["spec_rounds"]}
    phase(f"phase 18a [{card}] {VLM_ARCH} speculative ring gamma 2, 4 "
          f"prompts x 32: {n['spec_rounds']} rounds, acceptance "
          f"{out['speculative_ring_gamma2']['acceptance']:.4f}, "
          f"{n['tokens'] / wall:.1f} tok/s, K1 "
          f"{launches['posit_decode'] / n['spec_rounds']:.0f} per round; "
          f"launches { {k: v for k, v in launches.items() if v} }")
    del spec

    # a patch-embedding prompt: prefill over (8, 256, d) embeds, then 16
    # greedy decode steps, on the hoisted weights and the ring
    gc.collect()
    torch.cuda.empty_cache()
    policy = dataclasses.replace(get_policy("paper_edge_p8"),
                                 kv_format="posit8")
    hoisted = lm.hoist_weight_quant(params, policy)
    free = lm.weights_free(policy, cfg.tie_embed)
    rng = np.random.default_rng([seed, 18])
    emb = torch.from_numpy(rng.standard_normal((B, 256, cfg.d_model)).astype(
        np.float32)).to(dev)
    serve_model.prefill(hoisted, {"embeds": emb[:, :16]}, cfg, W, free)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = serve_model.prefill(hoisted, {"embeds": emb}, cfg, W,
                                        free)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    finite = [bool(torch.isfinite(logits).all())]
    t0 = time.perf_counter()
    for _ in range(16):
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        logits, cache = serve_model.decode_step(hoisted, cache, tok, cfg,
                                                free)
        finite.append(bool(torch.isfinite(logits).all()))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 16
    launches = dict(LAUNCHES)
    assert all(finite), finite
    want = {k: 0 for k in launches}
    want.update(kv_append_rows=n_l * 17, decode_attention=n_l * 16)
    assert launches == want, launches
    assert int(cache["pos"]) == 256 + 16
    out["embeds"] = {"shape": list(emb.shape), "prefill_ms": prefill_ms,
                     "decode_step_ms": step_ms, "launches": launches}
    phase(f"phase 18a [{card}] {VLM_ARCH} patch-embedding prompt: prefill "
          f"over seeded embeds {tuple(emb.shape)} {prefill_ms:.2f} ms, 16 "
          f"greedy decode steps {step_ms:.3f} ms/step (host clock), every "
          f"logit finite; launches { {k: v for k, v in launches.items() if v} }")
    del params, hoisted, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase18b(dev, seed, card: str) -> dict:
    """18b. ``whisper-large-v3`` at full width and depth (32 encoder and
    32 decoder layers, d 1280, 20 heads of 64, MHA, 1,601,251,840 params,
    bf16 seeded weights, the published config uncut), ``paper_edge_p8``
    (posit8 attention and MLP weights hoisted, the encoder's included; the
    cross weights unhooked, as the reference serves them), posit8 KV
    ring, 8 clips of seeded (1500, 1280) frame embeddings (the stub conv
    frontend's output), each with Whisper's 4-token start-of-transcript
    prompt, max_len 448: one ``prefill``, then 64 greedy ``decode_step``
    calls; then the paged layout for a prefill and 8 steps.  Asserts
    every logit finite; self K/V 311,951,360 B, cross K/V 1,966,080,000
    B, ``memory`` 30,720,000 B; K3 + K4 32 per decode step and K3 32 per
    prefill (K5 + K6 and K5 paged), K1, K2 and K7 never.  Prints the
    encoder's ms, the prefill's, the decode step's wall, device busy and
    idle share, the cross-attention's device ms per step (CUDA graph of
    its 32 layers' calls) beside its bytes bound, tok/s and peak memory."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import attention, lm, serve_model
    cfg = get_config(AUDIO_ARCH)
    n_l = cfg.n_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build = time.perf_counter()
    params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed + 181), device=dev)
    policy = dataclasses.replace(get_policy("paper_edge_p8"),
                                 kv_format="posit8")
    hoisted = lm.hoist_weight_quant(params, policy)
    del params
    free = lm.weights_free(policy, cfg.tie_embed)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build
    rng = np.random.default_rng([seed, 181])
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)).to(dev)
    batch = {"tokens": torch.tensor([AUDIO_PROMPT] * B, device=dev),
             "frames": frames}
    serve_model.prefill(hoisted, batch, cfg, AUDIO_MAX_LEN, free)  # warm-up
    torch.cuda.synchronize()
    peak_build = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    lm.encode_audio(hoisted, frames, cfg, free)
    torch.cuda.synchronize()
    encoder_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logits, cache = serve_model.prefill(hoisted, batch, cfg, AUDIO_MAX_LEN,
                                        free)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    pre_launches = dict(LAUNCHES)
    assert pre_launches == {k: (n_l if k == "kv_append_rows" else 0)
                            for k in pre_launches}, pre_launches
    blk = cache["blocks"][0]
    self_kv = tensor_bytes([blk[k] for k in ("k", "v", "k_scale",
                                             "v_scale")])
    cross = tensor_bytes([blk["xk"], blk["xv"]])
    memory = tensor_bytes(cache["memory"])
    assert (self_kv, cross, memory) == (AUDIO_KV_BYTES, AUDIO_CROSS_BYTES,
                                        AUDIO_MEMORY_BYTES), (self_kv, cross,
                                                              memory)
    finite = [bool(torch.isfinite(logits).all())]
    toks = []
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(64):
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        toks.append(tok)
        logits, cache = serve_model.decode_step(hoisted, cache, tok, cfg,
                                                free)
        finite.append(bool(torch.isfinite(logits).all()))
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    assert all(finite), finite.index(False)
    want = {k: 0 for k in launches}
    want.update(kv_append_rows=n_l * 64, decode_attention=n_l * 64)
    assert launches == want, launches
    tokens = torch.cat(toks, dim=1).cpu()
    assert bool(((tokens >= 0) & (tokens < cfg.vocab)).all())
    state = {"logits": logits, "cache": cache}

    def step():
        tok = state["logits"][:, :cfg.vocab].argmax(-1)[:, None]
        state["logits"], state["cache"] = serve_model.decode_step(
            hoisted, state["cache"], tok, cfg, free)

    w_bytes = tensor_bytes([hoisted[k] for k in hoisted if k not in (
        "enc_blocks", "enc_norm", "embed")])
    pos = int(cache["pos"])
    # a step's least bytes: the decoder's weights and the untied head
    # once, the self K/V rows K4 reads (pos + 3 in the window's middle
    # step) and K3 writes, the cross K/V whole
    bound_ms = 1e3 * (w_bytes + n_l * B * (pos + 3 + 1) * 2 * cfg.n_kv_heads
                      * (cfg.head_dim + 4) + AUDIO_CROSS_BYTES) \
        / H100_BYTES_PER_S
    prof = profiled_steps(step, 5, n_l, ("kv_append_rows",
                                         "decode_attention"))
    assert bool(torch.isfinite(state["logits"]).all())
    # the cross-attention alone: the plain decode attention over each
    # layer's xk / xv (``decode_attention`` at cache_len enc_seq is this
    # call, its query position made here, outside the graph), per step
    qx = torch.from_numpy(rng.standard_normal(
        (B, 1, cfg.n_heads, cfg.head_dim)).astype(np.float32)).to(dev).to(
        cfg.dtype)
    xk, xv = state["cache"]["blocks"][0]["xk"], \
        state["cache"]["blocks"][0]["xv"]
    qpos = torch.full((B, 1), cfg.enc_seq - 1, device=dev)
    torch.testing.assert_close(
        attention.chunk_decode_attention(qx, xk[0], xv[0], qpos),
        attention.decode_attention(qx, xk[0], xv[0], cfg.enc_seq),
        rtol=0, atol=0)
    cross_ms = n_l * graph_ms(lambda i: attention.chunk_decode_attention(
        qx, xk[i], xv[i], qpos), n_l)
    cross_bound_ms = 1e3 * AUDIO_CROSS_BYTES / H100_BYTES_PER_S
    peak = torch.cuda.max_memory_allocated()
    del state, cache, logits
    # the paged layout: a prefill (K5 at T = 4) and 8 decode steps
    gc.collect()
    torch.cuda.empty_cache()
    pfree = dataclasses.replace(free, kv_layout="paged", kv_page_size=PS)
    reset_launches()
    logits, cache = serve_model.prefill(hoisted, batch, cfg, AUDIO_MAX_LEN,
                                        pfree)
    for _ in range(8):
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None]
        logits, cache = serve_model.decode_step(hoisted, cache, tok, cfg,
                                                pfree)
        assert bool(torch.isfinite(logits).all())
    torch.cuda.synchronize()
    paged_launches = dict(LAUNCHES)
    want = {k: 0 for k in paged_launches}
    want.update(paged_kv_append_rows=n_l * 9,
                paged_decode_attention=n_l * 8)
    assert paged_launches == want, paged_launches
    del cache, logits, hoisted
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": card, "arch": AUDIO_ARCH, "params": cfg.param_count(),
           "build_s": build_s, "encoder_ms": encoder_ms,
           "prefill_ms": prefill_ms, "decode_step_ms": 1e3 * decode_s / 64,
           "tok_s": B * 64 / decode_s, "prefill_launches": pre_launches,
           "launches": launches, "paged_launches": paged_launches,
           "self_kv_bytes": self_kv, "cross_kv_bytes": cross,
           "memory_bytes": memory, "weight_bytes_decoder": w_bytes,
           "bound_ms": bound_ms, "bound_by": "bytes", "profiled": prof,
           "cross_attention_ms_per_step": cross_ms,
           "cross_attention_bound_ms": cross_bound_ms,
           "peak_memory_bytes": peak, "peak_memory_build_bytes": peak_build}
    phase(f"phase 18b [{card}] {AUDIO_ARCH}: {cfg.enc_layers} encoder + "
          f"{n_l} decoder layers, d{cfg.d_model} {cfg.n_heads}/"
          f"{cfg.n_kv_heads}h hd{cfg.head_dim} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab} ({cfg.param_count()} params, bf16, posit8 "
          f"attn/MLP weights and KV), 8 clips of ({cfg.enc_seq}, "
          f"{cfg.d_model}) frames, prompt {list(AUDIO_PROMPT)}, max_len "
          f"{AUDIO_MAX_LEN}: encoder {encoder_ms:.2f} ms, prefill "
          f"{prefill_ms:.2f} ms, 64 greedy decode steps "
          f"{1e3 * decode_s / 64:.3f} ms/step (host clock), "
          f"{B * 64 / decode_s:.1f} tok/s; every logit finite; launches "
          f"prefill { {k: v for k, v in pre_launches.items() if v} }, "
          f"decode { {k: v for k, v in launches.items() if v} }, paged "
          f"prefill + 8 steps "
          f"{ {k: v for k, v in paged_launches.items() if v} }; self K/V "
          f"{self_kv} B, cross K/V {cross} B, memory {memory} B; profiled "
          f"decode step: wall {prof['step_wall_ms']:.3f} ms/step, "
          f"{device_line(prof, bound_ms)}; cross-attention (plain, {n_l} "
          f"layers) {cross_ms:.3f} ms/step device against its bytes bound "
          f"{cross_bound_ms:.3f} ms; peak memory {peak} B decoding "
          f"({peak_build} B building: init, hoisting, a warm-up prefill)")
    return out


def phase18c(dev, seed) -> dict:
    """18c. K3 + K4 and K5 + K6 alone at the two new shapes, each against
    its plain version: hd 128 with 6 query heads per KV head over 2 KV
    heads and 1024 rows (qwen2-vl; K4's split CTA takes 74,752 B of
    shared memory), and hd 64 with 1 query head per KV head over 20 KV
    heads and 448 rows (whisper); posit16, posit8 and packed posit4,
    from f32 and from bf16 rows, B 8.  Appends bit-exact at T = 1 (ring
    positions across the ring's end; rows not written unchanged) and at
    T = W from 0 (a full prefill); K5 into a pool through a shuffled page
    table.  Attention within rtol 1e-5, atol 1e-5 at full and partial
    ``cache_len`` (f32 q; bf16 q within 2^-7).  Times K3, K4, K5, K6 in
    posit8 (CUDA graph replays over the model's layers' buffers) beside
    their bytes bounds."""
    import torch
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import _build
    from repro_torch.kernels import kv_cache as kvk
    from repro_torch.kernels import paged_kv as pkv
    rng = np.random.default_rng([seed, 183])
    shapes = {"hd128_grp6": (1024, 2, 128, 12, 28),
              "hd64_grp1": (AUDIO_MAX_LEN, 20, 64, 20, 32)}
    out = {}
    for label, (w, nkv, hd, nh, n_l) in shapes.items():
        pmax = -(-w // PS)
        n_pages = 1 + B * pmax
        perm = rng.permutation(np.arange(1, n_pages))
        table = torch.from_numpy(perm.reshape(B, pmax).astype(np.int32)).to(
            dev)

        def codes(rows_, fmt, packed):
            dc = kvk.code_channels(hd, fmt, packed)
            hi = 1 << (8 if fmt.bits <= 8 else 16)
            c = torch.from_numpy(rng.integers(0, hi, rows_ + (nkv, dc))).to(
                dev)
            if fmt.bits > 8:
                c = torch.where(c >= 1 << 15, c - (1 << 16), c)
            s = torch.from_numpy(np.exp2(rng.integers(
                -8, 8, rows_ + (nkv,))).astype(np.float32)).to(dev)
            return c.to(_build.code_dtype(fmt)), s

        def rows(t, spread=6):
            mag = np.exp2(rng.uniform(-spread, spread, (B, t, nkv, 1)))
            return torch.from_numpy((rng.normal(0, 1, (B, t, nkv, hd)) * mag)
                                    .astype(np.float32)).to(dev)

        pos1 = torch.tensor([0, 1, w - 1, w, 2 * w - 1, 5, 100, w // 2],
                            dtype=torch.int32, device=dev)
        zero = torch.zeros(B, dtype=torch.int32, device=dev)
        dst1 = pkv.flat_dst_rows_chunk(table, pos1 % w, 1, PS)
        dst_w = pkv.flat_dst_rows_chunk(table, zero, w, PS)
        for name, packed in KV_FORMATS:
            fmt = get_fmt(name)
            for t, pos, dst in ((1, pos1, dst1), (w, zero, dst_w)):
                kn, vn = rows(t), rows(t)
                kv = torch.cat([kn, vn], dim=-1).to(torch.bfloat16)
                for k_in, v_in in ((kn, vn), (kv[..., :hd].contiguous(),
                                              kv[..., hd:])):
                    ring = codes((B, w), fmt, packed) + codes((B, w), fmt,
                                                              packed)
                    before = LAUNCHES["kv_append_rows"]
                    got = kvk.kv_append_rows(
                        *(x.clone() for x in ring), k_in, v_in, pos, fmt,
                        packed=packed)
                    assert LAUNCHES["kv_append_rows"] == before + 1
                    want = kvk.kv_append_rows_ref(
                        *(x.clone() for x in ring), k_in.float(),
                        v_in.float(), pos, fmt, packed)
                    for g, w_ in zip(got, want):
                        assert bits_equal(g, w_), (label, name, t, "K3")
                    if t == 1:
                        keep = torch.ones((B, w), dtype=torch.bool,
                                          device=dev)
                        keep[torch.arange(B, device=dev),
                             pos.long() % w] = False
                        for g, orig in zip(got, ring):
                            assert torch.equal(g[keep], orig[keep]), name
                    pool = codes((n_pages * PS,), fmt, packed) + codes(
                        (n_pages * PS,), fmt, packed)
                    before = LAUNCHES["paged_kv_append_rows"]
                    got = pkv.paged_kv_append_rows(
                        *(x.clone() for x in pool), k_in, v_in, dst, fmt,
                        packed=packed)
                    assert LAUNCHES["paged_kv_append_rows"] == before + 1
                    want = pkv.paged_kv_append_rows_ref(
                        *(x.clone() for x in pool), k_in.float(),
                        v_in.float(), dst, fmt, packed)
                    for g, w_ in zip(got, want):
                        assert bits_equal(g, w_), (label, name, t, "K5")
        errs = {}
        cls = (torch.full((B,), w, dtype=torch.int32, device=dev),
               torch.tensor([w, 1, 63, 64, 65, w // 2, w - 1, 129],
                            dtype=torch.int32, device=dev))
        for name, packed in KV_FORMATS:
            fmt = get_fmt(name)
            ring = codes((B, w), fmt, packed) + codes((B, w), fmt, packed)
            kvk.kv_append_rows_ref(*ring, rows(w, 2), rows(w, 2), zero, fmt,
                                   packed)
            pool = codes((n_pages * PS,), fmt, packed) + codes(
                (n_pages * PS,), fmt, packed)
            pkv.paged_kv_append_rows_ref(*pool, rows(w, 2), rows(w, 2),
                                         dst_w, fmt, packed)
            q = torch.from_numpy(rng.normal(0, 1, (B, 1, nh, hd)).astype(
                np.float32)).to(dev)
            # a bf16 q is scaled in bf16 by the kernels (the model's own
            # rounding) and in f32 by the plain versions (ROADMAP fault
            # 5), which differ where hd^-0.5 is no power of two (hd 128):
            # the plain versions take the f32 q whose f32 scaling gives
            # the kernels' bf16-scaled values
            qb, sc = q.to(torch.bfloat16), hd ** -0.5
            q_same = (qb.float() * sc).to(torch.bfloat16).float() / sc
            e = {"K4": 0.0, "K4_bf16_q": 0.0, "K6": 0.0, "K6_bf16_q": 0.0}
            for cl in cls:
                for qq, qr, tag, tol in ((q, q, "", 1e-5),
                                         (qb, q_same, "_bf16_q", 2 ** -7)):
                    pairs = {
                        "K4": (kvk.decode_attention(qq, *ring, cl, fmt,
                                                    packed=packed),
                               kvk.decode_attention_ref(qr, *ring, cl, fmt,
                                                        packed)),
                        "K6": (pkv.paged_decode_attention(
                            qq, *pool, table, cl, fmt, page_size=PS,
                            packed=packed),
                            pkv.paged_decode_attention_ref(
                                qr, *pool, table, cl, fmt, page_size=PS,
                                packed=packed))}
                    for kname, (got, want) in pairs.items():
                        got, want = got.float(), want.float()
                        torch.testing.assert_close(got, want, rtol=tol,
                                                   atol=tol)
                        e[kname + tag] = max(e[kname + tag], float(
                            (got - want).abs().max()))
            errs[name] = e
        # times at the decode step's shapes: the model's layers' rings and
        # pools (posit8), bf16 rows and q, every slot's rows live
        fmt = get_fmt("posit8_2")
        rings = [codes((B, w), fmt, False) + codes((B, w), fmt, False)
                 for _ in range(n_l)]
        pools = [codes((n_pages * PS,), fmt, False) + codes(
            (n_pages * PS,), fmt, False) for _ in range(n_l)]
        k1, v1 = rows(1).to(torch.bfloat16), rows(1).to(torch.bfloat16)
        qb = torch.from_numpy(rng.normal(0, 1, (B, 1, nh, hd)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        full = cls[0]
        dst_step = pkv.flat_dst_rows(table, pos1 % w, PS)
        us = {
            "k3": 1e3 * graph_ms(lambda i: kvk.kv_append_rows(
                *rings[i], k1, v1, pos1, fmt), n_l),
            "k4": 1e3 * graph_ms(lambda i: kvk.decode_attention(
                qb, *rings[i], full, fmt), n_l),
            "k5": 1e3 * graph_ms(lambda i: pkv.paged_kv_append(
                *pools[i], k1, v1, dst_step, fmt), n_l),
            "k6": 1e3 * graph_ms(lambda i: pkv.paged_decode_attention(
                qb, *pools[i], table, full, fmt, page_size=PS), n_l)}
        # K3/K5: bf16 rows read, codes + scales written, an index read;
        # K4/K6: every live row's codes and scales (K and V), q read, out
        # written (K6 also its table)
        append_b = 2 * B * nkv * (hd * 2 + hd + 4) + B * 4
        attn_b = 2 * B * w * nkv * (hd + 4) + 2 * B * nh * hd * 2 + B * 4
        bound = {"k3": append_b, "k4": attn_b, "k5": append_b + B * 4,
                 "k6": attn_b + B * pmax * 4}
        out[label] = {
            "shape": {"B": B, "rows": w, "kv_heads": nkv, "hd": hd,
                      "q_heads": nh, "layers_timed": n_l},
            "max_abs_err": errs,
            "times_posit8": {k: {"us": v, "bound_us":
                                 1e6 * bound[k] / H100_BYTES_PER_S}
                             for k, v in us.items()},
            "k4_split_smem_bytes": 4 * (256 + (nh // nkv) * hd
                                        + (nh // nkv) * kvk.SPLIT_ROWS
                                        + kvk.SPLIT_ROWS * (hd + 4))}
        del rings, pools
        phase(f"phase 18c K3/K4 and K5/K6 at {label} (B {B}, {w} rows, "
              f"{nkv} KV heads of {hd}, {nh} query heads; posit16, posit8, "
              f"packed posit4; K4 split CTA "
              f"{out[label]['k4_split_smem_bytes']} B of shared memory): "
              f"K3 and K5 bit-exact from f32 and bf16 rows at T=1 (ring "
              f"positions {pos1.tolist()}) and T={w}; K4 and K6 at "
              f"cache_len {w} and {cls[1].tolist()} max |err| "
              + ", ".join(f"{k}: " + " ".join(f"{n_} {v:.2e}"
                                               for n_, v in e_.items())
                          for k, e_ in errs.items())
              + " (rtol/atol 1e-5; bf16 q 2^-7); posit8 device µs per call "
              + ", ".join(f"{k.upper()} {v['us']:.2f} (bound "
                          f"{v['bound_us']:.3f})"
                          for k, v in out[label]["times_posit8"].items()))
    return out


def phase18d(dev, seed) -> dict:
    """18d. Card vs CPU at float32 (TF32 off) on the two smoke configs,
    ``paper_edge_p8`` per-call weight hook, posit8 KV ring: qwen2-vl from
    a 20-token prompt and from 12 rows of patch embeddings, whisper from
    two clips with 4-token prompts.  The prefill's logits, ``memory`` and
    ``xk``/``xv`` within rtol 1e-3, atol 1e-3, ring scales equal and codes
    by ``posit8_flips`` on < 0.1 % of them; then 4 decode steps, each from
    the card's state on both devices, held the same way."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm, serve_model
    policy = dataclasses.replace(get_policy("paper_edge_p8"),
                                 kv_format="posit8")
    rng = np.random.default_rng([seed, 184])
    tol = dict(rtol=1e-3, atol=1e-3)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    dmax, flips = {}, [0, 0, 0]

    def close(label, card_c, cpu_c, card_l, cpu_l):
        torch.testing.assert_close(card_l.cpu(), cpu_l, **tol)
        key = label + "_logits"
        dmax[key] = max(dmax.get(key, 0.0),
                        float((card_l.cpu() - cpu_l).abs().max()))
        leaves = {f"b.{k}": v for k, v in card_c["blocks"][0].items()}
        cpu = {f"b.{k}": v for k, v in cpu_c["blocks"][0].items()}
        if "memory" in card_c:
            leaves["memory"], cpu["memory"] = card_c["memory"], \
                cpu_c["memory"]
        for k, v in leaves.items():
            v, p = v.cpu(), cpu[k]
            if k.endswith("scale"):
                assert torch.equal(v, p), (label, k)
            elif k in ("b.k", "b.v"):
                n, far = posit8_flips(v, p)
                flips[0] += n
                flips[1] += far
                flips[2] += v.numel()
            else:
                torch.testing.assert_close(v, p, **tol)
                key = f"{label}_{k.split('.')[-1]}"
                dmax[key] = max(dmax.get(key, 0.0),
                                float((v - p).abs().max()))

    try:
        for arch in (VLM_ARCH, AUDIO_ARCH):
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      dtype_name="float32")
            params = lm.init_params(cfg, torch.Generator().manual_seed(
                seed + 184), device="cpu")
            params_d = tree_to(params, dev)
            if arch == VLM_ARCH:
                inputs = [{"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab, (1, 20)))},
                    {"embeds": torch.from_numpy(rng.standard_normal(
                        (1, 12, cfg.d_model)).astype(np.float32))}]
            else:
                inputs = [{"tokens": torch.as_tensor(
                    rng.integers(0, cfg.vocab, (2, 4))),
                    "frames": torch.from_numpy(rng.standard_normal(
                        (2, cfg.enc_seq, cfg.d_model)).astype(np.float32))}]
            for batch in inputs:
                label = f"{cfg.family}_{'/'.join(batch)}"
                lc, cc = serve_model.prefill(params_d, tree_to(batch, dev),
                                             cfg, 64, policy)
                lp, cp = serve_model.prefill(params, batch, cfg, 64, policy)
                close(label + "_prefill", cc, cp, lc, lp)
                tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
                for _ in range(4):
                    cpu_cache = tree_to(cc, "cpu")
                    lc, cc = serve_model.decode_step(params_d, cc, tok, cfg,
                                                     policy)
                    lp, cp = serve_model.decode_step(params, cpu_cache,
                                                     tok.cpu(), cfg, policy)
                    close(label + "_decode", cc, cp, lc, lp)
                    tok = lc[:, :cfg.vocab].argmax(-1)[:, None]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert flips[0] < 1e-3 * flips[2], flips
    phase(f"phase 18d qwen2-vl and whisper smoke card vs CPU (float32, "
          f"TF32 off, paper_edge_p8, posit8 KV ring): prefills from tokens, "
          f"from patch embeddings and from frames, then 4 decode steps each "
          f"from the card's state: logits, memory, xk and xv within rtol "
          f"1e-3 atol 1e-3 (max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in dmax.items())
          + f"); ring scales equal, {flips[0]} of {flips[2]} codes differ "
          f"({flips[1]} near zero, the rest one posit step)")
    return {"max_abs_diff": dmax, "codes_differ": flips[0],
            "codes_near_zero": flips[1], "codes_compared": flips[2]}


def phase18e(dev, seed) -> dict:
    """18e. What the port refuses on the card, where the reference fails:
    a CUDA whisper smoke engine builds under posit8 KV and its first
    admission raises ``ValueError`` (no frames); so do a
    ``SpeculativeEngine`` for it, a bucketed (``true_len``) prefill of
    vlm embeds and of audio, and an audio prefill over ``pack_params``
    weights.  A CUDA qwen2-vl smoke engine serves."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy, pack_params
    from repro_torch.models import lm, serve_model
    from repro_torch.serve.engine import Request, ServeConfig, ServingEngine
    from repro_torch.serve.speculative import SpeculativeEngine
    scfg = ServeConfig(max_batch=2, max_len=64, kv_format="posit8")
    pol = get_policy("paper_edge_p8")
    rng = np.random.default_rng([seed, 185])
    vcfg = get_config(VLM_ARCH, smoke=True)
    vparams = lm.init_params(vcfg, torch.Generator(device=dev).manual_seed(
        seed + 185), device=dev)
    req = Request(uid=0, prompt=rng.integers(0, vcfg.vocab, 9), max_new=4)
    ServingEngine(vcfg, vparams, scfg, policy=pol, device=dev).serve([req])
    assert req.done and req.error is None and len(req.out_tokens) == 4
    acfg = get_config(AUDIO_ARCH, smoke=True)
    aparams = lm.init_params(acfg, torch.Generator(device=dev).manual_seed(
        seed + 186), device=dev)
    eng = ServingEngine(acfg, aparams, scfg, policy=pol, device=dev)
    toks = torch.as_tensor(rng.integers(0, acfg.vocab, (2, 4))).to(dev)
    frames = torch.from_numpy(rng.standard_normal(
        (2, acfg.enc_seq, acfg.d_model)).astype(np.float32)).to(dev)
    emb = torch.zeros((2, 8, vcfg.d_model), device=dev)
    refused = {}
    for name, call in (
            ("audio_admission", lambda: eng.serve([Request(
                uid=1, prompt=np.arange(4), max_new=2)])),
            ("audio_speculative", lambda: SpeculativeEngine(
                acfg, aparams, scfg, policy=pol, device=dev)),
            ("vlm_embeds_true_len", lambda: serve_model.prefill(
                vparams, {"embeds": emb}, vcfg, 64, pol, true_len=[5, 8])),
            ("audio_true_len", lambda: serve_model.prefill(
                aparams, {"tokens": toks, "frames": frames}, acfg, 64, pol,
                true_len=[3, 4])),
            ("audio_packed_prefill", lambda: serve_model.prefill(
                pack_params(aparams, pol), {"tokens": toks,
                                            "frames": frames}, acfg, 64,
                pol))):
        try:
            call()
        except ValueError as e:
            refused[name] = str(e)[:120]
        else:
            raise AssertionError(f"{name} was not refused")
    phase(f"phase 18e refusals on the card: a CUDA {VLM_ARCH} smoke engine "
          f"serves; a CUDA {AUDIO_ARCH} smoke engine builds; refused: "
          + "; ".join(f"{k}: {v}" for k, v in refused.items()))
    return {"vlm_engine_serves": True, "audio_engine_builds": True,
            "refused": refused}


# ---------------------------------------------------------------------------
# Phase 19: the KV-sequence-sharded distributed decode
# ---------------------------------------------------------------------------

DIST_PAGES = 258            # the first count >= 6c's 257 that 2 ranks divide
# a rank's ring at world 2: 12 layers x (2 x 8*512*4*64 B of posit8 codes +
# 2 x 8*512*4*4 B of f32 scales), half of the undistributed 53,477,376 B
DIST_KV_RANK_BYTES = 26_738_688
# the combine per layer at B 8: o 8*4*3*64 f32 + m and l 8*4*3 f32 each
DIST_COMBINE_LAYER_BYTES = 25_344
DIST_WINDOW = 5             # steps per timed / profiled / collective window
RUNS19 = (("float32", "ring"), ("float32", "paged"), ("bfloat16", "ring"),
          ("bfloat16", "paged"))


@contextlib.contextmanager
def counted_collectives(timed: bool = False):
    """Count the ``torch.distributed.all_reduce`` calls made inside the
    block and the bytes they carry; ``timed`` also synchronises the card
    around each call and sums their host-clock seconds (the combine's
    time: the wait included)."""
    import torch
    import torch.distributed as dist
    real = dist.all_reduce
    log = {"calls": 0, "bytes": 0, "s": 0.0}

    def counted(t, *a, **kw):
        log["calls"] += 1
        log["bytes"] += t.numel() * t.element_size()
        if not timed:
            return real(t, *a, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, *a, **kw)
        torch.cuda.synchronize()
        log["s"] += time.perf_counter() - t0
        return out

    dist.all_reduce = counted
    try:
        yield log
    finally:
        dist.all_reduce = real


def run19(dev, seed, prompts, warm, *, distributed: bool, runs,
          windows: bool = False, num_pages: int = DIST_PAGES) -> dict:
    """Serve phase 6's eight prompts (32 new tokens each) at full width
    through fresh ``ServingEngine``s, one per (dtype, layout) of ``runs``:
    paper-edge with seeded weights (``seed + 19``, so every process draws
    the same), ``paper_edge_p8``, max batch 8, max_len 1024, the ring or a
    posit8 pool of ``num_pages`` 16-row pages; ``distributed`` plugs the
    KV-sequence-sharded decode attention of the initialised process group.
    Each run: a warm-up request, then every kernel count and the
    collective counter set to 0 just before the serve and read just after.
    Returns, per run, the streams, the first decode step's logits, the
    launches, steps, prefill calls, KV bytes and collectives; asserts
    every request got its 32 tokens and every logit is finite.  With
    ``windows`` (float32 ring, distributed): the 8 prompts readmitted,
    then three windows of ``DIST_WINDOW`` decode steps, 8 slots live:
    wall and wrapper launches per step; the profiler's kernel names per
    step; the collectives per step, synchronised and timed; and the
    combine's bytes of one ``make_distributed_decode_step`` call on a
    fresh rank-local cache at max_len 512 and 1024."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy, kv_storage
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lm, serve_model
    from repro_torch.serve import (Request, ServeConfig, ServingEngine,
                                   distributed_decode_attention,
                                   make_distributed_decode_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = kv_storage(dataclasses.replace(get_policy("paper_edge_p8"),
                                          kv_format="posit8"))
    out = {}
    for dtype_name in sorted({d for d, _ in runs}, reverse=True):
        cfg = dataclasses.replace(get_config("paper-edge"),
                                  dtype_name=dtype_name)
        n_l = cfg.n_layers
        params = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed + 19), device=dev)
        for layout in ("ring", "paged"):
            if (dtype_name, layout) not in runs:
                continue
            kw = ({"kv_layout": "paged", "page_size": PS,
                   "num_pages": num_pages} if layout == "paged" else {})
            plug = (distributed_decode_attention(
                kv_spec=spec, paged=layout == "paged", page_size=PS)
                if distributed else None)
            eng = ServingEngine(cfg, params, ServeConfig(
                max_batch=B, max_len=W, kv_format="posit8", **kw),
                policy="paper_edge_p8", attn_impl=plug, device=dev)
            nonfinite = []
            checked_stages(eng, nonfinite)
            eng.serve([Request(uid=-1, prompt=warm, max_new=3)])
            first = []
            generate = eng.engine.generate

            def recorded(p, state, generate=generate, first=first):
                state, logits = generate(p, state)
                if not first:
                    first.append(logits.float().cpu())
                return state, logits

            eng.engine.generate = recorded
            reqs = [Request(uid=i, prompt=p, max_new=32)
                    for i, p in enumerate(prompts)]
            steps0 = eng.stats["decode_steps"]
            calls = eng.metrics.counter("stage.prefill.calls")
            calls0 = calls.value
            torch.cuda.synchronize()
            reset_launches()
            with counted_collectives() as coll:
                t0 = time.perf_counter()
                eng.serve(reqs)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = dict(LAUNCHES)
            steps = eng.stats["decode_steps"] - steps0
            prefills = calls.value - calls0
            assert not nonfinite, nonfinite
            assert all(r.done and r.error is None and len(r.out_tokens) == 32
                       for r in reqs)
            want = {k: 0 for k in launches}
            want["kv_append_rows"] = n_l * prefills
            if distributed:
                want["paged_kv_append_rows"] = n_l * steps
                want["posit_decode"] = 2 * n_l * steps
                assert coll["calls"] == 2 * n_l * steps, (coll, steps)
                assert coll["bytes"] == DIST_COMBINE_LAYER_BYTES * n_l * \
                    steps, (coll, steps)
            elif layout == "ring":
                want["kv_append_rows"] += n_l * steps
                want["decode_attention"] = n_l * steps
            else:
                want["paged_kv_append_rows"] = n_l * steps
                want["paged_decode_attention"] = n_l * steps
            assert launches == want, (dtype_name, layout, launches, want)
            run = {"tokens": [r.out_tokens for r in reqs],
                   "first_logits": first[0], "launches": launches,
                   "steps": steps, "prefill_calls": prefills,
                   "kv_bytes": eng.kv_cache_bytes(), "wall_s": wall,
                   "tok_s": 32 * len(reqs) / wall,
                   "collectives": coll["calls"],
                   "collective_bytes": coll["bytes"]}
            if windows and dtype_name == "float32" and layout == "ring":
                run["windows"] = _windows19(eng, prompts, n_l)
                step = make_distributed_decode_step(cfg, eng.engine.policy)
                tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)
                per_len = {}
                for max_len in (W // 2, W):
                    cache = serve_model.init_cache(
                        cfg, B, max_len, policy=eng.engine.policy,
                        kv_shard=step.shard, device=dev)
                    with counted_collectives() as c:
                        step(eng.params, cache, tok)
                    per_len[max_len] = c["bytes"]
                assert set(per_len.values()) == {
                    DIST_COMBINE_LAYER_BYTES * n_l}, per_len
                run["combine_bytes_per_step_by_max_len"] = per_len
            out[dtype_name, layout] = run
            del eng
            gc.collect()
        del params
    return out


def _windows19(eng, prompts, n_l: int) -> dict:
    """The three decode-step windows of ``run19`` on a distributed float32
    ring engine, after readmitting the 8 prompts (one bucketed prefill)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import Request
    assert all(eng.add_requests([Request(uid=100 + i, prompt=p, max_new=32)
                                 for i, p in enumerate(prompts)]))

    def step():
        eng.cache, logits = eng.engine.generate(eng.params, eng.cache)
        logits.float().cpu()

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for _ in range(DIST_WINDOW):
        step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / DIST_WINDOW
    per_step = {k: v / DIST_WINDOW for k, v in LAUNCHES.items() if v}
    assert per_step == {"paged_kv_append_rows": n_l,
                        "posit_decode": 2 * n_l}, per_step
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(DIST_WINDOW):
            step()
        torch.cuda.synchronize()
    n_kernels = {}
    per_kernel = device_events(prof, n_kernels)
    traced = {k: n_kernels.get(k, 0) / DIST_WINDOW for k in PORT_KERNEL_NAMES}
    if per_kernel:          # a trace with no device events: not measured
        assert traced == {k: {"posit_decode_kernel": 2 * n_l,
                              "append_kernel": n_l}.get(k, 0)
                          for k in traced}, traced
    busy = (sum(per_kernel.values()) / DIST_WINDOW / 1e3 if per_kernel
            else None)
    with counted_collectives(timed=True) as coll:
        t0 = time.perf_counter()
        for _ in range(DIST_WINDOW):
            step()
        torch.cuda.synchronize()
        timed_ms = 1e3 * (time.perf_counter() - t0) / DIST_WINDOW
    assert coll["calls"] == 2 * n_l * DIST_WINDOW, coll
    assert coll["bytes"] == DIST_COMBINE_LAYER_BYTES * n_l * DIST_WINDOW, \
        coll
    return {"step_wall_ms": wall_ms, "wrapper_launches_per_step": per_step,
            "traced_port_kernels_per_step": traced,
            "device_busy_ms": busy,
            "kernel_launches_per_step":
                sum(n_kernels.values()) / DIST_WINDOW if per_kernel else None,
            "collectives_per_step": coll["calls"] / DIST_WINDOW,
            "combine_bytes_per_step": coll["bytes"] / DIST_WINDOW,
            "combine_ms_per_step": 1e3 * coll["s"] / DIST_WINDOW,
            "step_wall_ms_with_timed_combine": timed_ms}


def rank19(rank: int, world: int, root: str, backend: str, seed: int,
           prompts, warm, device: str, num_pages: int) -> None:
    """A rank process of ``run_ranks``: its ``device``, the ``backend``
    group through ``file://<root>/group``, ``run19`` distributed over
    every (dtype, layout) with the windows; its results in
    ``<root>/rank<rank>.pt``."""
    import datetime
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{root}/group",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        out = run19(dev, seed, prompts, warm, distributed=True,
                    runs=RUNS19, windows=True, num_pages=num_pages)
        torch.save(out, Path(root) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, devices, backend: str, seed: int, prompts, warm,
              plain: dict, num_pages: int, timeout: float = 600) -> dict:
    """Spawn ``world`` rank processes (rank r on ``devices[r]``) joined over
    ``backend`` through a ``file://`` init in a temporary directory, each
    serving ``run19``'s requests through the distributed decode attention
    with 1/``world`` of the KV sequence, and hold them to ``plain``, the
    undistributed ``run19`` of the same requests and pool: per run of
    ``RUNS19``, the streams of every rank equal; every rank's KV bytes
    1/``world`` of the undistributed engine's; at float32 the streams equal
    the undistributed engine's; at bf16 the first decode step's logits
    within 0.1 of its (the port's bf16 parity tolerance), the tokens that
    agree counted.  Returns the comparison per run, every rank's float32
    ring windows and rank 0's combine bytes by max_len."""
    import torch
    import torch.multiprocessing as mp
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")   # one host's ranks
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank19,
                             args=(r, world, root, backend, seed, prompts,
                                   warm, devices[r], num_pages))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=timeout)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        assert not alive, f"ranks still running after {timeout} s: {alive}"
        assert [p.exitcode for p in procs] == [0] * world, [
            p.exitcode for p in procs]
        ranks = [torch.load(Path(root) / f"rank{r}.pt", weights_only=False)
                 for r in range(world)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"world": world, "backend": backend, "num_pages": num_pages,
           "ranks_s": time.perf_counter() - t0}
    for key in RUNS19:
        dtype_name, layout = key
        want, got = plain[key], [r[key] for r in ranks]
        assert all(g["tokens"] == got[0]["tokens"] for g in got), key
        assert all(world * g["kv_bytes"] == want["kv_bytes"] for g in got), (
            key, [g["kv_bytes"] for g in got], want["kv_bytes"])
        diff = float((got[0]["first_logits"]
                      - want["first_logits"]).abs().max())
        agree = sum(a == b for x, y in zip(got[0]["tokens"], want["tokens"])
                    for a, b in zip(x, y))
        if dtype_name == "float32":
            assert got[0]["tokens"] == want["tokens"], key
        else:
            assert diff < 0.1, (key, diff)
        out[f"{dtype_name}_{layout}"] = {
            "tokens_equal_undistributed": agree, "of": 32 * len(prompts),
            "first_step_max_abs_logit_diff": diff,
            "ranks_logits_equal": all(
                torch.equal(g["first_logits"], got[0]["first_logits"])
                for g in got),
            "kv_bytes_rank": got[0]["kv_bytes"],
            "kv_bytes_undistributed": want["kv_bytes"],
            "launches_rank0": got[0]["launches"], "steps": got[0]["steps"],
            "prefill_calls": got[0]["prefill_calls"],
            "collectives_rank0": got[0]["collectives"],
            "collective_bytes_rank0": got[0]["collective_bytes"],
            "tok_s_ranks": [g["tok_s"] for g in got],
            "tok_s_undistributed": want["tok_s"]}
    out["windows"] = [r["float32", "ring"]["windows"] for r in ranks]
    out["combine_bytes_per_step_by_max_len"] = ranks[0]["float32", "ring"][
        "combine_bytes_per_step_by_max_len"]
    return out


def phase19(dev, seed, prompts, warm, card: str) -> dict:
    """19. The KV-sequence-sharded distributed decode on the one card
    (NCCL refuses two ranks on one device): full-width paper-edge,
    ``paper_edge_p8``, phase 6's eight prompts x 32 new tokens (up to 894
    tokens: the ring's rows [512, 1024) are live).  First the
    undistributed engine in both layouts at float32 and bf16 (the ring;
    a posit8 pool of 258 16-row pages).  19a: one rank over NCCL (world
    1), ring, float32: its streams equal the undistributed engine's.  19b:
    ``run_ranks`` with two processes on ``cuda:0`` over gloo, each holding
    half the KV sequence (ring rows [0, 512) / [512, 1024); pages [0, 129)
    / [129, 258)), both layouts and dtypes.  Asserts each rank's ring KV
    at 26,738,688 B, half the undistributed 53,477,376 B (the paged
    pool's, half too), 24 collectives a step carrying 25,344 B a layer
    (304,128 B a step, at max_len 512 as at 1024), and K5 12 and K1 24
    launches a decode step by the wrappers' counts and the profiler's
    kernel names."""
    import datetime
    import torch
    import torch.distributed as dist
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    plain = run19(dev, seed, prompts, warm, distributed=False, runs=RUNS19)
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        dist.init_process_group("nccl", init_method=f"file://{root}/nccl",
                                world_size=1, rank=0,
                                device_id=torch.device(
                                    "cuda", torch.cuda.current_device()),
                                timeout=datetime.timedelta(seconds=300))
        try:
            nccl = run19(dev, seed, prompts, warm, distributed=True,
                         runs=(("float32", "ring"),),
                         windows=True)["float32", "ring"]
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    assert nccl["tokens"] == plain["float32", "ring"]["tokens"]
    assert nccl["kv_bytes"] == plain["float32", "ring"]["kv_bytes"]
    phase(f"phase 19a [{card}] one rank over NCCL (world 1), ring, "
          f"float32: streams equal to the undistributed engine's (8 x "
          f"32 tokens); {nccl['collectives']} collectives over "
          f"{nccl['steps']} steps ({nccl['collective_bytes']} B); "
          f"launches K1 {nccl['launches']['posit_decode']} K3 "
          f"{nccl['launches']['kv_append_rows']} K5 "
          f"{nccl['launches']['paged_kv_append_rows']}; "
          f"{nccl['tok_s']:.1f} tok/s served; decode step, 8 slots "
          f"live: wall {nccl['windows']['step_wall_ms']:.3f} ms, "
          f"combine ({nccl['windows']['collectives_per_step']:.0f} "
          f"all-reduces, synchronised) "
          f"{nccl['windows']['combine_ms_per_step']:.3f} ms a step")
    dev_name = f"cuda:{torch.cuda.current_device()}"
    out = run_ranks(2, [dev_name] * 2, "gloo", seed, prompts, warm, plain,
                    DIST_PAGES)
    out["card"] = card
    out["nccl_world1"] = {k: v for k, v in nccl.items()
                          if k not in ("first_logits", "tokens")}
    for dtype_name, layout in RUNS19:
        r = out[f"{dtype_name}_{layout}"]
        if layout == "ring":
            assert r["kv_bytes_rank"] == DIST_KV_RANK_BYTES, r["kv_bytes_rank"]
        tok_s = " / ".join(f"{v:.1f}" for v in r["tok_s_ranks"])
        phase(f"phase 19b [{card}] two gloo ranks on {dev_name}, {layout}, "
              f"{dtype_name}: streams of both ranks equal; "
              f"{r['tokens_equal_undistributed']} of {r['of']} tokens equal "
              f"to the undistributed engine's; first step's logits max "
              f"|diff| {r['first_step_max_abs_logit_diff']:.3e}; KV "
              f"{r['kv_bytes_rank']} B a rank (undistributed "
              f"{r['kv_bytes_undistributed']} B); {r['collectives_rank0']} "
              f"collectives over {r['steps']} steps; {tok_s} tok/s a rank "
              f"(undistributed {r['tok_s_undistributed']:.1f})")
    win = out["windows"]
    out["undistributed_ring_float32_tok_s"] = plain["float32", "ring"][
        "tok_s"]
    out["phase_s"] = time.perf_counter() - t0
    busy = ", ".join("not measured" if w["device_busy_ms"] is None
                     else f"{w['device_busy_ms']:.3f}" for w in win)
    phase(f"phase 19b [{card}] float32 ring decode step, 8 slots live, "
          f"rank 0 / 1: wall {win[0]['step_wall_ms']:.3f} / "
          f"{win[1]['step_wall_ms']:.3f} ms; combine "
          f"({win[0]['collectives_per_step']:.0f} all-reduces, "
          f"synchronised) {win[0]['combine_ms_per_step']:.3f} / "
          f"{win[1]['combine_ms_per_step']:.3f} ms a step, "
          f"{win[0]['combine_bytes_per_step']:.0f} B a step (max_len 512 "
          f"and 1024: {out['combine_bytes_per_step_by_max_len']}); device "
          f"busy {busy} ms a step; kernels traced per step "
          f"{ {k: v for k, v in win[0]['traced_port_kernels_per_step'].items() if v} }"
          f"; phase {out['phase_s']:.1f} s")
    return out


# the (Table III config, simulator kind, format name, bits, Table III op)
# cells of TABLE3, as the TALU simulator measures them
TABLE3_CELLS = (
    [(f"P({n},{es})", f"posit_{op}", f"posit{n}_{es}", None, op)
     for op in ("decode", "mul", "add") for n in (8, 16) for es in (0, 2)]
    + [(f"INT{b}", f"int_{op}", None, b, op)
       for op in ("mul", "add") for b in (4, 8, 16)]
    + [(f"FP{b}", f"fp_{op}", None, b, op)
       for op in ("mul", "add") for b in (8, 16)])
MATMUL20 = (8, 768, 768)    # a decode batch of paper-edge's wo projection


def oracle_table(op: str, n: int, es: int):
    """``posit_ref``'s ``op`` on every pair of P(n, es) codes (a in the
    outer loop), memoised by the exact result value: its own
    to_fraction / encode_fraction, which define its add / mul / sub."""
    from repro_torch.core import posit_ref
    fn = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
          "sub": lambda x, y: x - y}[op]
    vals = [posit_ref.to_fraction(c, n, es) for c in range(1 << n)]
    memo = {}
    out = []
    for x in vals:
        for y in vals:
            v = None if x is None or y is None else fn(x, y)
            if v not in memo:
                memo[v] = posit_ref.encode_fraction(v, n, es)
            out.append(memo[v])
    return np.asarray(out, dtype=np.int64)


def phase20a(dev, seed) -> dict:
    """20a. The TALU's exact posit arithmetic (``core.posit``'s compute
    mode) on the card at paper-edge width: ``mul`` / ``add`` / ``sub`` over
    every pair of P(8,0) and P(8,2) codes, bit-exact to the CPU run of the
    same functions and to ``posit_ref``; 2^20 seeded P(16,1) pairs
    bit-exact to the CPU; ``thermometer_decode`` of every P(8,2) code equal
    to the CPU's; ``matmul_exact`` of P(8,2) codes at (8, 768) x (768,
    768), a 768-step chain over 8 x 768 outputs, bit-exact to the CPU run
    and 4 entries to ``posit_ref``'s sequential chain, with its wall ms
    and CUDA kernel launches; then the port's TALU cycle simulator on
    every Table III cell beside ``TABLE3``."""
    import torch
    from repro_torch.core import posit, posit_ref
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.core.talu import TABLE3, TALU
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"p8": {}}
    a8 = torch.arange(256, dtype=torch.uint8).repeat_interleave(256)
    b8 = torch.arange(256, dtype=torch.uint8).repeat(256)
    for name in ("posit8_0", "posit8_2"):
        fmt = get_fmt(name)
        for op in ("mul", "add", "sub"):
            fn = getattr(posit, op)
            got = fn(a8.to(dev), b8.to(dev), fmt)
            torch.cuda.synchronize()
            assert got.is_cuda and got.dtype == torch.uint8
            assert bits_equal(got.cpu(), fn(a8, b8, fmt)), (name, op)
            table = oracle_table(op, 8, fmt.es)
            assert np.array_equal(got.cpu().numpy().astype(np.int64),
                                  table), (name, op)
            out["p8"][f"{name}_{op}"] = "bit-exact"
    # the memoised table is the oracle's own op on a sample of pairs
    idx = np.random.default_rng(seed).integers(0, 1 << 16, 256)
    table = oracle_table("add", 8, 2)
    assert [posit_ref.add(int(i) >> 8, int(i) & 255, 8, 2)
            for i in idx] == table[idx].tolist()
    fmt = get_fmt("posit16_1")
    g = torch.Generator().manual_seed(seed)
    a16, b16 = (torch.randint(-(1 << 15), 1 << 15, (1 << 20,), generator=g,
                              dtype=torch.int32).to(torch.int16)
                for _ in range(2))
    for op in ("mul", "add", "sub"):
        fn = getattr(posit, op)
        got = fn(a16.to(dev), b16.to(dev), fmt)
        assert bits_equal(got.cpu(), fn(a16, b16, fmt)), op
    p82 = get_fmt("posit8_2")
    codes = torch.arange(256, dtype=torch.uint8)
    for d, c in zip(posit.thermometer_decode(codes.to(dev), p82),
                    posit.thermometer_decode(codes, p82)):
        assert torch.equal(d.cpu(), c)
    m, k, n = MATMUL20
    g = torch.Generator().manual_seed(seed + 1)
    a = torch.randint(0, 256, (m, k), generator=g, dtype=torch.int32)
    b = torch.randint(0, 256, (k, n), generator=g, dtype=torch.int32)
    a = torch.where(a == 128, 0, a).to(torch.uint8)      # no NaR
    b = torch.where(b == 128, 0, b).to(torch.uint8)
    ad, bd = a.to(dev), b.to(dev)
    posit.matmul_exact(ad[:, :4], bd[:4], p82)            # warm-up
    torch.cuda.synchronize()
    s = time.perf_counter()
    card = posit.matmul_exact(ad, bd, p82)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - s) * 1e3
    s = time.perf_counter()
    host = posit.matmul_exact(a, b, p82)
    cpu_ms = (time.perf_counter() - s) * 1e3
    assert card.is_cuda and bits_equal(card.cpu(), host)
    for i, j in ((0, 0), (3, 100), (5, 511), (7, 767)):
        acc = 0
        for kk in range(k):
            acc = posit_ref.add(acc, posit_ref.mul(int(a[i, kk]),
                                                   int(b[kk, j]), 8, 2),
                                8, 2)
        assert int(host[i, j]) == acc, (i, j)
    # CUDA kernel launches: chains of one and of two steps traced, the
    # difference a step's, the rest the start (the zero code)
    counts = []
    for kk in (1, 2):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            posit.matmul_exact(ad[:, :kk], bd[:kk], p82)
            torch.cuda.synchronize()
        n_k = {}
        device_events(prof, n_k)
        counts.append(sum(n_k.values()))
    per_step = counts[1] - counts[0]
    launches = (counts[0] - per_step + k * per_step if counts[0]
                else "not measured")
    talu = {}
    for cfg_name, kind, fname, bits, op in TABLE3_CELLS:
        got = TALU().measure(kind, fmt=fname and get_fmt(fname),
                             bits=bits or 8)
        assert got == TABLE3[(cfg_name, op)], (cfg_name, op, got)
        talu[f"{cfg_name} {op}"] = got
    out.update({
        "p16_1_pairs": 1 << 20, "thermometer_p8_2": "equal",
        "matmul_exact": {"shape": list(MATMUL20), "format": "posit8_2",
                         "card_wall_ms": card_ms, "cpu_wall_ms": cpu_ms,
                         "card_vs_cpu": "bit-exact (whole product)",
                         "oracle_entries": 4, "launches": launches},
        "talu_table3": talu, "phase_s": time.perf_counter() - t0})
    phase(f"phase 20a exact posit arithmetic on the card: mul/add/sub on "
          f"all 65,536 pairs of P(8,0) and P(8,2) bit-exact to the CPU and "
          f"to posit_ref; 2^20 P(16,1) pairs bit-exact to the CPU; "
          f"thermometer_decode of every P(8,2) code equal; matmul_exact "
          f"P(8,2) {m}x{k} @ {k}x{n} (a {k}-step chain) bit-exact to the "
          f"CPU (whole product) and 4 entries to posit_ref: card wall "
          f"{card_ms:.1f} ms, {launches} kernel launches, CPU "
          f"{cpu_ms:.1f} ms; TALU cycles equal to TABLE3 on "
          f"{len(talu)} cells ({talu}); phase {out['phase_s']:.1f} s")
    return out


def fill_kv(cache, g) -> None:
    """Seeded K/V in every ring row, a layer at a time: N(0, 1) floats,
    or posit8_2 codes of 1/4 .. 4 (no NaR)."""
    import torch
    for blk in cache["blocks"]:
        for name in ("k", "v"):
            for layer in blk[name]:
                if layer.dtype == torch.uint8:
                    layer.random_(48, 81, generator=g)
                else:
                    layer.normal_(generator=g)


def kv_at_decode_32k(cache, cfg, fmt, g) -> dict:
    """K3 and K4 on layer 0's ring of the decode_32k cell (B 128, W 32,768
    rows, posit8), each against its plain version on the same inputs.  K3
    from bf16 rows (the step's) at pos W for every slot (the wrap onto row
    0, as the main path's second step) and at seeded per-slot positions
    across the ring's end: codes and scales bit-exact over the whole ring.
    K4 with a bf16 q at cache_len W (the main path's) within 2^-7, and an
    f32 q at ragged lengths across split boundaries within rtol/atol 1e-5;
    the plain version runs 8 slots at a time (a slot's result depends on
    its own rows only)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels import kv_cache as kvk
    blk = cache["blocks"][0]
    ring = tuple(blk[n][0] for n in ("k", "k_scale", "v", "v_scale"))
    b, w, nkv, hd = ring[0].shape
    nh, dev = cfg.n_heads, ring[0].device

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def i32(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    pos_mixed = torch.randint(0, 2 * w, (b,), generator=g,
                              dtype=torch.int32, device=dev)
    pos_mixed[:4] = i32([w - 1, w, 2 * w - 1, 0])
    for pos in (torch.full((b,), w, dtype=torch.int32, device=dev),
                pos_mixed):
        kn, vn = (randn(b, 1, nkv, hd).mul_(4).to(torch.bfloat16)
                  for _ in range(2))
        got = tuple(t.clone() for t in ring)
        want = tuple(t.clone() for t in ring)
        before = LAUNCHES["kv_append_rows"]
        kvk.kv_append_rows(*got, kn, vn, pos, fmt)
        assert LAUNCHES["kv_append_rows"] == before + 1
        kvk.kv_append_rows_ref(*want, kn.float(), vn.float(), pos, fmt)
        for a, c in zip(got, want):
            assert bits_equal(a, c), "K3 at decode_32k"
        del got, want
    cl_rag = torch.randint(1, w + 1, (b,), generator=g, dtype=torch.int32,
                           device=dev)
    sr = kvk.SPLIT_ROWS
    cl_rag[:8] = i32([1, sr - 1, sr, sr + 1, 2 * sr, w - sr, w - 1, w])
    errs = {}
    for label, q, cl, tol in (
            ("bf16_q_full", randn(b, 1, nh, hd).to(torch.bfloat16),
             torch.full((b,), w, dtype=torch.int32, device=dev), 2 ** -7),
            ("f32_q_ragged", randn(b, 1, nh, hd), cl_rag, 1e-5)):
        before = LAUNCHES["decode_attention"]
        got = kvk.decode_attention(q, *ring, cl, fmt)
        assert LAUNCHES["decode_attention"] == before + 1
        want = torch.cat([kvk.decode_attention_ref(
            q[i:i + 8], *(t[i:i + 8] for t in ring), cl[i:i + 8], fmt)
            for i in range(0, b, 8)])
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        errs[label] = float((got.float() - want.float()).abs().max())
    return {"k3_pos": "W for every slot (the wrap) and seeded across the "
                      "ring's end", "k3_vs_plain": "bit-exact",
            "k4_max_abs_err": errs, "k4_splits": -(-w // sr)}


def part_bytes() -> dict:
    """The card's allocated and requested (unrounded) bytes, synchronised."""
    import torch
    torch.cuda.synchronize()
    return {"allocated": torch.cuda.memory_allocated(),
            "requested": torch.cuda.memory_stats()[
                "requested_bytes.all.current"]}


def phase20b(dev, seed, card: str) -> dict:
    """20b. The dry run against the card: paper-edge's ``decode_32k`` cell
    (full width, 128 slots, 32,768-row rings, bf16 seeded weights) built
    on one card with every row live (K/V filled with seeded values,
    ``pos`` 32,767), first under bf16 KV, then with the policy's
    ``kv_format`` posit8 (K3 and K4 over the rings).  Each part the
    build makes (params, cache, token batch) is held to ``launch/dryrun``'s
    argument bytes for that part under ``make_host_mesh(1)``: the card's
    requested bytes equal, and its allocated bytes (rounded up by the
    caching allocator) over all within 1e-4.  Two ``decode_step`` calls
    give finite logits (the second timed with CUDA events, beside the dry
    run's t_compute_s and t_memory_s at the card's constants); the posit8
    run launches K3 and K4 12 times a step, the bf16 run none, and then
    holds K3 and K4 at the cell's shapes against their plain versions
    (``kv_at_decode_32k``).  Both builds are freed before the next
    starts."""
    import torch
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.core.transprecision import BF16
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, serve_model
    t0 = time.perf_counter()
    cfg = get_config("paper-edge")
    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    out = {"card": card, "runs": {}}
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    for label, policy in (("bf16", BF16), ("posit8", dataclasses.replace(
            BF16, kv_format="posit8"))):
        rep = dryrun.lower_cell("paper-edge", "decode_32k",
                                mesh=make_host_mesh(1), policy=policy)
        g = torch.Generator(device=dev).manual_seed(seed)
        marks = [part_bytes()]
        params = lm.init_params(cfg, g, device=dev)
        marks.append(part_bytes())
        cache = serve_model.init_cache(cfg, b, s, policy=policy, device=dev)
        fill_kv(cache, g)
        cache["pos"].fill_(s - 1)                # every row live
        marks.append(part_bytes())
        tok = torch.randint(0, cfg.vocab, (b, 1), generator=g,
                            dtype=torch.int32, device=dev)
        marks.append(part_bytes())
        reckoned = rep["memory_analysis"]["argument_size_in_bytes"]
        parts = rep["memory_analysis"]["argument_bytes_by_part"]
        built = {part: {k: marks[i + 1][k] - marks[i][k]
                        for k in ("allocated", "requested")}
                 for i, part in enumerate(("params", "cache", "batch"))}
        assert set(parts) == set(built), (label, parts)
        for part, got in built.items():
            assert got["requested"] == parts[part], (
                label, part, got, parts[part])
        allocated = marks[-1]["allocated"] - marks[0]["allocated"]
        assert abs(allocated - reckoned) <= 1e-4 * reckoned, (
            label, allocated, reckoned)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logits, cache = serve_model.decode_step(params, cache, tok, cfg,
                                                policy)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(logits).all()), label
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        logits, cache = serve_model.decode_step(params, cache, tok, cfg,
                                                policy)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms = ev[0].elapsed_time(ev[1])
        assert bool(torch.isfinite(logits).all()), label
        launches = {k: v for k, v in LAUNCHES.items()}
        want = ({"kv_append_rows": 2 * cfg.n_layers,
                 "decode_attention": 2 * cfg.n_layers}
                if label == "posit8" else {})
        assert {k: v for k, v in launches.items() if v} == want, launches
        peak = torch.cuda.max_memory_allocated() - marks[0]["allocated"]
        kernels = (kv_at_decode_32k(cache, cfg, get_fmt("posit8_2"), g)
                   if label == "posit8" else None)
        r = rep["roofline"]
        out["runs"][label] = {
            "allocated_bytes": allocated, "reckoned_bytes": reckoned,
            "reckoned_by_part": parts, "built_by_part": built,
            "allocated_over_reckoned": allocated / reckoned,
            "peak_during_steps_bytes": peak,
            "step_ms": step_ms, "t_compute_s": r["t_compute_s"],
            "t_memory_s": r["t_memory_s"], "dominant": r["dominant"],
            "dry_run_depth": rep["op_cost"]["depth"],
            "launches_two_steps": launches, "k3_k4_at_cell": kernels}
        del params, cache, logits, tok
        gc.collect()
        torch.cuda.empty_cache()
        phase(f"phase 20b [{card}] paper-edge decode_32k on one card, "
              f"{label} KV (B {b}, {s}-row rings, every row live): "
              f"requested bytes by part equal to the dry run's {parts}; "
              f"allocated {allocated} B vs dry run {reckoned} B "
              f"({allocated / reckoned:.6f}; by part {built}); decode step "
              f"{step_ms:.3f} ms (CUDA events) vs dry run t_compute "
              f"{r['t_compute_s'] * 1e3:.3f} ms, t_memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms (op bytes, a kernel call "
              f"counted as its launch); peak over the build {peak} B; "
              f"logits finite; launches over 2 steps "
              f"{ {k: v for k, v in launches.items() if v} }"
              + (f"; K3/K4 at the cell vs plain: {kernels}" if kernels
                 else ""))
    runs = out["runs"]
    out["posit8_over_bf16_cache"] = (runs["posit8"]["reckoned_by_part"][
        "cache"] / runs["bf16"]["reckoned_by_part"]["cache"])
    # 64 MiB: workspaces a library makes at its first call (cuBLAS) stay
    assert torch.cuda.memory_allocated() <= base + (64 << 20), (
        "builds not freed", torch.cuda.memory_allocated() - base)
    out["phase_s"] = time.perf_counter() - t0
    phase(f"phase 20b posit8 cache / bf16 cache "
          f"{out['posit8_over_bf16_cache']:.4f}; both builds freed; phase "
          f"{out['phase_s']:.1f} s")
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

    # 15. the MoE family at full width, card vs CPU at smoke size, and
    # the two dispatch paths (own generators) ---------------------------
    moe = {"15a": phase15a(dev, args.seed, prompts, warm, smi),
           "15b": phase15b(dev, args.seed, snapshot, code_flips),
           "15c": phase15c(dev, args.seed, max(len(p) for p in prompts))}
    print(json.dumps({"moe": moe}), flush=True)

    # 16. the SSM family: mamba2-2.7b served at full width, card vs CPU
    # at smoke size, and the refusals (own generators) ------------------
    ssm = {"16a": phase16a(dev, args.seed, smi),
           "16b": phase16b(dev, args.seed),
           "16c": phase16c(dev, args.seed)}
    print(json.dumps({"ssm": ssm}), flush=True)

    # 17. the hybrid family: recurrentgemma-9b served at full width over
    # K3/K4 at hd 256, K3/K4 alone at its shapes, card vs CPU at smoke
    # size, and the refusals (own generators) ---------------------------
    hybrid = {"17a": phase17a(dev, args.seed, smi),
              "17b": phase17b(dev, args.seed),
              "17c": phase17c(dev, args.seed),
              "17d": phase17d(dev, args.seed)}
    print(json.dumps({"hybrid": hybrid}), flush=True)

    # 18. the vlm and audio families: qwen2-vl-2b and whisper-large-v3
    # served at full width over K3/K4 (K5/K6 paged), the KV kernels alone
    # at their shapes, card vs CPU at smoke size, and the refusals (own
    # generators) -----------------------------------------------------------
    vlm_audio = {"18a": phase18a(dev, args.seed, prompts, warm, smi),
                 "18b": phase18b(dev, args.seed, smi),
                 "18c": phase18c(dev, args.seed),
                 "18d": phase18d(dev, args.seed),
                 "18e": phase18e(dev, args.seed)}
    print(json.dumps({"vlm_audio": vlm_audio}), flush=True)

    # 19. the KV-sequence-sharded distributed decode: one rank over NCCL,
    # then two gloo ranks on the one card (spawned processes) -------------
    distributed = phase19(dev, args.seed, prompts, warm, smi)
    print(json.dumps({"distributed": distributed}), flush=True)

    # 20. the TALU's exact posit arithmetic on the card, and the dry run's
    # reckoning against paper-edge's decode_32k cell built on the card
    # (own generators) ----------------------------------------------------
    arith_dryrun = {"20a": phase20a(dev, args.seed),
                    "20b": phase20b(dev, args.seed, smi)}
    print(json.dumps({"arith_dryrun": arith_dryrun}), flush=True)

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
            "launches_moe": {
                layout: {"served": moe["15a"][layout]["launches"][name],
                         "per_decode_step": moe["15a"][layout]["profiled"][
                             "wrapper_launches_per_step"][name]}
                for layout in ("ring", "paged")} if name in MOE_KERNELS
            else None,
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

    for entry in out:       # a mamba2 step runs none of them (16a)
        entry["launches_ssm"] = ssm["16a"]["launches"][entry["name"]]
        # a recurrentgemma step runs K3 and K4 once per attention layer
        # (17a: the served run's count, and per step of the profiled window)
        entry["launches_hybrid"] = {
            "total": hybrid["17a"]["launches"][entry["name"]],
            "per_decode_step": hybrid["17a"]["launches_per_decode_step"].get(
                entry["name"], 0)}
        if entry["name"] in HYBRID_KERNELS:     # 17b: at hd 256, grp 16
            key = "k3" if entry["name"] == "kv_append_rows" else "k4"
            entry["hd256"] = {
                fmt: {"us": t[key + "_us"], "bound_us": t[key + "_bound_us"]}
                for fmt, t in hybrid["17b"]["times"].items()}
        # qwen2-vl (18a: ring, paged and speculative runs, per decode step
        # of the profiled windows) and whisper (18b: the prefill, 64 ring
        # decode steps, a paged prefill and 8 steps)
        name, va, vb = entry["name"], vlm_audio["18a"], vlm_audio["18b"]
        entry["launches_vlm"] = {
            "ring": va["ring"]["launches"][name],
            "paged": va["paged"]["launches"][name],
            "speculative_ring_gamma2":
                va["speculative_ring_gamma2"]["launches"][name],
            "embeds_prefill_and_16_steps": va["embeds"]["launches"][name],
            "per_decode_step_ring": va["ring"]["profiled"][
                "wrapper_launches_per_step"].get(name, 0),
            "per_decode_step_paged": va["paged"]["profiled"][
                "wrapper_launches_per_step"].get(name, 0)}
        entry["launches_audio"] = {
            "prefill": vb["prefill_launches"][name],
            "ring_64_steps": vb["launches"][name],
            "per_decode_step": vb["launches"][name] / 64,
            "paged_prefill_and_8_steps": vb["paged_launches"][name]}
        # the distributed decode (19a: NCCL at world 1, the served run;
        # 19b: gloo rank 0's served runs and its decode step)
        entry["launches_distributed"] = {
            "nccl_world1_ring_float32":
                distributed["nccl_world1"]["launches"][name],
            "gloo_rank0_ring_float32":
                distributed["float32_ring"]["launches_rank0"][name],
            "gloo_rank0_paged_float32":
                distributed["float32_paged"]["launches_rank0"][name],
            "per_decode_step": distributed["windows"][0][
                "wrapper_launches_per_step"].get(name, 0)}
        # paper-edge's decode_32k cell (20b: two decode steps at B 128
        # over 32,768-row rings, bf16 and posit8 KV)
        entry["launches_decode_32k"] = {
            label: r["launches_two_steps"][name] / 2
            for label, r in arith_dryrun["20b"]["runs"].items()}
        key = {"kv_append_rows": "k3", "decode_attention": "k4",
               "paged_kv_append_rows": "k5",
               "paged_decode_attention": "k6"}.get(name)
        if key is not None:                     # 18c: posit8 at their shapes
            for label, c in vlm_audio["18c"].items():
                entry[label] = c["times_posit8"][key]
    print(json.dumps({"kernels": out}), flush=True)

    # last line ---------------------------------------------------------
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
