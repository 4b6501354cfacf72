"""Serving launcher of the port (port of ``repro.launch.serve``): batched
requests through the three-stage engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch paper-edge \
        [--full] [--policy paper_edge_p8] [--async] [--speculative] \
        [--kv-layout paged --overcommit] [--fault-plan random:seed=3,n=6] \
        [--health] [--device cuda|cpu]

Runs on one device: the GPU by default (raises without one), the CPU with
``--device cpu``.  Smoke-scale by default; ``--full`` selects the full
config (124.7 M params for paper-edge).  Weights are random, drawn from a
generator seeded with 0.

The synchronous path serves ``--requests`` prompts through
``ServingEngine.serve`` (``SpeculativeEngine`` with ``--speculative``).
``--async`` drives the threaded orchestrator instead
(``repro_torch.serve.orchestrator``): a backpressured submission queue
with admission timeouts, Poisson arrivals at ``--rate`` req/s, and
host-side detokenize/streaming beside the engine's stages; it reports
TTFT and inter-token latency percentiles.  ``--overcommit`` (paged
layout) admits on current page demand and evicts/requeues the newest
sequence if the pool runs dry.

Robustness: ``--fault-plan random:seed=3,n=6`` arms deterministic
seed-driven fault injection (stage errors and delays, pool-dry allocs,
NaN-poisoned logits, crashed workers under ``lethal=1``) together with the
hardened lifecycle: bounded exponential-backoff stage retries and, on the
base engine, the numeric guard that quarantines non-finite logits and
re-decodes the slot up a precision-fallback ladder.  ``--deadline-s`` /
``--watchdog-s`` bound per-request and scheduler-stall time in async mode,
and ``--health`` prints the health snapshot before exit.

Observability: ``--trace-out run.trace.json`` enables the span tracer,
prints a per-stage wall-clock breakdown and writes a Chrome trace;
``--metrics-json`` dumps the metrics registry; ``--request-log`` appends
one JSON line per terminal request; ``--ttft-slo`` / ``--itl-slo`` (ms)
arm SLO-violation counters.  ``--energy`` prints the modeled energy
breakdown on exit (``obs/energy.py``: each stage's work counted on meta
tensors, priced with the TALU's Table IV per-MAC PDP and 20 pJ/B DRAM; a
model of the paper's edge device, not the card's energy).
"""
from __future__ import annotations

import argparse
import json
import time
from time import perf_counter
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config
from ..core.transprecision import PRESETS
from ..models import lm
from ..obs import (EnergyAccountant, format_breakdown, format_energy,
                   stage_breakdown)
from ..serve.engine import Request, ServeConfig, ServingEngine
from ..serve.faults import FaultPlan, RetryPolicy
from ..serve.orchestrator import (Orchestrator, OrchestratorConfig,
                                  StreamingRequest)
from ..serve.speculative import SpeculativeEngine

_KV_FORMATS = ["f32", "bf16", "posit16", "posit8", "posit4"]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="paper-edge")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", default="paper_edge_p8",
                    choices=sorted(PRESETS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--kv-format", default=None, choices=_KV_FORMATS,
                    help="KV-cache storage override (None: policy default)")
    ap.add_argument("--kv-layout", default=None, choices=["ring", "paged"],
                    help="KV-cache layout override (None: policy default)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged layout: tokens per page")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged layout: pool size incl. trash page "
                         "(None: full reservation)")
    ap.add_argument("--overcommit", action="store_true",
                    help="paged layout: admit on current page demand and "
                         "evict-and-requeue the newest sequence when the "
                         "pool runs dry (stats['evictions'])")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="drive the threaded orchestrator (backpressured "
                         "queue, Poisson arrivals, per-token streaming) "
                         "instead of the synchronous serve loop; prints "
                         "TTFT/ITL percentiles")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="async: offered load in requests/s "
                         "(0 = submit back-to-back)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="async: backpressure cap on requests in flight")
    ap.add_argument("--admission-timeout", type=float, default=60.0,
                    help="async: seconds submit may block on a full queue")
    ap.add_argument("--speculative", action="store_true",
                    help="self-speculative greedy decode: gamma posit8 "
                         "draft steps + one target-precision verify per "
                         "round")
    ap.add_argument("--gamma", type=int, default=4,
                    help="speculative: draft tokens per round")
    ap.add_argument("--draft-kv-format", default="posit8",
                    choices=_KV_FORMATS,
                    help="speculative: draft-pass KV storage format")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome-trace "
                         "JSON on exit; also prints a per-stage wall-clock "
                         "breakdown")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write the metrics-registry snapshot on exit")
    ap.add_argument("--energy", action="store_true",
                    help="print the modeled energy breakdown on exit "
                         "(TALU Table IV PDP + 20 pJ/B DRAM; per-stage pJ "
                         "x live call counters)")
    ap.add_argument("--request-log", default=None, metavar="PATH",
                    help="append one JSON line per terminal request with "
                         "its lifecycle decomposition")
    ap.add_argument("--ttft-slo", type=float, default=None, metavar="MS",
                    help="TTFT SLO threshold in ms; violations counted "
                         "in the metrics registry (orch.slo.*)")
    ap.add_argument("--itl-slo", type=float, default=None, metavar="MS",
                    help="inter-token latency SLO threshold in ms")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="arm deterministic fault injection + the hardened "
                         "lifecycle (bounded stage retries; the numeric "
                         "guard on the base engine).  SPEC is 'none', "
                         "'random:seed=3,n=6[,rounds=40][,slots=2]"
                         "[,lethal=1]' or a JSON fault-list file")
    ap.add_argument("--deadline-s", type=float, default=None, metavar="S",
                    help="async: per-request deadline from submit")
    ap.add_argument("--watchdog-s", type=float, default=None, metavar="S",
                    help="async: fail all in-flight requests if the "
                         "scheduler makes no progress for this long")
    ap.add_argument("--health", action="store_true",
                    help="print the health snapshot (JSON) before exit; "
                         "sync mode prints the counter subset only")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.speculative and args.temperature > 0:
        ap.error("--speculative is greedy-only (temperature 0)")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    params = lm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    scfg = ServeConfig(max_batch=args.batch, max_len=args.max_len,
                       temperature=args.temperature,
                       kv_format=args.kv_format, kv_layout=args.kv_layout,
                       page_size=args.page_size, num_pages=args.num_pages,
                       page_overcommit=args.overcommit)
    faults = retry = None
    if args.fault_plan:
        faults = FaultPlan.parse(args.fault_plan)
        retry = RetryPolicy()
    if args.speculative:
        # the numeric guard is a base-engine decode-round policy
        engine = SpeculativeEngine(cfg, params, scfg, policy=args.policy,
                                   gamma=args.gamma,
                                   draft_kv_format=args.draft_kv_format,
                                   device=device, faults=faults, retry=retry)
    else:
        engine = ServingEngine(cfg, params, scfg, policy=args.policy,
                               device=device, faults=faults, retry=retry,
                               guard=faults is not None)
    if args.trace_out:
        engine.tracer.enable()
    rng = np.random.default_rng(0)
    if args.async_:
        return _serve_async(engine, cfg, rng, args)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(4, 17)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = perf_counter()
    stats = engine.serve(reqs)
    wall = perf_counter() - t0
    for r in reqs[:4]:
        print(f"req {r.uid}: {len(r.out_tokens)} tokens ->",
              r.out_tokens[:10], "...")
    if args.speculative:
        acc = stats["drafts_accepted"] / max(stats["drafts_proposed"], 1)
        spt = stats["decode_steps"] / max(stats["tokens"]
                                          - stats["prefills"], 1)
        print(f"speculative: gamma={args.gamma} acceptance={acc:.2f} "
              f"target steps/token={spt:.2f}")
    print("stats:", {k: (round(v, 2) if isinstance(v, float) else v)
                     for k, v in stats.items()})
    if args.request_log:    # sync path: dump the engine's own stamps
        with open(args.request_log, "a") as f:
            for r in reqs:
                f.write(json.dumps({"uid": r.uid, "error": r.error,
                                    "n_tokens": len(r.out_tokens),
                                    "lifecycle": r.timing}) + "\n")
        print(f"request log -> {args.request_log}")
    health = None
    if args.health:    # sync path: no orchestrator, counters only
        c = engine.metrics.snapshot()["counters"]
        health = {k: int(v) for k, v in sorted(c.items())
                  if k.startswith(("faults.", "guard."))
                  or k in ("stage.retries", "stage.retry_exhausted")}
        print("health:", json.dumps(health))
    energy = _write_obs(engine, wall, args)
    return {"engine": engine, "requests": reqs, "stats": stats,
            "health": health, "energy": energy}


def _write_obs(engine, wall_s, args) -> Optional[Dict[str, Any]]:
    """Dump trace / metrics files, print the stage breakdown and, with
    ``--energy``, the modeled energy breakdown (returned)."""
    if args.trace_out:
        print(format_breakdown(stage_breakdown(engine.tracer, wall_s)))
        engine.tracer.write_chrome_trace(args.trace_out)
        print(f"chrome trace -> {args.trace_out}")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(engine.metrics.snapshot(), f, indent=1)
        print(f"metrics snapshot -> {args.metrics_json}")
    if not args.energy:
        return None
    bd = EnergyAccountant(engine).breakdown()
    print(format_energy(bd))
    return bd


def _serve_async(engine, cfg, rng, args) -> Dict[str, Any]:
    ms = lambda v: v * 1e-3 if v is not None else None   # noqa: E731
    ocfg = OrchestratorConfig(max_queue=args.max_queue,
                              admission_timeout_s=args.admission_timeout,
                              detokenize=False,
                              deadline_s=args.deadline_s,
                              watchdog_s=args.watchdog_s,
                              ttft_slo_s=ms(args.ttft_slo),
                              itl_slo_s=ms(args.itl_slo),
                              request_log=args.request_log)
    sreqs = [StreamingRequest(
        rng.integers(0, cfg.vocab, rng.integers(4, 17)).tolist(),
        max_new=args.max_new) for _ in range(args.requests)]
    t0 = perf_counter()
    # no `with`: under a lethal fault plan a worker loop may die, and
    # __exit__ would re-raise its exception — keep going and report the
    # health snapshot instead
    orch = Orchestrator(engine, ocfg)
    submitted = []
    health = None
    try:
        for s in sreqs:
            try:
                ok = orch.submit(s)
            except RuntimeError as e:   # orchestrator went unhealthy
                print(f"submit refused: {e}")
                break
            if not ok:
                print("request timed out in admission; dropping")
                continue
            submitted.append(s)
            if args.rate > 0:
                time.sleep(float(rng.exponential(1.0 / args.rate)))
        # containment guarantees every submitted request reaches a
        # terminal state, so these waits cannot hang; the timeout bounds
        # the launcher itself
        for s in submitted:
            s.wait(timeout=300.0)
        if args.health:
            health = orch.health()
            print("health:", json.dumps(health))
    finally:
        try:
            orch.close()
        except RuntimeError as e:       # leaked-thread detection
            print(f"close: {e}")
    errs: Dict[str, int] = {}
    for s in submitted:
        if s.error is not None:
            errs[s.error] = errs.get(s.error, 0) + 1
    if errs:
        print("terminal errors:", errs)
    wall = perf_counter() - t0
    for s in sreqs[:4]:
        print(f"stream: {len(s.out_tokens)} tokens ->",
              s.out_tokens[:10], "...")
    ttft = sorted(s.ttft_s for s in sreqs if s.ttft_s is not None)
    itl = sorted(g for s in sreqs for g in s.itl_s())
    pct = lambda xs, q: xs[min(int(q / 100 * len(xs)),   # noqa: E731
                               len(xs) - 1)] * 1e3
    if ttft:
        print(f"TTFT p50/p99: {pct(ttft, 50):.1f}/{pct(ttft, 99):.1f} ms")
    if itl:
        print(f"ITL  p50/p99: {pct(itl, 50):.1f}/{pct(itl, 99):.1f} ms")
    print("orchestrator:", dict(orch.stats), "| engine:",
          {k: (round(v, 2) if isinstance(v, float) else v)
           for k, v in engine.stats.items()})
    if args.ttft_slo is not None or args.itl_slo is not None:
        c = engine.metrics.snapshot()["counters"]
        print("SLO:", {k: int(c.get(f"orch.slo.{k}", 0))
                       for k in ("ttft_violations", "ttft_total",
                                 "itl_violations", "itl_total")})
    if args.request_log:
        print(f"request log -> {args.request_log}")
    energy = _write_obs(engine, wall, args)
    return {"engine": engine, "orchestrator": orch, "streams": sreqs,
            "submitted": submitted, "errors": errs, "health": health,
            "energy": energy}


if __name__ == "__main__":
    main()
