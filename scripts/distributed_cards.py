#!/usr/bin/env python3
"""The KV-sequence-sharded distributed decode across the cards of one host,
over NCCL: ``chip_smoke.py``'s phase 19b with one rank per card.

    python3 scripts/distributed_cards.py [--world N] [--seed S]

Needs N CUDA GPUs (all of the host's by default) and ``nvcc``.  Builds the
kernels, serves full-width paper-edge (``paper_edge_p8``, 8 seeded prompts
of 64-900 tokens x 32 new tokens, max_len 1024) through the undistributed
engine on card 0, ring and a posit8 pool of the first page count >= 257
that N divides, at float32 and bf16; then ``chip_smoke.run_ranks`` with
rank r on ``cuda:r`` over NCCL holds every rank's streams, KV bytes,
launches and collectives to it.  Prints the card line, a
``{"distributed_cards": ...}`` JSON line and ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None,
                    help="ranks, one per card (default: every card)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("distributed_cards: no CUDA GPU available", file=sys.stderr)
        return 2
    world = args.world or torch.cuda.device_count()
    if world > torch.cuda.device_count():
        print(f"distributed_cards: {world} ranks need {world} cards, found "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.lib(name)
    rng = np.random.default_rng(args.seed)
    vocab = get_config("paper-edge").vocab
    warm = rng.integers(0, vocab, 64)
    prompts = [rng.integers(0, vocab, int(n))
               for n in rng.integers(64, 901, 8)]
    num_pages = -(-cs.ENGINE_PAGES // world) * world
    t0 = time.perf_counter()
    plain = cs.run19(torch.device("cuda:0"), args.seed, prompts, warm,
                     distributed=False, runs=cs.RUNS19, num_pages=num_pages)
    out = cs.run_ranks(world, [f"cuda:{r}" for r in range(world)], "nccl",
                       args.seed, prompts, warm, plain, num_pages,
                       timeout=900)
    out["prompt_lens"] = sorted(len(p) for p in prompts)
    out["seconds"] = time.perf_counter() - t0
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps({"distributed_cards": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
