"""Training launcher of the port (port of ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-edge \
        [--full] [--steps N] [--policy mixed_tc] [--ckpt-dir DIR] \
        [--device cuda|cpu]

Runs the ``Trainer`` on one device: the GPU by default (raises without
one), the CPU with ``--device cpu``.  Smoke-scale by default; ``--full``
selects the full config (124.7 M params for paper-edge).
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import get_config
from ..core.transprecision import PRESETS
from ..optim import AdamWConfig
from ..train.trainer import Trainer, TrainerConfig


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-edge")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--policy", default="bf16", choices=sorted(PRESETS))
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    tcfg = TrainerConfig(steps=args.steps, global_batch=args.batch,
                         seq_len=args.seq, checkpoint_dir=args.ckpt_dir,
                         checkpoint_every=args.ckpt_every)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(1, args.steps // 10))
    trainer = Trainer(cfg, tcfg, opt, policy=args.policy, device=args.device)
    out = trainer.run()
    print("final:", out["metrics"])
    return out


if __name__ == "__main__":
    main()
