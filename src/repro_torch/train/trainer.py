"""Trainer: checkpointed, fault-tolerant training loop (port of
``repro.train.trainer``).

Composes the deterministic data pipeline, the port's eager in-place train
step, ``CheckpointManager`` (atomic, keep-k, async) and the fault-tolerance
hooks.  The loop is restart-idempotent: the state lives in (checkpoint,
step), batches are regenerated from the step index, so a crash at any
point resumes bit-exact.

Step time ``dt``: the step is issued eagerly and returns before the card
has finished.  On the card the loop records a CUDA event on the current
stream before the batch is drawn and another after the step is issued;
``dt`` is the time between them on the device's timeline: the step's
device work (batch, forward, backward, the gradient wire, AdamW), plus
any time the card waited for the host within the step, without a
checkpoint save.  A step's ``dt`` is read after the next step has been
issued, so the loop never waits for the card to drain; the heartbeat, the
straggler deadline and the log see each step one step late (the last
step, and the one before a crash, when the loop leaves).  On the CPU the
step is synchronous and ``dt`` is the host clock's.  (The reference reads
its clock after an asynchronous dispatch, so its ``dt`` can hold less
than the step.)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..checkpoint import CheckpointManager
from ..core.transprecision import BF16, TCPolicy, get_policy
from ..data.pipeline import SyntheticLM, make_pipeline
from ..models import lm
from ..optim import AdamWConfig
from .fault_tolerance import CrashBarrier, HeartbeatMonitor, StragglerMitigator
from .step import TrainState, init_train_state, make_train_step


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    checkpoint_keep: int = 3
    async_checkpoint: bool = True
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: lm.ModelCfg, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None,
                 policy: TCPolicy = BF16,
                 data: Optional[SyntheticLM] = None,
                 crash_barrier: Optional[CrashBarrier] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or AdamWConfig(total_steps=tcfg.steps)
        self.policy = get_policy(policy)
        self.data = data or make_pipeline(
            cfg, global_batch=tcfg.global_batch, seq_len=tcfg.seq_len,
            seed=tcfg.seed, device=self.device)
        self.step_fn = make_train_step(cfg, self.opt_cfg, self.policy)
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir,
                                       keep=tcfg.checkpoint_keep)
                     if tcfg.checkpoint_dir else None)
        self.monitor = HeartbeatMonitor(n_hosts=1)
        self.mitigator = StragglerMitigator()
        self.crash_barrier = crash_barrier
        self.history: list = []

    # ---- state ----
    def init_state(self) -> TrainState:
        """Random params from a generator seeded with ``tcfg.seed`` on the
        trainer's device, a fresh AdamW state (and a zero residual under a
        gradient wire)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        return init_train_state(self.cfg, self.opt_cfg, self.policy,
                                generator=gen, device=self.device)

    def restore_or_init(self) -> tuple:
        """(state, first step): the latest committed checkpoint copied
        into a freshly built state, or that state itself at step 0."""
        state = self.init_state()
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, meta = self.ckpt.restore(state)
            return state, int(meta["step"])
        return state, 0

    def _mark(self):
        """A point on the step's timeline: a CUDA event on the current
        stream on the card, the host clock on the CPU."""
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _observe(self, step: int, t0, t1, metrics, first: bool) -> None:
        """Feed one finished step's ``dt`` to the heartbeat and the
        mitigator, and log it."""
        if isinstance(t1, torch.cuda.Event):
            t1.synchronize()
            dt = t0.elapsed_time(t1) / 1e3
        else:
            dt = t1 - t0
        self.monitor.beat(0, step, dt)
        self.mitigator.observe(dt)
        if (step + 1) % self.tcfg.log_every == 0 or first:
            m = {k: float(v) for k, v in metrics.items()}
            self.history.append({"step": step + 1, **m, "s_per_step": dt})
            print(f"step {step + 1}: loss={m.get('loss', 0):.4f} "
                  f"lr={m.get('lr', 0):.2e} "
                  f"gnorm={m.get('grad_norm', 0):.3f} ({dt:.2f}s)")

    # ---- loop ----
    def run(self, steps: Optional[int] = None) -> Dict[str, Any]:
        state, start = self.restore_or_init()
        steps = steps if steps is not None else self.tcfg.steps
        metrics = {}
        pending = None      # the last issued step, observed one step late
        try:
            for step in range(start, steps):
                if self.crash_barrier is not None:
                    self.crash_barrier.check(step)
                t0 = self._mark()
                batch = self.data(step)
                state, metrics = self.step_fn(state, batch)
                t1 = self._mark()
                if pending is not None:
                    self._observe(*pending)
                pending = (step, t0, t1, metrics, step == start)
                if (self.ckpt is not None
                        and (step + 1) % self.tcfg.checkpoint_every == 0):
                    self.ckpt.save(state, step + 1,
                                   blocking=not self.tcfg.async_checkpoint)
        finally:
            if pending is not None:
                self._observe(*pending)
        if self.ckpt is not None:
            self.ckpt.save(state, steps, blocking=True)
        return {"state": state,
                "metrics": {k: float(v) for k, v in metrics.items()},
                "history": self.history}
