"""The port's training loop (``repro_torch.train.Trainer``), its
fault-tolerance hooks, the elastic data shards and the launcher, on the
CPU at smoke size; and the port's ``Trainer`` against the reference's.

The system invariants of the reference's ``tests/test_system.py`` held
for the port: the loss falls (plain and under the paper's P(8,2)
policy), a crash and restore resumes to the straight run's final loss
within rtol 1e-5 (also under the gradient wire, whose residual the
checkpoint carries), async checkpoints keep k, and the posit16 wire with
error feedback tracks the uncompressed run within 0.15 of loss.  Then
the port's ``Trainer`` and the reference's at float32 under MIXED_TC
(posit8 weights, the posit16 gradient wire), both restored from one
checkpoint the reference wrote: three steps' losses within rtol 1e-4,
the tolerance of ``test_torch_train_step.py``'s three-step comparison
(float32 summation order; the reference's wire scale is inexact on this
CPU at some exponents, which moves a few codes by one posit step):
that comparison is in ``test_torch_trainer_reference.py``, on this
file's config.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import PAPER_EDGE, TCPolicy  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.train.fault_tolerance import (CrashBarrier,  # noqa: E402
                                               ElasticPlan, HeartbeatMonitor,
                                               StragglerMitigator)
from _torch_threads import torch_threads  # noqa: E402,F401

SRC = Path(__file__).resolve().parents[1] / "src"
CFG = get_config("paper-edge", smoke=True)
WIRE = TCPolicy(name="wire", grad_wire="posit16_2")


def _trainer(tcfg, opt, **kw):
    return Trainer(CFG, tcfg, opt, device="cpu", **kw)


def test_training_loss_decreases():
    tr = _trainer(TrainerConfig(steps=30, global_batch=8, seq_len=64,
                                log_every=10),
                  AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3))
    out = tr.run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert last < first - 0.3, (first, last)


def test_tc_policy_training_converges():
    """Training through the paper's P(8,2) policy (STE fake-quant)."""
    tr = _trainer(TrainerConfig(steps=30, global_batch=8, seq_len=64,
                                log_every=10),
                  AdamWConfig(lr=3e-3, total_steps=30, warmup_steps=3),
                  policy=PAPER_EDGE)
    out = tr.run()
    assert out["history"][-1]["loss"] < out["history"][0]["loss"] - 0.2


@pytest.mark.parametrize("policy", ["bf16", WIRE], ids=["bf16", "wire"])
def test_checkpoint_restart_exact(tmp_path, policy):
    """6 steps straight vs 3 + a crash at step 4 + restore + 3: the final
    losses agree within rtol 1e-5; under the wire the residual is part
    of the checkpoint."""
    opt = AdamWConfig(lr=1e-3, total_steps=6, warmup_steps=1)
    out1 = _trainer(TrainerConfig(steps=6, global_batch=4, seq_len=32,
                                  log_every=1), opt, policy=policy).run()
    tcfg = TrainerConfig(steps=6, global_batch=4, seq_len=32,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=3, async_checkpoint=False,
                         log_every=1)
    tr2 = _trainer(tcfg, opt, policy=policy,
                   crash_barrier=CrashBarrier(crash_at_steps=[4]))
    with pytest.raises(CrashBarrier.SimulatedFault):
        tr2.run()
    assert tr2.ckpt.latest_step() == 3
    tr3 = _trainer(tcfg, opt, policy=policy)     # a fresh process restores
    state, start = tr3.restore_or_init()
    assert start == 3 and int(state.opt["step"]) == 3
    if policy is WIRE:
        assert any(r.abs().max() > 0 for r in tree_leaves(state.ef_residual))
    out3 = tr3.run()
    np.testing.assert_allclose(out3["metrics"]["loss"],
                               out1["metrics"]["loss"], rtol=1e-5)


def test_async_checkpoint_and_keep_k(tmp_path):
    tcfg = TrainerConfig(steps=9, global_batch=2, seq_len=16,
                         checkpoint_dir=str(tmp_path / "ck"),
                         checkpoint_every=2, checkpoint_keep=2,
                         async_checkpoint=True, log_every=100)
    tr = _trainer(tcfg, AdamWConfig(total_steps=9, warmup_steps=1))
    tr.run()
    tr.ckpt.wait()
    steps = tr.ckpt.steps()
    assert steps[-1] == 9
    assert len(steps) <= 2 + 1   # keep-k plus the final blocking save


def test_grad_wire_tracks_uncompressed():
    """posit16 wire + error feedback tracks the uncompressed run."""
    tcfg = TrainerConfig(steps=8, global_batch=4, seq_len=32, log_every=1)
    opt = AdamWConfig(lr=1e-3, total_steps=8, warmup_steps=1)
    o1 = _trainer(tcfg, opt).run()
    o2 = _trainer(tcfg, opt, policy=WIRE).run()
    assert abs(o1["metrics"]["loss"] - o2["metrics"]["loss"]) < 0.15
    assert o1["metrics"]["loss"] != o2["metrics"]["loss"]   # the wire ran


def test_heartbeat_and_mitigator_see_every_step():
    tr = _trainer(TrainerConfig(steps=3, global_batch=2, seq_len=16,
                                log_every=1), AdamWConfig(total_steps=3))
    out = tr.run()
    times = tr.monitor.hosts[0].step_times
    assert len(times) == 3 and all(t > 0 for t in times)
    assert tr.monitor.hosts[0].last_step == 2
    assert tr.mitigator.deadline() is not None
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    assert all(h["s_per_step"] > 0 for h in out["history"])


def test_heartbeat_and_elastic_plan():
    mon = HeartbeatMonitor(n_hosts=4, dead_timeout_s=10, window=8)
    now = 1000.0
    for h in range(4):
        for s in range(8):
            mon.beat(h, s, 1.0 if h != 3 else 5.0, now=now)
    assert mon.stragglers() == [3]
    mon.beat(0, 9, 1.0, now=now + 100)
    assert set(mon.dead_hosts(now=now + 100)) == {1, 2, 3}
    plan = ElasticPlan(global_batch=16, n_hosts=4)
    assert [plan.shard_for(h) for h in range(4)][0] == slice(0, 4)
    assert plan.resize(2).shard_for(1) == slice(8, 16)
    with pytest.raises(ValueError):
        ElasticPlan(global_batch=10, n_hosts=4)
    m = StragglerMitigator(deadline_factor=2.0)
    assert not m.should_drop(100.0)
    m.observe(1.0)
    assert m.should_drop(2.5) and not m.should_drop(1.5)
    cb = CrashBarrier(crash_at_steps=[2])
    cb.check(1)
    with pytest.raises(CrashBarrier.SimulatedFault):
        cb.check(2)
    cb.check(2)                        # fires once


def test_elastic_data_resharding_is_lossless():
    """Same step, different world sizes: the union of the host batches is
    the global batch, and each shard is the reference's."""
    pipe = make_pipeline(CFG, global_batch=8, seq_len=16, seed=3,
                         device="cpu")
    jpipe = jmake_pipeline(jget_config("paper-edge", smoke=True),
                           global_batch=8, seq_len=16, seed=3)
    full = pipe.global_batch(step=5)["tokens"]
    for n_hosts in (1, 2, 4, 8):
        parts = [pipe.host_batch(5, h, n_hosts) for h in range(n_hosts)]
        np.testing.assert_array_equal(
            np.concatenate([p["tokens"].numpy() for p in parts]), full)
        for h, p in enumerate(parts):
            want = jpipe.host_batch(5, h, n_hosts)
            for k in ("tokens", "labels"):
                assert p[k].dtype == torch.int64
                np.testing.assert_array_equal(p[k].numpy(), want[k])
    with pytest.raises(ValueError, match="divide"):
        pipe.host_batch(5, 0, 3)


def test_launcher_on_the_cpu(tmp_path):
    out = launch_train.main(["--device", "cpu", "--steps", "3", "--batch",
                             "2", "--seq", "16", "--policy", "mixed_tc",
                             "--ckpt-dir", str(tmp_path / "ck"),
                             "--ckpt-every", "2"])
    assert np.isfinite(out["metrics"]["loss"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_3"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          "--device", "cpu", "--steps", "3", "--batch", "2",
                          "--seq", "16"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr
    assert "final:" in run.stdout and "step 1:" in run.stdout
