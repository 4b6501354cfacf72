"""The PyTorch port's ``Trainer`` against the reference's for three
MIXED_TC steps under the posit16 gradient wire (losses, params and the
wire's residual), split from ``tests/test_torch_trainer.py`` (its
helpers and tolerances) so that the driver's ``--dist loadfile``
spreads the reference's compiles."""
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from test_torch_trainer import CFG  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


def test_trainer_vs_reference_under_the_wire(tmp_path):
    """Both Trainers at float32 under MIXED_TC restore one reference
    checkpoint of step 0 and run 3 steps."""
    import dataclasses
    from repro.core.transprecision import MIXED_TC as JMIXED
    from repro_torch.core.transprecision import MIXED_TC
    jcfg = dataclasses.replace(jget_config("paper-edge", smoke=True),
                               dtype_name="float32")
    tcfg_m = dataclasses.replace(CFG, dtype_name="float32")
    kw = dict(steps=3, global_batch=4, seq_len=32, log_every=1,
              checkpoint_every=100)
    opt = dict(lr=1e-3, total_steps=3, warmup_steps=1)
    jtr = JTrainer(jcfg, JTrainerConfig(checkpoint_dir=str(tmp_path / "j"),
                                        **kw), JAdamW(**opt), policy=JMIXED)
    jtr.ckpt.save(jtr.init_state(), 0)
    shutil.copytree(tmp_path / "j" / "step_0", tmp_path / "t" / "step_0")
    tr = Trainer(tcfg_m, TrainerConfig(checkpoint_dir=str(tmp_path / "t"),
                                       **kw), AdamWConfig(**opt),
                 policy=MIXED_TC, device="cpu")
    jout, out = jtr.run(), tr.run()
    assert [h["step"] for h in out["history"]] == [1, 2, 3]
    for h, jh in zip(out["history"], jout["history"]):
        np.testing.assert_allclose(h["loss"], jh["loss"], rtol=1e-4)
        np.testing.assert_allclose(h["lr"], jh["lr"], rtol=1e-6)
    assert tr.ckpt.steps() == [0, 3]
    jax.clear_caches()
