"""``python -m repro_torch.quickstart`` against ``examples/quickstart.py``.

The port's quickstart runs on the CPU and prints the reference's three
parts: the P(8,2) codes of part 1 equal, part 2's mean relative error
within 1e-6 of the reference's (same numpy inputs), and part 3's loss,
from the reference's own seed-0 params converted, within 1e-3 of the
reference's (bf16 smoke model: the two frameworks round bf16 at other
places).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import posit as jposit  # noqa: E402
from repro.core.formats import POSIT8_2 as JPOSIT8_2  # noqa: E402
from repro.core.quant import quantize as jquantize  # noqa: E402
from repro.core.transprecision import PAPER_EDGE as JPAPER_EDGE  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro.kernels.ops import qt_matmul as jqt_matmul  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.fixture(scope="module")
def printed():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.quickstart", "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _ref_part2():
    """Part 2 of examples/quickstart.py, as it runs it."""
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((64, 128)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((128, 32)) * 0.05, jnp.float32)
    wq = jquantize(w, JPOSIT8_2, axis=0)
    out = jqt_matmul(a, wq)
    err = jnp.abs(out - a @ w).mean() / jnp.abs(a @ w).mean()
    return float(err), wq.nbytes_packed, w.nbytes


def test_part1_codes_equal_reference(printed):
    x = jnp.asarray([0.00024, 1.0, -2.5, 13.0])
    codes = jposit.encode_f32(x, JPOSIT8_2)
    back = jposit.decode_to_f32(codes, JPOSIT8_2)
    want = ["posit P(8,2) round-trip:"] + [
        f"  {float(xi):+9.5f} -> 0b{int(ci):08b} -> {float(bi):+9.5f}"
        for xi, ci, bi in zip(x, codes, back)]
    assert printed.splitlines()[:5] == want
    _, tcodes, _ = quickstart.codec_roundtrip("cpu")
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(codes))


def test_part2_error_equals_reference(printed):
    err, packed, full = _ref_part2()
    got, got_packed, got_full = quickstart.posit_matmul_demo("cpu")
    assert abs(got - err) <= 1e-6, (got, err)
    assert (got_packed, got_full) == (packed, full)
    line = (f"posit8 matmul kernel: mean rel err vs f32 weights = {err:.3f} "
            f"(storage {packed} B vs {full} B)")
    assert line in printed.splitlines()


def test_part3_loss_matches_reference(printed):
    m = re.search(r"TC train step under policy 'paper_edge_p8': "
                  r"loss=(\S+) gnorm=(\S+)", printed)
    assert m and all(np.isfinite(float(v)) for v in m.groups())
    cfg = jget_config("paper-edge", smoke=True)
    opt_cfg = JAdamWConfig(total_steps=10)
    state = jinit(jax.random.PRNGKey(0), cfg, opt_cfg, JPAPER_EDGE)
    params = jax.tree.map(lambda a: np.array(a, np.float32), state.params)
    step = jax.jit(jmake_step(cfg, opt_cfg, JPAPER_EDGE))
    _, want = step(state, jmake_pipeline(cfg, global_batch=4, seq_len=64)(0))
    got = quickstart.train_step_demo(
        "cpu", state=train_state_from_numpy(params, "cpu", torch.bfloat16))
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-3
    assert np.isfinite(float(got["grad_norm"]))
