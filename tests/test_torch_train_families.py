"""Train steps of the SSM, hybrid, vlm and audio families in the port
against the reference's, under remat "dots" and the posit16 gradient wire.

On the smoke configs at float32 (mamba2; recurrentgemma at 4 layers: one
period of (rec, rec, attn) and a recurrent tail; qwen2-vl fed the
pipeline's patch embeddings; whisper fed its frames), ``MIXED_TC`` (P(8,2)
weights, P(16,2) embeddings and head, the P(16,2) gradient wire with
error feedback) and ``remat="dots"`` in both packages: the port's state
is the reference's ``init_train_state`` carried across by
``convert.train_state_from_numpy``, and both take two steps of
``make_train_step`` on the same ``SyntheticLM`` batches (bit-identical
inputs).  The reference's step is jitted once per family.  This file
holds the audio family; ``test_torch_train_{hybrid,ssm,vlm}.py`` hold
the others with these checks (``check_*``), one family a file, so that
the driver's ``--dist loadfile`` spreads the reference's compiles.

Tolerances (float32; AdamW's default schedule, lr 3e-6 then 6e-6):
losses within rtol 1e-5; every updated param and the f32 master within
1e-6 (a sixth of the second step's lr: an element whose gradient sums
to opposite signs in the two frameworks moves by less than that); the
step count equal; ``mu`` / ``nu`` within rtol 1e-4 of each leaf's largest
moment (the gradients' own tolerance in ``test_torch_train_step.py``);
the wire's residual, the quantization error of gradients the two
packages sum in different orders, within 2e-4 of each leaf's largest
|gradient|.  Both bar < 0.5 % of a leaf's values (one value on a leaf of
fewer than 200), where a wire code one posit step away moves the decoded
gradient by that step: there the residual within 2^-7 of the leaf's
largest gradient, as ``test_torch_compression.py`` holds it, and a
moment within 2^-6 of the leaf's largest.  A subnormal
gradient encodes to 0 in the reference's wire (XLA's CPU arithmetic
flushes it) and to +-minpos in the port's; the residual differs there by
far less than the tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.transprecision import MIXED_TC as JMIXED  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core.transprecision import MIXED_TC  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FAMILIES = {"ssm": ("mamba2-2.7b", {}),
            "hybrid": ("recurrentgemma-9b", {"n_layers": 4}),
            "vlm": ("qwen2-vl-2b", {}),
            "audio": ("whisper-large-v3", {})}
BATCH, SEQ, STEPS = 2, 32, 2
OPT = dict(total_steps=10)


def _np_tree(t):
    return jax.tree.map(lambda a: np.array(a), t)


def _np(x):
    return np.asarray(x.detach().to(torch.float32).numpy())


@functools.lru_cache(maxsize=None)
def _run(family):
    """Both packages' two steps from one state: per step the loss, and
    after the last the params, the AdamW state and the residual (numpy
    leaves in ``tree_leaves`` order), and the port's gradients of the
    last step (the residual's scale)."""
    arch, extra = FAMILIES[family]
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               dtype_name="float32", remat="dots", **extra)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               dtype_name="float32", remat="dots", **extra)
    jst = jax.jit(lambda k: jinit(k, jcfg, JAdamW(**OPT), JMIXED))(
        jax.random.PRNGKey(3))
    st = train_state_from_numpy(_np_tree(jst.params), device="cpu",
                                ef_residual=_np_tree(jst.ef_residual))
    jstep = jax.jit(jmake_step(jcfg, JAdamW(**OPT), JMIXED))
    step = make_train_step(tcfg, AdamWConfig(**OPT), MIXED_TC)
    jpipe = jmake_pipeline(jcfg, global_batch=BATCH, seq_len=SEQ)
    pipe = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ,
                         device="cpu")
    out = {"loss": [], "jloss": []}
    for s in range(STEPS):
        batch = pipe(s)
        assert set(batch) == set(jpipe(s))
        if s == STEPS - 1:
            leaves = tree_leaves(st.params)
            for p in leaves:
                p.requires_grad_(True)
            grads = torch.autograd.grad(
                lm.loss_fn(st.params, batch, tcfg, MIXED_TC)[0], leaves)
            for p in leaves:
                p.requires_grad_(False)
            out["grads"] = [_np(g) for g in grads]
        st, m = step(st, batch)
        jst, jm = jstep(jst, jpipe(s))
        out["loss"].append(float(m["loss"]))
        out["jloss"].append(float(jm["loss"]))
    for name, got, want in (
            ("params", st.params, jst.params),
            ("master", st.opt["master"], jst.opt["master"]),
            ("mu", st.opt["mu"], jst.opt["mu"]),
            ("nu", st.opt["nu"], jst.opt["nu"]),
            ("residual", st.ef_residual, jst.ef_residual)):
        out[name] = ([_np(t) for t in tree_leaves(got)],
                     [np.asarray(a, np.float32)
                      for a in jax.tree_util.tree_leaves(want)])
    out["step"] = (int(st.opt["step"]), int(jst.opt["step"]))
    return out


def check_losses(family):
    r = _run(family)
    np.testing.assert_allclose(r["loss"], r["jloss"], rtol=1e-5)
    assert all(np.isfinite(r["loss"]))
    assert r["step"] == (STEPS, STEPS)


def check_params_and_master(family):
    r = _run(family)
    for name in ("params", "master"):
        got, want = r[name]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _few_apart(d, tol, cap, name):
    """Every |difference| ``d`` within ``cap``, and within ``tol`` but on
    < 0.5 % of the leaf's values (one value on a leaf of fewer than 200:
    the wire codes one posit step apart)."""
    far = int((d > tol).sum())
    assert far <= max(1, 5e-3 * d.size), (name, far, d.size)
    assert d.max() <= cap, (name, float(d.max()), cap)


def check_moments(family):
    """``mu`` / ``nu`` within rtol 1e-4 of each leaf's largest moment, bar
    the values where a wire code one posit step apart moved the decoded
    gradient (at most 2^-6 of that moment)."""
    r = _run(family)
    for name in ("mu", "nu"):
        for g, w in zip(*r[name]):
            scale = float(np.abs(w).max())
            _few_apart(np.abs(g - w), 1e-4 * (np.abs(w) + scale),
                       2.0 ** -6 * scale, name)


def check_wire_residual(family):
    r = _run(family)
    got, want = r["residual"]
    assert any(np.abs(g).max() > 0 for g in got)
    for g, w, grad in zip(got, want, r["grads"]):
        gmax = float(np.abs(grad).max())
        _few_apart(np.abs(g - w), 2e-4 * gmax, 2.0 ** -7 * gmax, "residual")


HERE = ["audio"]


@pytest.mark.parametrize("family", HERE)
def test_losses_equal_reference(family):
    check_losses(family)


@pytest.mark.parametrize("family", HERE)
def test_params_and_master_equal_reference(family):
    check_params_and_master(family)


@pytest.mark.parametrize("family", HERE)
def test_moments_equal_reference(family):
    check_moments(family)


@pytest.mark.parametrize("family", HERE)
def test_wire_residual_equals_reference(family):
    check_wire_residual(family)
