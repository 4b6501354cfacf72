"""The gradient wire of the PyTorch port against the JAX package's, split
from ``tests/test_torch_compression.py`` (its helpers and tolerances) so
that the driver's ``--dist loadfile`` spreads the reference's compiles:
the int8 wire, and one wire step from a mid-training state against the
reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_compression import (  # noqa: E402,F401
    _grads, _ref_leaves, _t, _tree)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_int8_wire_matches_the_reference():
    """Codes, scales and residuals bit-exact against the eager reference
    (jitted, XLA rewrites x / s and the codes move), but at the planted
    subnormals: their codes are 0 in both, and the residual keeps the
    subnormal in the port, where XLA's flushed operand gives 0."""
    g = _grads(4)
    tw, tr = tcomp.compress_grads(_t(_tree(g)), "int8")
    jw, jr = jcomp.compress_grads(_tree([jnp.asarray(x) for x in g]), "int8")
    for i, (t, j, a, b) in enumerate(zip(
            tree_leaves(tw), _ref_leaves(jw), tree_leaves(tr),
            jax.tree_util.tree_leaves(jr))):
        np.testing.assert_array_equal(t.data.numpy(), np.asarray(j.data))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
        a, b = a.numpy().reshape(-1), np.array(b).reshape(-1)
        if i == 1:
            np.testing.assert_array_equal(a[1:5], g[1].reshape(-1)[1:5])
            np.testing.assert_array_equal(b[1:5], 0.0)
            a[1:5] = b[1:5] = 0.0
        np.testing.assert_array_equal(a, b)


def test_wire_step_from_a_mid_training_state_vs_jax():
    """The reference's whole train state after two MIXED_TC steps at
    float32 (params, AdamW step / moments / master, a nonzero residual)
    converted with ``train_state_from_numpy``; one more step in each
    package: the loss within rtol 1e-5, params and master within 1e-6 (a
    wire code one posit step apart, where the reference's scale is
    inexact, moves an update by ~lr x 2^-12), the step count equal, and
    the new residual, the quantization error of gradients the two
    packages sum in different orders, within 2e-4 of each leaf's largest
    |gradient| (the gradients' own rtol 1e-4 in
    ``test_torch_train_step.py``, twice: the error moves with them), but
    on < 0.5 % of the values, where a code one posit step away moves it
    by that step (at most 2^-7 of the leaf's largest |gradient|)."""
    from repro.configs import get_config as jget_config
    from repro.core.transprecision import MIXED_TC as JMIXED
    from repro.data.pipeline import make_pipeline as jmake_pipeline
    from repro.optim import AdamWConfig as JAdamW
    from repro.train.step import init_train_state as jinit
    from repro.train.step import make_train_step as jmake_step
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.core.transprecision import MIXED_TC
    from repro_torch.data.pipeline import make_pipeline

    def np_tree(t):
        return jax.tree.map(lambda a: np.array(a), t)

    jcfg = dataclasses.replace(jget_config("paper-edge", smoke=True),
                               dtype_name="float32")
    tcfg = dataclasses.replace(get_config("paper-edge", smoke=True),
                               dtype_name="float32")
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=1)
    jstep = jax.jit(jmake_step(jcfg, JAdamW(**opt), JMIXED))
    jpipe = jmake_pipeline(jcfg, global_batch=4, seq_len=32)
    jst = jinit(jax.random.PRNGKey(5), jcfg, JAdamW(**opt), JMIXED)
    for s in range(2):
        jst, _ = jstep(jst, jpipe(s))
    st = train_state_from_numpy(np_tree(jst.params), device="cpu",
                                opt=np_tree(jst.opt),
                                ef_residual=np_tree(jst.ef_residual))
    assert st.opt["step"].dtype == torch.int32 and int(st.opt["step"]) == 2
    assert any(r.abs().max() > 0 for r in tree_leaves(st.ef_residual))
    jst, jm = jstep(jst, jpipe(2))
    batch = make_pipeline(tcfg, global_batch=4, seq_len=32, device="cpu")(2)
    leaves = tree_leaves(st.params)
    for p in leaves:
        p.requires_grad_(True)
    grads = torch.autograd.grad(lm.loss_fn(st.params, batch, tcfg,
                                           MIXED_TC)[0], leaves)
    for p in leaves:
        p.requires_grad_(False)
    st, m = make_train_step(tcfg, AdamWConfig(**opt), MIXED_TC)(st, batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert int(st.opt["step"]) == int(jst.opt["step"]) == 3
    for got, want in ((st.params, jst.params),
                      (st.opt["master"], jst.opt["master"])):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    for r, w, g in zip(tree_leaves(st.ef_residual),
                       jax.tree_util.tree_leaves(jst.ef_residual), grads):
        gmax = float(g.abs().max())
        d = np.abs(r.numpy() - np.asarray(w))
        assert (d > 2e-4 * gmax).mean() < 5e-3, (d > 2e-4 * gmax).mean()
        assert d.max() <= 2.0 ** -7 * gmax, (d.max(), gmax)
