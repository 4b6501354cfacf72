"""Transprecision training of the PyTorch port vs the JAX package.

Smoke-size paper-edge (2 layers, d_model 64, 4/2 heads, vocab 256) at
float32 under PAPER_EDGE (every weight fake-quantized through P(8,2),
embeddings and head through P(16,2)), with 16-query / 32-key attention
blocks so the flash backward walks several tiles.  Both packages start
from the reference's params (converted) and draw the same SyntheticLM
batches (bit-identical tokens and labels).

Tolerances (float32): loss within 1e-5; every gradient leaf within rtol
1e-4 and an atol of 1e-4 x the leaf's largest |gradient| (f32 summation
order: single elements near zero carry no relative precision); after one
step, params and the f32 master within 1e-6 (a third of the step-1
update, lr x 1 = 3e-6), ``mu``/``nu`` within rtol 1e-4 of their scale,
and the metrics within rtol 1e-5; three steps' losses within rtol 1e-4.
bf16 rounds at other places in the two frameworks (XLA keeps fused
elementwise chains in f32), so bf16 is held to the reference's bf16 by
loss, within 2e-3 absolute, never to float32.  The cross entropy,
attention, schedule and AdamW cases and the bf16 losses are in
``test_torch_train_step_parts.py``, on this file's helpers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.transprecision import PAPER_EDGE as JPAPER_EDGE  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_from_numpy  # noqa: E402
from repro_torch.core.transprecision import PAPER_EDGE  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

BATCH, SEQ, STEPS = 4, 64, 3
BLOCKS = dict(q_block=16, kv_block=32)


def _cfgs(dtype_name):
    j = dataclasses.replace(jget_config("paper-edge", smoke=True),
                            dtype_name=dtype_name, **BLOCKS)
    t = dataclasses.replace(get_config("paper-edge", smoke=True),
                            dtype_name=dtype_name, **BLOCKS)
    return j, t


def _np_tree(t):
    """The reference's pytree as numpy; bf16 leaves widen to f32 (exact)."""
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return type(t)(_np_tree(v) for v in t)
    return np.array(t, np.float32) if t.dtype == jnp.bfloat16 \
        else np.array(t)


def _np(x):
    return np.asarray(x.detach().to(torch.float32).numpy())


def _port_grads(params, batch, cfg, policy=PAPER_EDGE):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = lm.loss_fn(params, batch, cfg, policy)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), [_np(g) for g in grads]


def _close_to_scale(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def ref32():
    """The reference at float32: step-0 loss and grads, the state after
    one step, and the losses of three steps (one jit of each)."""
    jcfg, _ = _cfgs("float32")
    state = jinit(jax.random.PRNGKey(0), jcfg,
                  jadamw.AdamWConfig(total_steps=10), JPAPER_EDGE)
    pipe = jmake_pipeline(jcfg, global_batch=BATCH, seq_len=SEQ)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(p, b, jcfg, JPAPER_EDGE), has_aux=True))(
            state.params, pipe(0))
    init = _np_tree(state.params)
    step = jax.jit(jmake_step(jcfg, jadamw.AdamWConfig(total_steps=10),
                              JPAPER_EDGE))
    metrics, after1 = [], None
    for s in range(STEPS):
        state, m = step(state, pipe(s))
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        if s == 0:
            after1 = {"params": _np_tree(state.params),
                      **{k: _np_tree(state.opt[k])
                         for k in ("mu", "nu", "master")}}
    return {"init": init, "loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)],
            "after1": after1, "metrics": metrics}


def _port_state(tree, dtype=torch.float32):
    return train_state_from_numpy(tree, device="cpu", dtype=dtype)


def test_batches_bit_identical():
    jcfg, tcfg = _cfgs("float32")
    for seed, step in ((0, 0), (0, 5), (3, 2)):
        jb = jmake_pipeline(jcfg, global_batch=BATCH, seq_len=SEQ,
                            seed=seed)(step)
        tb = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ, seed=seed,
                           device="cpu")(step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_loss_and_grads_vs_jax(ref32):
    _, tcfg = _cfgs("float32")
    st = _port_state(ref32["init"])
    batch = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ,
                          device="cpu")(0)
    loss, grads = _port_grads(st.params, batch, tcfg)
    assert abs(loss - ref32["loss"]) <= 1e-5, (loss, ref32["loss"])
    assert len(grads) == len(ref32["grads"]) == 11
    for g, want in zip(grads, ref32["grads"]):
        assert g.shape == want.shape
        _close_to_scale(g, want, 1e-4)


@pytest.mark.parametrize("field,value", [("attn_vjp", "naive"),
                                         ("remat", "none"),
                                         ("remat", "dots")])
def test_grads_equal_across_vjp_and_remat(ref32, field, value):
    """Flash vs naive attention gradients (rtol 1e-5 of each leaf's scale:
    two summation orders of the same f32 math) and remat full vs none and
    vs dots (bit-identical: the checkpoint recomputes the same ops, and
    "dots" reuses the weight products it saved)."""
    _, tcfg = _cfgs("float32")
    batch = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ,
                          device="cpu")(0)
    params = _port_state(ref32["init"]).params
    base = _port_grads(params, batch, tcfg)
    other = _port_grads(params, batch,
                        dataclasses.replace(tcfg, **{field: value}))
    assert abs(base[0] - other[0]) <= 1e-6
    for a, b in zip(base[1], other[1]):
        if field == "remat":
            np.testing.assert_array_equal(a, b)
        else:
            _close_to_scale(a, b, 1e-5)


def test_one_step_state_and_metrics_vs_jax(ref32):
    _, tcfg = _cfgs("float32")
    st = _port_state(ref32["init"])
    step = make_train_step(tcfg, tadamw.AdamWConfig(total_steps=10),
                           PAPER_EDGE)
    pipe = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ, device="cpu")
    st, m = step(st, pipe(0))
    want = ref32["metrics"][0]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), want[k], rtol=1e-5)
    assert int(st.opt["step"]) == 1
    got = {"params": st.params, **{k: st.opt[k]
                                   for k in ("mu", "nu", "master")}}
    for name, tree in got.items():
        for g, w in zip(tree_leaves(tree), jax.tree_util.tree_leaves(
                ref32["after1"][name])):
            g = _np(g)
            if name in ("params", "master"):
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
            else:
                _close_to_scale(g, w, 1e-4)
    # the master is a copy, never the param itself
    for p, mst in zip(tree_leaves(st.params), tree_leaves(st.opt["master"])):
        assert p.data_ptr() != mst.data_ptr()


def test_three_step_losses_vs_jax(ref32):
    _, tcfg = _cfgs("float32")
    st = _port_state(ref32["init"])
    step = make_train_step(tcfg, tadamw.AdamWConfig(total_steps=10),
                           PAPER_EDGE)
    pipe = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ, device="cpu")
    for s in range(STEPS):
        st, m = step(st, pipe(s))
        want = ref32["metrics"][s]
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=1e-4)
        np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)


def test_later_slice_options_raise():
    with pytest.raises(ValueError, match="vjp"):
        tattn.blockwise_attention(torch.zeros(1, 4, 2, 8),
                                  torch.zeros(1, 4, 2, 8),
                                  torch.zeros(1, 4, 2, 8), vjp="fast")


def test_adamw_update_in_chunks_equals_whole(monkeypatch):
    """``adamw_update`` takes a leaf ``_CHUNK`` elements at a time and
    clips each slice as it reads it: params and state bit-equal to the
    whole-leaf update, for a bf16 and an f32 leaf and a non-contiguous
    gradient."""
    rng = np.random.default_rng(7)
    tree = {"w": rng.normal(0, 1, (37, 29)).astype(np.float32),
            "b": rng.normal(0, 1, (53,)).astype(np.float32)}
    grads = {"w": torch.from_numpy(rng.normal(0, 3, (29, 37)).astype(
        np.float32)).T, "b": torch.from_numpy(rng.normal(0, 3, (53,)).astype(
            np.float32))}
    out = []
    for chunk in (1 << 26, 100):
        monkeypatch.setattr(tadamw, "_CHUNK", chunk)
        params = {"w": torch.from_numpy(tree["w"]).to(torch.bfloat16),
                  "b": torch.from_numpy(tree["b"]).clone()}
        state = tadamw.adamw_init(params)
        for _ in range(2):
            m = tadamw.adamw_update(grads, state, params,
                                    tadamw.AdamWConfig(warmup_steps=1))
        out.append((params, state, m))
    (p0, s0, m0), (p1, s1, m1) = out
    for a, b in zip(tree_leaves([p0, s0, m0]), tree_leaves([p1, s1, m1])):
        assert torch.equal(a, b)
