"""The train step's parts in the PyTorch port against the JAX package's
on paper-edge smoke: the cross entropy, attention and its flash backward
(causal and not, at two lengths), the LR schedules and the AdamW update,
and the bf16 losses against the reference's bf16; split from
``tests/test_torch_train_step.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.transprecision import PAPER_EDGE as JPAPER_EDGE  # noqa: E402
from repro.data.pipeline import make_pipeline as jmake_pipeline  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch.core.transprecision import PAPER_EDGE  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402
from test_torch_train_step import (  # noqa: E402,F401
    _cfgs, _np, _np_tree, _port_state, BATCH, BLOCKS, SEQ)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_cross_entropy_vs_jax():
    """Padded vocab masked, label -1 masked, logsumexp in f32."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 5, 256)).astype(np.float32)
    labels = rng.integers(0, 200, (2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    want = jcommon.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 200)
    got = tcommon.cross_entropy(torch.from_numpy(logits),
                                torch.from_numpy(labels), 200)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("s,causal", [(40, True), (64, True), (40, False)])
def test_attention_and_flash_backward_vs_jax(s, causal):
    """Forward of the blockwise path and the dense reference, and the
    flash backward's dq/dk/dv (GQA heads folded back, ragged length padded
    to the blocks) against ``jax.grad`` of the reference's."""
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (2, s, 4, 16)).astype(np.float32)
    k = rng.normal(0, 1, (2, s, 2, 16)).astype(np.float32)
    v = rng.normal(0, 1, (2, s, 2, 16)).astype(np.float32)
    w = rng.normal(0, 1, (2, s, 4, 16)).astype(np.float32)

    def jloss(q, k, v):
        out = jattn.blockwise_attention(q, k, v, causal=causal, **BLOCKS)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    jdense = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    for vjp in ("flash", "naive"):
        out = tattn.blockwise_attention(tq, tk, tv, causal=causal, vjp=vjp,
                                        **BLOCKS)
        tg = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                 (tq, tk, tv))
        np.testing.assert_allclose(_np(out), np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        for a, b in zip(tg, jg):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-4,
                                       atol=1e-5)
    dense = tattn.dense_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(dense), np.asarray(jdense), rtol=1e-5,
                               atol=1e-6)


def test_bf16_losses_vs_jax_bf16():
    jcfg, tcfg = _cfgs("bfloat16")
    opt = dict(total_steps=10)
    jst = jinit(jax.random.PRNGKey(1), jcfg, jadamw.AdamWConfig(**opt),
                JPAPER_EDGE)
    st = _port_state(_np_tree(jst.params), torch.bfloat16)
    assert st.params["blocks"][0]["wq"].dtype == torch.bfloat16
    assert st.opt["master"]["blocks"][0]["wq"].dtype == torch.float32
    jstep = jax.jit(jmake_step(jcfg, jadamw.AdamWConfig(**opt), JPAPER_EDGE))
    step = make_train_step(tcfg, tadamw.AdamWConfig(**opt), PAPER_EDGE)
    jpipe = jmake_pipeline(jcfg, global_batch=BATCH, seq_len=SEQ)
    pipe = make_pipeline(tcfg, global_batch=BATCH, seq_len=SEQ, device="cpu")
    for s in range(2):
        jst, jm = jstep(jst, jpipe(s))
        st, m = step(st, pipe(s))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 2e-3, s


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_and_adamw_update_vs_jax(schedule):
    """The schedule at warmup, mid-decay and past the end; one update of a
    tree holding a stacked (P, d) norm (decayed: ndim >= 2), a vector (not
    decayed) and a bf16 matrix with its f32 master."""
    cfg = dict(warmup_steps=3, total_steps=10, schedule=schedule,
               grad_clip=0.5)
    jsched = jadamw.make_schedule(jadamw.AdamWConfig(**cfg))
    tsched = tadamw.make_schedule(tadamw.AdamWConfig(**cfg))
    for s in (0, 1, 3, 6, 10, 12):
        np.testing.assert_allclose(float(tsched(s)),
                                   float(jsched(jnp.int32(s))), rtol=1e-6)
    rng = np.random.default_rng(2)
    tree = {"ln": rng.normal(0, 1, (2, 8)).astype(np.float32),
            "final_norm": rng.normal(0, 1, (8,)).astype(np.float32),
            "w": rng.normal(0, 1, (8, 4)).astype(np.float32)}
    grads = {k: rng.normal(0, 1, v.shape).astype(np.float32)
             for k, v in tree.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "w" else jnp.float32)
          for k, v in tree.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k == "w" else torch.float32) for k, v in jp.items()}
    jst = jadamw.adamw_init(jp)
    tst = tadamw.adamw_init(tp)
    for _ in range(2):
        jp, jst, jm = jadamw.adamw_update(
            {k: jnp.asarray(v) for k, v in grads.items()}, jst, jp,
            jadamw.AdamWConfig(**cfg))
        tm = tadamw.adamw_update({k: torch.from_numpy(v)
                                  for k, v in grads.items()}, tst, tp,
                                 tadamw.AdamWConfig(**cfg))
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    for k in tree:
        np.testing.assert_allclose(_np(tst["master"][k]),
                                   np.asarray(jst["master"][k]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(tp[k]), np.asarray(jp[k], np.float32),
                                   rtol=0, atol=1e-2 if k == "w" else 1e-6)
