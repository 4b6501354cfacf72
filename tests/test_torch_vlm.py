"""The vlm family (qwen2-vl smoke: M-RoPE, tied embeddings, patch-
embedding prompts) in the port against the reference, from the same
seeded numpy inputs and weights.

* ``mrope_freqs`` with three distinct position streams, at the smoke's
  head dim (sections (4, 6, 6)) and the full config's (128: (16, 24, 24),
  theta 1e6), within 1e-6 of the reference's: torch's and XLA's ``cos``
  (and ``pow`` at theta 1e6) differ in the last bit on a few per cent of
  the angles, so the tables cannot be equal bit for bit (the 1-D RoPE
  tables of the two packages differ alike).  Within the port, bit for
  bit: each section is 1-D RoPE of its own stream, equal streams give
  1-D RoPE's table, and ``_rope_cs`` splits the half as the reference.
* The pipeline's vlm batch (``embeds`` from ``default_rng(seed + 7 +
  step)``, no ``tokens``) equals the reference's bit for bit.
* ``forward`` and ``loss_fn`` over tokens and over ``embeds``: float32
  within rtol 1e-5, atol 1e-5 of the reference's logits and loss; bf16
  within 1/32 of the largest logit.  Remat "full", "none" and "dots"
  give the same loss and gradients.
* The speculative engine serves vlm (gamma 2, ring, posit8 KV): its
  greedy streams equal the port's baseline engine's and the reference's
  speculative engine's on the dense twin of the config (``family``
  "dense", no M-RoPE: with the stub frontend the three streams are equal
  and M-RoPE is 1-D RoPE), while the reference's speculative engine on the
  vlm config itself fails at its first admission (its draft prefill
  passes lengths to an engine that prefills at exact length).

The reference's forward and loss are jitted once per module.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.pipeline import make_pipeline as j_make_pipeline  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.data.pipeline import make_pipeline  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.serve import (Request, ServeConfig, ServingEngine,  # noqa: E402
                               SpeculativeEngine)
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "qwen2-vl-2b"
POLICY = "paper_edge_p8"
_J_INIT = jax.jit(jlm.init_params, static_argnums=(1,))
_J_FORWARD = jax.jit(jlm.forward, static_argnums=(2,))
_J_LOSS = jax.jit(jlm.loss_fn, static_argnums=(2,))
# the norm gains, seeded random (the init's zeros would leave them untested)
GAINS = ("ln", "ln2", "final_norm", "ln_x", "enc_norm")


def randomize_gains(tree, rng):
    """The reference's params with every norm gain in [-0.5, 0.5)."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, name) for v in node)
        if name in GAINS:
            return jnp.asarray(rng.uniform(-0.5, 0.5, node.shape),
                               jnp.float32)
        return node
    return walk(tree)


def family_pair(arch, dtype_name="float32", seed=0, **kw):
    """(jax cfg, torch cfg, jax params, torch params) of ``arch``'s smoke
    config at ``dtype_name`` (``kw`` replaces fields on both), the norm
    gains seeded random."""
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             dtype_name=dtype_name, **kw)
    tc = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                             dtype_name=dtype_name, **kw)
    jp = randomize_gains(_J_INIT(jax.random.PRNGKey(seed), jc),
                         np.random.default_rng(seed + 1))
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    return jc, tc, jp, tp


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _sections(hd):
    half = hd // 2
    return (half - 2 * ((half // 8) * 3), (half // 8) * 3, (half // 8) * 3)


@pytest.mark.parametrize("hd,theta", [(32, 10000.0), (128, 1e6)])
def test_mrope_freqs_matches_reference(hd, theta):
    pos = np.random.default_rng(hd).integers(0, 8192, (3, 2, 40))
    sec = _sections(hd)
    want = jcommon.mrope_freqs(hd, theta, jnp.asarray(pos, jnp.int32), sec)
    got = tcommon.mrope_freqs(hd, theta, torch.from_numpy(pos), sec)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == (2, 40, hd // 2)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("hd,theta", [(32, 10000.0), (128, 1e6)])
def test_mrope_sections_are_rope_of_their_streams(hd, theta):
    """Bit for bit in the port: section i of M-RoPE is 1-D RoPE's table of
    stream i in those columns; equal streams give 1-D RoPE's table; the
    model's ``_rope_cs`` splits the half as (h - 6(h//8), 3(h//8),
    3(h//8)) and broadcasts a (B, S) position to the three streams."""
    pos = torch.from_numpy(np.random.default_rng(1).integers(0, 8192,
                                                             (3, 2, 40)))
    sec = _sections(hd)
    cos, sin = tcommon.mrope_freqs(hd, theta, pos, sec)
    off = 0
    for i, n in enumerate(sec):
        rc, rs = tcommon.rope_freqs(hd, theta, pos[i])
        assert torch.equal(cos[..., off:off + n], rc[..., off:off + n])
        assert torch.equal(sin[..., off:off + n], rs[..., off:off + n])
        off += n
    cfg = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                              d_head=hd, rope_theta=theta)
    for a, b in zip(tlm._rope_cs(cfg, pos[0]),
                    tcommon.rope_freqs(hd, theta, pos[0])):
        assert torch.equal(a, b)
    for a, b in zip(tlm._rope_cs(cfg, pos), (cos, sin)):
        assert torch.equal(a, b)
    assert sec == ((4, 6, 6) if hd == 32 else (16, 24, 24))


def test_pipeline_embeds_equal_reference():
    tc = tconfigs.get_config(ARCH, smoke=True)
    jc = jconfigs.get_config(ARCH, smoke=True)
    tpipe = make_pipeline(tc, global_batch=2, seq_len=8, seed=3,
                          device="cpu")
    jpipe = j_make_pipeline(jc, global_batch=2, seq_len=8, seed=3)
    for step in (0, 5):
        got, want = tpipe.global_batch(step), jpipe.global_batch(step)
        assert set(got) == set(want) == {"embeds", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    batch = tpipe(1)
    assert batch["embeds"].dtype == torch.float32
    assert tuple(batch["embeds"].shape) == (2, 8, tc.d_model)
    assert batch["labels"].dtype == torch.int64


@pytest.fixture(scope="module")
def models():
    return {d: family_pair(ARCH, d) for d in ("float32", "bfloat16")}


def _batch(cfg, inputs, seed=0, b=2, s=12):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[0, -2:] = -1
    batch = {"labels": labels}
    if inputs == "embeds":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    return batch


def _to_torch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                                else v) for k, v in batch.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inputs", ["tokens", "embeds"])
def test_forward_and_loss_match_reference(models, dtype, inputs):
    jc, tc, jp, tp = models[dtype]
    batch = _batch(tc, inputs)
    jl, _ = _J_FORWARD(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc)
    jloss, _ = _J_LOSS(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jc)
    with torch.no_grad():
        tl, aux = tlm.forward(tp, _to_torch(batch), tc)
        tloss, parts = tlm.loss_fn(tp, _to_torch(batch), tc)
    assert float(aux) == 0.0
    want = _np(jl)
    if dtype == "float32":
        np.testing.assert_allclose(_np(tl), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(tl), want, rtol=0,
                                   atol=np.abs(want).max() / 32)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_remat_modes_agree(models):
    """Loss and every gradient equal under remat "full", "none" and
    "dots" (the vlm blocks are dense attention blocks), from embeds."""
    _, tc, _, tp = models["float32"]
    batch = _to_torch(_batch(tc, "embeds", seed=2))
    out = {}
    for remat in ("full", "none", "dots"):
        cfg = dataclasses.replace(tc, remat=remat)
        params = jax.tree_util.tree_map(
            lambda t: t.detach().clone().requires_grad_(
                t.is_floating_point()), tp)
        loss, _ = tlm.loss_fn(params, batch, cfg)
        loss.backward()
        out[remat] = (float(loss.detach()), [t.grad for t in
                                    jax.tree_util.tree_leaves(params)])
    for remat in ("none", "dots"):
        assert out[remat][0] == out["full"][0]
        for a, b in zip(out[remat][1], out["full"][1]):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_speculative_serves_vlm(models):
    _, tc, jp, tp = models["float32"]
    rng = np.random.default_rng(0)
    # one prompt length (the reference compiles a prefill per length); the
    # third request joins mid-run, at other positions than the first two
    prompts = [rng.integers(0, tc.vocab, 7) for _ in range(3)]
    kw = dict(max_batch=2, max_len=64, kv_format="posit8")
    streams = {}
    for name, cls, extra in (("spec", SpeculativeEngine, {"gamma": 2}),
                             ("base", ServingEngine, {})):
        eng = cls(tc, tp, ServeConfig(**kw), policy=POLICY, device="cpu",
                  **extra)
        assert not eng.engine.bucketed
        reqs = [Request(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        assert all(r.done and r.error is None for r in reqs)
        streams[name] = [r.out_tokens for r in reqs]
    assert streams["spec"] == streams["base"]
    jc = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                             dtype_name="float32")
    twin = dataclasses.replace(jc, family="dense", mrope=False)
    jreqs = [JRequest(uid=i, prompt=p, max_new=6)
             for i, p in enumerate(prompts)]
    JSpeculative(twin, jp, JServeConfig(**kw), policy=POLICY,
                 gamma=2).serve(jreqs)
    assert streams["spec"] == [r.out_tokens for r in jreqs]
    with pytest.raises(ValueError, match="exact length only"):
        JSpeculative(jc, jp, JServeConfig(**kw), policy=POLICY,
                     gamma=2).serve([JRequest(uid=0, prompt=prompts[0],
                                              max_new=2)])
