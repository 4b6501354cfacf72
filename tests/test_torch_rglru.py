"""The port's RG-LRU (``repro_torch.models.rglru``), its local attention
and the hybrid family's model (``repro_torch.models.lm``) against the
reference's, on the recurrentgemma smoke config, from the same seeded
numpy inputs and weights.

Tolerances: the RG-LRU pieces at float32 atol 1e-6 (the two scans
compose the same affine maps in another tree order); attention and the
model's logits at float32 rtol 1e-5, atol 1e-5; bf16 logits within 1/32
of the reference's largest magnitude.  The gate biases, ``Lambda`` and
the norm gains are seeded random values: the init's zeros would leave
them untested.  The model runs at smoke depth (4 layers: one period and
one tail block) and at 8 layers (two periods, two tail blocks), with
prompts shorter and longer than the 16-token window.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trglru  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "recurrentgemma-9b"
_J_GATES = jax.jit(jrglru._gates)
_J_RGLRU = jax.jit(jrglru.rglru)
_J_STEP = jax.jit(jrglru.rglru_step)
_J_INIT = jax.jit(jlm.init_params, static_argnums=(1,))
_J_FORWARD = jax.jit(jlm.forward, static_argnums=(2,))
_J_LOSS = jax.jit(jlm.loss_fn, static_argnums=(2,))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _randomize(tree, rng):
    """The reference's params with the gate biases and norm gains in
    [-0.5, 0.5) and ``Lambda`` in [-9, -4) (the init's range), seeded."""
    ranges = {"b_a": (-0.5, 0.5), "b_x": (-0.5, 0.5), "ln": (-0.5, 0.5),
              "ln2": (-0.5, 0.5), "final_norm": (-0.5, 0.5),
              "Lambda": (-9.0, -4.0)}

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v, name) for v in node)
        if name in ranges:
            return jnp.asarray(rng.uniform(*ranges[name], node.shape),
                               jnp.float32)
        return node
    return walk(tree)


def hybrid_pair(dtype_name="float32", seed=0, **kw):
    """(jax cfg, torch cfg, jax params, torch params) of recurrentgemma
    smoke at ``dtype_name`` (``kw`` replaces config fields on both), the
    f32 vector leaves seeded random."""
    jc = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                             dtype_name=dtype_name, **kw)
    tc = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                             dtype_name=dtype_name, **kw)
    jp = _randomize(_J_INIT(jax.random.PRNGKey(seed), jc),
                    np.random.default_rng(seed + 1))
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    return jc, tc, jp, tp


MODELS = (("float32", 4), ("float32", 8), ("bfloat16", 4))


@pytest.fixture(scope="module")
def models():
    """hybrid_pair at float32 at smoke depth and at 8 layers, and at bf16
    at smoke depth."""
    return {(d, n): hybrid_pair(d, n_layers=n) for d, n in MODELS}


def _rglru_params(rng, width):
    """One RG-LRU's leaves at float32, numpy, with random biases."""
    return {"w_a": rng.standard_normal((width, width)) / np.sqrt(width),
            "b_a": rng.uniform(-1, 1, width),
            "w_x": rng.standard_normal((width, width)) / np.sqrt(width),
            "b_x": rng.uniform(-1, 1, width),
            "Lambda": np.log(np.expm1(-np.log(rng.uniform(
                0.9, 0.999, width)) / trglru.C_FACTOR))}


def _both(tree):
    j = {k: jnp.asarray(v, jnp.float32) for k, v in tree.items()}
    t = {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
         tree.items()}
    return j, t


# ---- the RG-LRU ----

def test_gates_equal_reference():
    rng = np.random.default_rng(0)
    pj, pt = _both(_rglru_params(rng, 24))
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    aj, gj = _J_GATES(pj, jnp.asarray(x))
    at, gt = trglru._gates(pt, torch.from_numpy(x))
    assert at.dtype == gt.dtype == torch.float32
    np.testing.assert_allclose(_np(at), _np(aj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(gt), _np(gj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 7, 16, 33, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_equals_reference(s, with_h0):
    rng = np.random.default_rng(s)
    pj, pt = _both(_rglru_params(rng, 16))
    x = rng.standard_normal((3, s, 16)).astype(np.float32)
    h0 = rng.standard_normal((3, 16)).astype(np.float32) if with_h0 \
        else None
    yj, hj = _J_RGLRU(pj, jnp.asarray(x),
                      None if h0 is None else jnp.asarray(h0))
    yt, ht = trglru.rglru(pt, torch.from_numpy(x),
                          None if h0 is None else torch.from_numpy(h0))
    assert ht.dtype == torch.float32 and yt.dtype == torch.float32
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=1e-6)


def test_rglru_step_equals_reference_and_continues_the_scan():
    rng = np.random.default_rng(4)
    pj, pt = _both(_rglru_params(rng, 16))
    x = rng.standard_normal((2, 6, 16)).astype(np.float32)
    h = rng.standard_normal((2, 16)).astype(np.float32)
    yj, hj = _J_STEP(pj, jnp.asarray(x[:, :1]), jnp.asarray(h))
    ht_in = torch.from_numpy(h)
    before = ht_in.clone()
    yt, ht = trglru.rglru_step(pt, torch.from_numpy(x[:, :1]), ht_in)
    assert torch.equal(ht_in, before)           # the state only read
    np.testing.assert_allclose(_np(yt), _np(yj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(ht), _np(hj), rtol=0, atol=1e-6)
    # steps from h equal the scan from h0 = h
    hs = ht_in
    for t in range(x.shape[1]):
        _, hs = trglru.rglru_step(pt, torch.from_numpy(x[:, t:t + 1]), hs)
    _, hl = trglru.rglru(pt, torch.from_numpy(x), ht_in)
    torch.testing.assert_close(hs, hl, rtol=0, atol=1e-6)


@pytest.mark.parametrize("s", [1, 5, 64, 3000])
def test_doubling_scan_equals_a_sequential_loop(s):
    """The doubling scan against h_t = a_t h_{t-1} + b_t in a float64
    loop; at 3000 tokens of a in [0.9, 0.999] (the init's decay range),
    where a closed form through exp(-cumsum(log a)) overflows f32."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.9, 0.999, (2, s, 8))
    b = rng.standard_normal((2, s, 8))
    h, want = np.zeros((2, 8)), np.empty((2, s, 8))
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    got = trglru.scan(torch.from_numpy(a).float(), torch.from_numpy(b).float())
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


# ---- local attention ----

@pytest.mark.parametrize("s,window,qb,kvb", [(40, 16, 8, 8), (40, 16, 16, 32),
                                            (33, 5, 8, 16), (24, 64, 8, 8)])
def test_window_attention_equals_reference(s, window, qb, kvb):
    """Windows shorter and longer than the sequence, with blocks that a
    window masks whole (the online softmax's first tiles all masked)."""
    rng = np.random.default_rng(s + window)
    q = rng.standard_normal((2, s, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, s, 1, 8)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 8)).astype(np.float32)
    j = jattn.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), window=window,
                                  q_block=qb, kv_block=kvb)
    t = tattn.blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window=window,
                                  q_block=qb, kv_block=kvb)
    np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5, atol=1e-5)
    dj = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), window=window)
    dt = tattn.dense_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), window=window)
    np.testing.assert_allclose(_np(dt), _np(dj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(t), _np(dt), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [5, 16])
def test_flash_backward_applies_the_window(window):
    """``_Flash``'s backward against autograd through the forward loop
    (``vjp="naive"``), and against the reference's custom VJP."""
    rng = np.random.default_rng(window)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 40, 4, 8), (2, 40, 2, 8), (2, 40, 2, 8))]
    g = rng.standard_normal((2, 40, 4, 8)).astype(np.float32)
    grads = {}
    for vjp in ("flash", "naive"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
        out = tattn.blockwise_attention(*ts, window=window, q_block=8,
                                        kv_block=16, vjp=vjp)
        out.backward(torch.from_numpy(g))
        grads[vjp] = [t.grad for t in ts]
    for a, b in zip(grads["flash"], grads["naive"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    def f(q, k, v):
        return jnp.vdot(jattn.blockwise_attention(
            q, k, v, window=window, q_block=8, kv_block=16), jnp.asarray(g))
    jg = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays))
    for a, b in zip(grads["flash"], jg):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)


# ---- the model ----

def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("n_layers", [4, 8])
def test_init_params_tree_equals_reference(n_layers):
    """Per-period-position ``blocks`` stacked over the periods and an
    unstacked ``tail``, leaf for leaf (names, shapes, dtypes)."""
    jc = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                             n_layers=n_layers)
    tc = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                             n_layers=n_layers)
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jl = _leaves(jlm.init_params(jax.random.PRNGKey(0), jc, abstract=True))
    assert _leaves(tp) == jl
    assert sum(int(np.prod(s)) for s, _ in jl.values()) \
        == tc.param_count() == jc.param_count()
    assert len(tp["blocks"]) == 3 and len(tp["tail"]) == tc.n_tail
    for k in ("block_types", "period", "n_periods", "n_tail"):
        assert getattr(tc, k) == getattr(jc, k), k
    # Lambda drawn so that a^c lies in [0.9, 0.999]
    lam = tp["blocks"][0]["rglru"]["Lambda"]
    a_c = torch.exp(-trglru.C_FACTOR * torch.nn.functional.softplus(lam))
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999


def test_param_count_full_width():
    t = tconfigs.get_config(ARCH)
    assert t.param_count() == jconfigs.get_config(ARCH).param_count() \
        == 7_483_699_200
    assert (t.block_types.count("attn"), t.n_periods, t.n_tail) == (12, 12,
                                                                    2)


def test_layer_block_finds_period_and_tail_layers(models):
    _, tc, _, tp = models[("float32", 8)]
    for i, want in enumerate(tc.block_types):
        btype, p = tlm.layer_block(tp, tc, i)
        assert btype == want
        if i < 6:
            blk = tp["blocks"][i % 3]
            assert torch.equal(p["ln"], blk["ln"][i // 3])
        else:
            assert p is tp["tail"][i - 6]


@pytest.mark.parametrize("dtype_name,n_layers", MODELS)
@pytest.mark.parametrize("s", [12, 40])
def test_forward_and_loss_equal_reference(models, n_layers, dtype_name, s):
    jc, tc, jp, tp = models[(dtype_name, n_layers)]
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, tc.vocab, (2, s))
    labels = rng.integers(-1, tc.vocab, (2, s))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    (jl, _), (tl, taux) = _J_FORWARD(jp, jb, jc), tlm.forward(tp, tb, tc)
    assert float(taux) == 0.0
    (jloss, _), (tloss, _) = _J_LOSS(jp, jb, jc), tlm.loss_fn(tp, tb, tc)
    if dtype_name == "float32":
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    else:
        np.testing.assert_allclose(_np(tl), _np(jl), rtol=0,
                                   atol=np.abs(_np(jl)).max() / 32)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-2)


def test_remat_modes(models):
    """"full", "dots" and "none" give the same loss bit for bit and every
    gradient (the tail's included) within 1e-6 of "full"'s."""
    _, tc, _, tp = models[("float32", 4)]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, tc.vocab, (2, 20))),
             "labels": torch.from_numpy(rng.integers(0, tc.vocab, (2, 20)))}
    runs = {}
    for remat in ("full", "dots", "none"):
        params = params_from_numpy(jax_params_to_numpy(
            models[("float32", 4)][2]), "cpu", tc.dtype)
        leaves = []

        def grad_on(node):
            if isinstance(node, dict):
                return {k: grad_on(v) for k, v in node.items()}
            if isinstance(node, (tuple, list)):
                return type(node)(grad_on(v) for v in node)
            node.requires_grad_(True)
            leaves.append(node)
            return node
        params = grad_on(params)
        loss, _ = tlm.loss_fn(params, batch,
                              dataclasses.replace(tc, remat=remat))
        loss.backward()
        runs[remat] = (float(loss.detach()), [t.grad for t in leaves])
    assert any(t.grad is not None for t in leaves)
    for remat in ("dots", "none"):
        assert runs[remat][0] == runs["full"][0], remat
        for a, b in zip(runs[remat][1], runs["full"][1]):
            assert a is not None and torch.isfinite(a).all()
            torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-7)


def test_bf16_bridge_keeps_the_f32_leaves():
    """A bf16 conversion keeps b_a, b_x, Lambda and the norm gains
    bit-equal to the reference's float32 and rounds the weights (the
    conv taps among them), the tail's as the periods'."""
    jc, tc, jp, tp = hybrid_pair("bfloat16")
    for part in ("blocks", "tail"):
        rec_j, rec_t = jp[part][0], tp[part][0]
        for k in ("b_a", "b_x", "Lambda"):
            t = rec_t["rglru"][k]
            assert t.dtype == torch.float32, (part, k)
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(rec_j["rglru"][k]))
        for k in ("ln", "ln2"):
            assert rec_t[k].dtype == torch.float32
        for k in ("wx", "wy", "conv_w", "w_out", "wi", "wo_mlp"):
            assert rec_t[k].dtype == torch.bfloat16, (part, k)
        for k in ("w_a", "w_x"):
            assert rec_t["rglru"][k].dtype == torch.bfloat16, (part, k)
    assert tp["blocks"][2]["wq"].dtype == torch.bfloat16
