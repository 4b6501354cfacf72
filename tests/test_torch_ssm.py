"""The port's Mamba-2 layer (``repro_torch.models.ssm``) and the SSM
family's model (``repro_torch.models.lm``) against the reference's, on the
mamba2 smoke config, from the same seeded numpy inputs and weights.

Tolerances: float32 rtol 1e-5, atol 1e-5 (the two packages' f32
arithmetic differs only in summation order); bf16 atol a fixed share of
the reference output's largest magnitude (1/64 for the SSD pieces, 1/32
for the model's logits: a few bf16 roundings, which the packages place
differently, e.g. ``silu``).  ``ssd_chunked`` runs at one chunk and at
several (the inter-chunk scan); the prefill of S - 1 tokens then one
decode step equals ``forward`` at S, as ``tests/test_archs.py`` holds the
reference."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "mamba2-2.7b"
# the reference's model functions, jitted once per module (cfg static)
_J_LAYER = jax.jit(jssm.mamba2_layer, static_argnums=(2,))
_J_SSD = jax.jit(jssm.ssd_chunked, static_argnums=(6,))
_J_FORWARD = jax.jit(jlm.forward, static_argnums=(2,))
_J_LOSS = jax.jit(jlm.loss_fn, static_argnums=(2,))
_J_PREFILL = jax.jit(jsm.prefill, static_argnums=(2, 3))
_J_DECODE = jax.jit(jsm.decode_step, static_argnums=(3,))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cfgs(dtype_name="float32", **kw):
    return (dataclasses.replace(jconfigs.get_config(ARCH, smoke=True),
                                dtype_name=dtype_name, **kw),
            dataclasses.replace(tconfigs.get_config(ARCH, smoke=True),
                                dtype_name=dtype_name, **kw))


def _pair(a, dtype_name):
    """One f32 numpy array as a reference array and a port tensor in the
    same dtype (bf16 rounds alike on both sides)."""
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(a, jd), torch.from_numpy(np.array(a)).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(t, j, dtype_name, share=1 / 64):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    if dtype_name == "float32":
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=share * np.abs(j).max())


@pytest.fixture(scope="module")
def model():
    """(jax cfg, torch cfg, jax params, torch params) per dtype."""
    out = {}
    for name in DTYPES:
        jc, tc = _cfgs(name)
        jp = jlm.init_params(jax.random.PRNGKey(0), jc)
        # random SSM scalars: the init's zeros / ones would hide the
        # A, D and dt_bias terms
        rng = np.random.default_rng(1)
        blk = dict(jp["blocks"][0])
        for k, lo, hi in (("A_log", -1.0, 1.0), ("D", 0.5, 1.5),
                          ("dt_bias", -1.0, 0.5), ("norm_scale", -0.2, 0.2),
                          ("ln", -0.2, 0.2)):
            blk[k] = jnp.asarray(rng.uniform(lo, hi, blk[k].shape),
                                 jnp.float32)
        jp = dict(jp, blocks=(blk,))
        tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
        out[name] = (jc, tc, jp, tp)
    return out


# ---- the layer's pieces ----

@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_causal_conv_both_modes(dtype_name):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((2, 7, 40)), dtype_name)
    wj, wt = _pair(rng.standard_normal((4, 40)) * 0.5, dtype_name)
    _close(tssm._causal_conv(xt, wt), jssm._causal_conv(xj, wj), dtype_name)
    sj, st = _pair(rng.standard_normal((2, 3, 40)), dtype_name)
    oj, nj = jssm._causal_conv(xj[:, :1], wj, sj)
    ot, nt = tssm._causal_conv(xt[:, :1], wt, st)
    _close(ot, oj, dtype_name)
    np.testing.assert_array_equal(_np(nt), _np(nj))   # a shifted window
    # the streaming mode continues the sequence mode
    full = tssm._causal_conv(torch.cat([st, xt[:, :1]], 1), wt)[:, -1:]
    _close(ot, full, dtype_name)


def test_segsum_equals_reference():
    x = np.random.default_rng(0).standard_normal((3, 2, 9)).astype(
        np.float32)
    t = tssm._segsum(torch.from_numpy(x)).numpy()
    j = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_allclose(t[np.isfinite(j)], j[np.isfinite(j)],
                               rtol=1e-6, atol=1e-6)


def _ssd_inputs(rng, b, s, nh, hd, ng, ds, dtype_name):
    x = _pair(rng.standard_normal((b, s, nh, hd)), dtype_name)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)) - 1.0))
    dt = (jnp.asarray(dt, jnp.float32), torch.from_numpy(dt).float())
    A = -np.exp(rng.uniform(-1, 1, nh))
    A = (jnp.asarray(A, jnp.float32), torch.from_numpy(A).float())
    B = _pair(rng.standard_normal((b, s, ng, ds)), dtype_name)
    C = _pair(rng.standard_normal((b, s, ng, ds)), dtype_name)
    D = rng.uniform(0.5, 1.5, nh)
    D = (jnp.asarray(D, jnp.float32), torch.from_numpy(D).float())
    return x, dt, A, B, C, D


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("s,chunk,ng", [(12, 12, 1), (24, 8, 1),
                                        (32, 8, 2)])
def test_ssd_chunked(dtype_name, s, chunk, ng):
    """One chunk, and several (the inter-chunk scan), with one B/C group
    and with two."""
    args = _ssd_inputs(np.random.default_rng(s), 2, s, 4, 8, ng, 6,
                       dtype_name)
    yj, fj = _J_SSD(*(a[0] for a in args), chunk)
    yt, ft = tssm.ssd_chunked(*(a[1] for a in args), chunk)
    assert yt.dtype == torch.float32 and ft.dtype == torch.float32
    _close(yt, yj, dtype_name)
    _close(ft, fj, dtype_name)


def test_ssd_chunked_refuses_a_ragged_length():
    args = _ssd_inputs(np.random.default_rng(0), 1, 10, 2, 4, 1, 4,
                       "float32")
    with pytest.raises(AssertionError):
        tssm.ssd_chunked(*(a[1] for a in args), 4)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_ssd_decode_step(dtype_name):
    rng = np.random.default_rng(3)
    x, dt, A, B, C, D = _ssd_inputs(rng, 3, 1, 4, 8, 1, 6, dtype_name)
    st = rng.standard_normal((3, 4, 8, 6)).astype(np.float32)
    sj, stt = jnp.asarray(st), torch.from_numpy(st)
    yj, nj = jssm.ssd_decode_step(sj, x[0][:, 0], dt[0][:, 0], A[0],
                                  B[0][:, 0], C[0][:, 0], D[0])
    before = stt.clone()
    out = torch.empty_like(stt)
    yt, nt = tssm.ssd_decode_step(stt, x[1][:, 0], dt[1][:, 0], A[1],
                                  B[1][:, 0], C[1][:, 0], D[1], out=out)
    assert nt is out and torch.equal(stt, before)   # the state only read
    assert yt.dtype == x[1].dtype
    _close(yt, yj, dtype_name)
    _close(nt, nj, dtype_name)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_mamba2_layer_prefill_and_decode(model, dtype_name):
    jc, tc, jp, tp = model[dtype_name]
    rng = np.random.default_rng(5)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"][0])
    pt = tlm.layer_params(tp["blocks"][0], 0)
    xj, xt = _pair(rng.standard_normal((2, 64, tc.d_model)), dtype_name)
    yj, (_, sj) = _J_LAYER(pj, xj, jc)
    yt, (_, stt) = tssm.mamba2_layer(pt, xt, tc)
    _close(yt, yj, dtype_name)
    _close(stt, sj, dtype_name)
    cj, ct = _pair(rng.standard_normal((2, 3, tssm.dims(tc)[2])),
                   dtype_name)
    oj, (ncj, nsj) = _J_LAYER(pj, xj[:, :1], jc, conv_state=cj,
                              ssm_state=sj)
    ot, (nct, nst) = tssm.mamba2_layer(pt, xt[:, :1], tc, conv_state=ct,
                                       ssm_state=stt)
    _close(ot, oj, dtype_name)
    _close(nst, nsj, dtype_name)
    np.testing.assert_array_equal(_np(nct), _np(ncj))


# ---- the model ----

def test_init_params_leaves_match_reference(model):
    jc, tc, jp, _ = model["bfloat16"]
    tp = tlm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return {k2: v2 for k, v in tree.items()
                    for k2, v2 in leaves(v, f"{prefix}/{k}").items()}
        if isinstance(tree, (tuple, list)):
            return {k2: v2 for i, v in enumerate(tree)
                    for k2, v2 in leaves(v, f"{prefix}/{i}").items()}
        return {prefix: (tuple(tree.shape), str(tree.dtype).replace(
            "torch.", ""))}

    assert leaves(tp) == leaves(jlm.init_params(jax.random.PRNGKey(0), jc))
    assert sum(int(np.prod(s)) for s, _ in leaves(tp).values()) \
        == tc.param_count() == jc.param_count()


def test_block_types_and_period():
    jc, tc = _cfgs()
    for k in ("block_types", "period", "n_periods", "n_tail"):
        assert getattr(tc, k) == getattr(jc, k), k
    assert tc.block_types == ("ssm",) * tc.n_layers and tc.n_tail == 0


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("s", [16, 64])
def test_forward_and_loss_equal_reference(model, dtype_name, s):
    jc, tc, jp, tp = model[dtype_name]
    rng = np.random.default_rng(s)
    tokens = rng.integers(0, tc.vocab, (2, s))
    labels = rng.integers(-1, tc.vocab, (2, s))
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    (jl, _), (tl, taux) = _J_FORWARD(jp, jb, jc), tlm.forward(tp, tb, tc)
    _close(tl, jl, dtype_name, share=1 / 32)
    assert float(taux) == 0.0
    (jloss, _), (tloss, _) = _J_LOSS(jp, jb, jc), tlm.loss_fn(tp, tb, tc)
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dtype_name == "float32"
                               else 1e-2)


def test_remat_modes(model):
    """"full", "dots" and "none" give the same loss, "dots" and "none"
    bit for bit with "full", and every gradient (the embedding's and the
    head's included) within 1e-6 (relative) and 1e-7 of "full"'s."""
    _, tc, _, tp = model["float32"]
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, tc.vocab, (2, 16))),
             "labels": torch.from_numpy(rng.integers(0, tc.vocab, (2, 16)))}
    grads = {}
    for remat in ("full", "dots", "none"):
        cfg = dataclasses.replace(tc, remat=remat)
        leaves = tree_leaves(tp)
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = tlm.loss_fn(tp, batch, cfg)
        grads[remat] = (float(loss.detach()),
                        torch.autograd.grad(loss, leaves))
        for t in leaves:
            t.requires_grad_(False)
    for remat in ("dots", "none"):
        assert grads[remat][0] == grads["full"][0], remat
        for g, want in zip(grads[remat][1], grads["full"][1]):
            assert torch.isfinite(g).all(), remat
            torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_prefill_then_decode_equals_forward(model, dtype_name):
    """prefill(S - 1 tokens) then decode(token S) reproduces forward's
    logits at S (the port alone, as the reference's own test), and the
    prefill's logits, final state and conv tail equal the reference's."""
    jc, tc, jp, tp = model[dtype_name]
    s = 17
    tokens = np.random.default_rng(9).integers(0, tc.vocab, (2, s))
    full, _ = tlm.forward(tp, {"tokens": torch.from_numpy(tokens)}, tc)
    last, cache = tsm.prefill(tp, {"tokens": torch.from_numpy(
        tokens[:, :-1])}, tc, max_len=s)
    blocks = cache["blocks"]
    dec, cache = tsm.decode_step(tp, cache, torch.from_numpy(
        tokens[:, -1:]), tc)
    assert cache["blocks"] is not blocks       # new state, rebound
    _close(last, full[:, -2], dtype_name, share=1 / 32)
    _close(dec, full[:, -1], dtype_name, share=1 / 32)
    assert int(cache["pos"]) == s
    jlast, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(
        tokens[:, :-1])}, jc, s)
    _close(last, jlast, dtype_name, share=1 / 32)
    for k in ("state", "conv"):
        _close(blocks[0][k], jcache["blocks"][0][k], dtype_name,
               share=1 / 16)
    jdec, _ = _J_DECODE(jp, jcache, jnp.asarray(tokens[:, -1:]), jc)
    _close(dec, jdec, dtype_name, share=1 / 32)
