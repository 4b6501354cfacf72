"""The port's posit gradient wire (``repro_torch.optim.compression``) vs
the reference's ``repro.optim.compression``.

Gradients: one tree of the smoke paper-edge model's 11 leaf shapes, made
with numpy from a seed, each leaf at its own gradient-like magnitude
(mean |g| from 2^-10 down to 2^-20, heavy-tailed, with exact zeros and a
few float32 subnormals), in float32 and bf16.  On the CPU the port's wire
runs the plain versions of K2's normalising mode and K1
(``core.posit.encode_f32`` and ``decode_to_f32``).

What is held, and why:
- the scale: per leaf a power of two 2^k, with k = round(log2(s_ref)).
  The reference's scale is ``jnp.exp2(round(log2(mean)))``, which on this
  CPU is off by 1-9 ulp for k = -13 and k <= -15 (a known reference
  behaviour), so it is compared by its exponent;
- the codes, bit-exact against the reference's ``encode_f32(x / 2^k)`` at
  the exact scale (the division in numpy: IEEE float32);
- against ``compress_grads`` itself (under ``jax.jit``, as the
  reference's train step runs it): equal codes on every leaf whose
  reference scale is an exact power of two; elsewhere codes one posit
  step apart (x / s_ref moved by the scale's few ulp across a rounding
  midpoint) on < 0.5 % of the values, equal on the rest.  One more
  reference behaviour shows here: XLA's CPU arithmetic flushes float32
  subnormal operands to zero, so a subnormal gradient divides to 0 and
  encodes to code 0 there, where the port (IEEE division, then the wire's
  encoder) gives +-minpos, one posit step away; those elements are named
  and held to exactly that;
- the decoded gradients: bit-exact against the reference's decode of the
  port's codes times 2^k (NaR -> 0); the new residual g + r - deq
  bit-exact in float32, and carried into a second step;
- ``decompress_grads`` (NaR -> 0), ``wire_bytes`` and the int8 wire
  (no kernel in either package: ``quant.quantize``) bit-exact;
  ``grad_wire=None`` is the identity.  The int8 wire and the step from a
  mid-training state are in ``test_torch_compression_steps.py``, on this
  file's helpers.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import posit as jposit  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.formats import get as jget  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import quant as tquant  # noqa: E402
from repro_torch.core.formats import get as tget  # noqa: E402
from repro_torch.core.transprecision import TCPolicy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim.adamw import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

WIRE = "posit16_2"
# the reference's codec, jitted (one compile per leaf shape; its eager ops
# dispatch one by one)
_jenc = jax.jit(jposit.encode_f32, static_argnums=1)
_jdec = jax.jit(jposit.decode_to_f32, static_argnums=1)
SUBNORMAL = slice(1, 6)     # leaf 1's planted subnormals (and one normal)


def _grads(seed=0):
    """{name: float32 array} at the smoke model's leaf shapes, leaf i at a
    mean |g| near 2^-(10 + i)."""
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = [tuple(p.shape) for p in tree_leaves(params)]
    rng = np.random.default_rng(seed)
    out = []
    for i, shp in enumerate(shapes):
        g = rng.standard_t(3, shp).astype(np.float32) * np.float32(
            2.0 ** -(10 + i))
        g.reshape(-1)[::97] = 0.0
        if i == 1:       # subnormals of both signs, and one tiny normal
            g.reshape(-1)[SUBNORMAL] = np.array(
                [1e-40, -1e-40, 1.4e-45, -3e-39, 1.2e-38], np.float32)
        out.append(g)
    return out


def _tree(leaves):
    """A nested tree like the params' (a dict holding a tuple of a dict),
    in ``tree_leaves`` order."""
    return {"a": leaves[0], "b": (dict(zip("cdefghijk", leaves[1:10])),),
            "z": leaves[10]}


def _t(tree):
    """The same tree of torch tensors."""
    def t(a):
        return torch.from_numpy(np.array(a))
    return {"a": t(tree["a"]),
            "b": ({k: t(v) for k, v in tree["b"][0].items()},),
            "z": t(tree["z"])}


def _codes_u(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _ref_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(
        x, jquant.QuantizedTensor))


@pytest.fixture(scope="module")
def wires():
    g = _grads()
    jw, jr = jax.jit(lambda t: jcomp.compress_grads(t, WIRE))(
        _tree([jnp.asarray(x) for x in g]))
    tw, tr = tcomp.compress_grads(_t(_tree(g)), WIRE)
    return g, _ref_leaves(jw), tree_leaves(tw), tr, jr


def test_scale_is_the_reference_exponent(wires):
    g, jw, tw, _, _ = wires
    assert len(tw) == len(jw) == 11
    for t, j in zip(tw, jw):
        s_ref = float(np.asarray(j.scale))
        k = float(np.round(np.log2(s_ref)))
        assert float(t.scale) == 2.0 ** k, (float(t.scale), s_ref)
        assert t.scale.dtype == torch.float32


def test_codes_bit_exact_at_the_exact_scale(wires):
    g, _, tw, _, _ = wires
    fmt = jget(WIRE)
    for x, t in zip(g, tw):
        s = np.float32(float(t.scale))
        want = _jenc(jnp.asarray(x / s), fmt)
        np.testing.assert_array_equal(_codes_u(t.data.numpy()),
                                      _codes_u(want))
    # the subnormals encode to +-minpos: a posit has no underflow
    np.testing.assert_array_equal(
        _codes_u(tw[1].data.numpy()).reshape(-1)[SUBNORMAL],
        [1, 0xFFFF, 1, 0xFFFF, 1])


def test_codes_vs_compress_grads(wires):
    """Equal where the reference's scale is a power of two; where it is
    not, one posit step apart on < 0.5 % of the values."""
    _, jw, tw, _, _ = wires
    exact, inexact = 0, 0
    for i, (t, j) in enumerate(zip(tw, jw)):
        s_ref = float(np.asarray(j.scale))
        a = _codes_u(t.data.numpy()).astype(np.int64).reshape(-1)
        b = _codes_u(np.asarray(j.data)).astype(np.int64).reshape(-1)
        if i == 1:      # XLA flushed the four subnormal operands
            np.testing.assert_array_equal(b[SUBNORMAL], [0, 0, 0, 0, 1])
            np.testing.assert_array_equal(a[SUBNORMAL],
                                          [1, 0xFFFF, 1, 0xFFFF, 1])
            a, b = np.delete(a, range(1, 5)), np.delete(b, range(1, 5))
        diff = (a - b) % (1 << 16)
        diff = np.minimum(diff, (1 << 16) - diff)      # steps, either way
        if s_ref == 2.0 ** np.round(np.log2(s_ref)):
            exact += 1
            np.testing.assert_array_equal(a, b)
        else:
            inexact += 1
            assert diff.max() <= 1
            assert (diff != 0).mean() < 5e-3, (diff != 0).mean()
    assert exact and inexact, (exact, inexact)   # the data spans both


def test_decoded_and_residual(wires):
    g, _, tw, tr, _ = wires
    fmt = jget(WIRE)
    deq = tree_leaves(tcomp.decompress_grads(tcomp.compress_grads(
        _t(_tree(g)), WIRE)[0]))
    for x, t, r, d in zip(g, tw, tree_leaves(tr), deq):
        s = np.float32(float(t.scale))
        codes = jnp.asarray(_codes_u(t.data.numpy()).astype(
            fmt.np_storage_dtype))
        want = np.nan_to_num(np.asarray(_jdec(codes, fmt))) * s
        np.testing.assert_array_equal(d.numpy().view(np.uint32),
                                      want.astype(np.float32).view(np.uint32))
        np.testing.assert_array_equal(r.numpy(), x - want)
        assert r.dtype == torch.float32


def test_error_feedback_carries_the_residual():
    """Two steps: the second quantizes g2 + r1; every code at the exact
    scale against the reference's encoder, every residual exact."""
    g1, g2 = _grads(1), _grads(2)
    fmt = jget(WIRE)
    deq1, r1 = tcomp.error_feedback_update(_t(_tree(g1)), None, WIRE)
    # the update writes its new residual into r1's leaves: pass a copy
    deq2, r2 = tcomp.error_feedback_update(
        _t(_tree(g2)), tree_map(torch.clone, r1), WIRE)
    wires2, _ = tcomp.compress_grads(_t(_tree(g2)), WIRE, r1)
    for x, ra, w, d, rb in zip(g2, tree_leaves(r1), tree_leaves(wires2),
                               tree_leaves(deq2), tree_leaves(r2)):
        x32 = x + ra.numpy()
        s = np.float32(float(w.scale))
        np.testing.assert_array_equal(
            _codes_u(w.data.numpy()),
            _codes_u(_jenc(jnp.asarray(x32 / s), fmt)))
        np.testing.assert_array_equal(rb.numpy(), x32 - d.numpy())


def test_bf16_gradients_widen_first(wires):
    g = [x.astype(np.float32) for x in _grads(3)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in g]
    tw, tr = tcomp.compress_grads(tb, WIRE)
    jw, _ = jax.jit(lambda t: jcomp.compress_grads(t, WIRE))(
        [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in tb])
    for t, j, b in zip(tw, _ref_leaves(jw), tb):
        s = np.float32(float(t.scale))
        assert float(t.scale) == 2.0 ** np.round(np.log2(float(
            np.asarray(j.scale))))
        np.testing.assert_array_equal(
            _codes_u(t.data.numpy()),
            _codes_u(_jenc(jnp.asarray(b.float().numpy() / s),
                                       jget(WIRE))))


def test_decompress_maps_nar_to_zero():
    codes = np.array([0, 1, 0x4000, 0x8000, 0x7FFF, 0xC000], np.uint16)
    jq = jquant.QuantizedTensor(jnp.asarray(codes), jnp.float32(0.125),
                                jget(WIRE))
    tq = tquant.QuantizedTensor(torch.from_numpy(codes.view(np.int16)),
                                torch.tensor(0.125), tget(WIRE))
    want = np.asarray(jcomp.decompress_grads({"w": jq})["w"])
    got = tcomp.decompress_grads({"w": tq})["w"].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[3] == 0.0


@pytest.mark.parametrize("fmt", [WIRE, "posit8_2", "int8", None])
def test_wire_bytes(wires, fmt):
    g = wires[0]
    assert tcomp.wire_bytes(_t(_tree(g)), fmt) == jcomp.wire_bytes(
        _tree([jnp.asarray(x) for x in g]), fmt)


def test_wire_bytes_at_full_width():
    """249,337,344 B for posit16_2 against 498,674,688 B at f32: the
    124,668,672 gradient values of paper-edge (shapes only, on the meta
    device)."""
    cfg = get_config("paper-edge")
    params = lm.init_params(cfg, device="meta")
    assert tcomp.wire_bytes(params, WIRE) == 249_337_344
    assert tcomp.wire_bytes(params, None) == 498_674_688


def test_no_wire_is_the_identity():
    g = _t(_tree(_grads()))
    r = {"x": torch.zeros(1)}
    out, res = tcomp.error_feedback_update(g, r, None)
    assert out is g and res is r
    out, res = tcomp.compress_grads(g, None, r)
    assert out is g and res is r


def test_wire_formats_without_a_kernel_are_refused():
    """A posit wire with no CUDA instantiation, or a bias at which float32
    subnormals are representable, raises when the step is built; the
    supported wire builds a zero residual per param."""
    cfg = get_config("paper-edge", smoke=True)
    for name in ("posit32_2",):
        pol = TCPolicy(name="w", grad_wire=name)
        with pytest.raises(ValueError, match="no CUDA instantiation"):
            make_train_step(cfg, AdamWConfig(), pol)
        with pytest.raises(ValueError, match="no CUDA instantiation"):
            init_train_state(cfg, AdamWConfig(), pol, device="cpu")
    biased = dataclasses.replace(tget("posit16_2"), bias=-120)
    from repro_torch.kernels.posit_encode import posit_encode
    with pytest.raises(ValueError, match="representable"):
        posit_encode(torch.ones(4), biased, subnormals="normalize")
    with pytest.raises(ValueError, match="subnormals="):
        posit_encode(torch.ones(4), tget("posit16_2"), subnormals="keep")
    st = init_train_state(cfg, AdamWConfig(), TCPolicy(
        name="w", grad_wire=WIRE), device="cpu")
    for p, r in zip(tree_leaves(st.params), tree_leaves(st.ef_residual)):
        assert r.shape == p.shape and r.dtype == torch.float32
        assert not r.any()
    assert init_train_state(cfg, AdamWConfig(), device="cpu"
                            ).ef_residual is None


def test_error_feedback_writes_the_residual_in_place():
    """The update writes the new residual into the old one's leaves (no
    second f32 copy of the model): decoded gradients and residual bit for
    bit those of ``compress_grads`` + ``decompress_grads``, which leave
    their residual as it was; bf16 gradients widen first.  With no
    residual, the gradients are left as they were."""
    grads = _t(_tree(_grads(seed=4)))
    grads["a"] = grads["a"].to(torch.bfloat16)
    residual = _t(_tree(_grads(seed=5)))
    before = [r.clone() for r in tree_leaves(residual)]
    wires, want_res = tcomp.compress_grads(grads, WIRE, residual)
    want_deq = tcomp.decompress_grads(wires)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(residual),
                                                  before))
    deq, res = tcomp.error_feedback_update(grads, residual, WIRE)
    for a, b in zip(tree_leaves(deq) + tree_leaves(res),
                    tree_leaves(want_deq) + tree_leaves(want_res)):
        assert torch.equal(a, b)
    assert all(r is o for r, o in zip(tree_leaves(res),
                                      tree_leaves(residual)))
    g = [t.clone() for t in tree_leaves(grads)]
    deq0, res0 = tcomp.error_feedback_update(grads, None, WIRE)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), g))
    assert not any(r is t for r, t in zip(tree_leaves(res0),
                                          tree_leaves(grads)))


def test_one_encode_and_one_decode_per_leaf(monkeypatch):
    """The train step's wire calls K2's and K1's wrappers once per leaf
    each (on the card: 11 + 11 launches a step for the 11 leaves), K2 in
    its normalising mode."""
    calls = {"enc": [], "dec": 0}
    enc, dec = tcomp.posit_encode, tcomp.posit_decode

    def count_enc(x, fmt, subnormals="flush"):
        calls["enc"].append(subnormals)
        return enc(x, fmt, subnormals)

    def count_dec(codes, fmt, **kw):
        calls["dec"] += 1
        return dec(codes, fmt, **kw)

    monkeypatch.setattr(tcomp, "posit_encode", count_enc)
    monkeypatch.setattr(tcomp, "posit_decode", count_dec)
    tcomp.error_feedback_update(_t(_tree(_grads())), None, WIRE)
    assert calls == {"enc": ["normalize"] * 11, "dec": 11}
