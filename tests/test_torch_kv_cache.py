"""Posit KV cache of the PyTorch port vs the JAX package.

Codes and scales bit-exact (row codec, the plain K3 against the reference's
Pallas ``kv_append_rows`` in interpret mode); the plain K4 against the
reference's Pallas ``decode_attention`` in interpret mode within rtol 1e-5,
atol 1e-6 (online vs dense softmax: float32 summation order).
``test_kernel_matches_plain_on_card`` needs the GPU (marker ``cuda``) and
holds K4's split-walk kernels to the plain version there; the machine with
the GPU has no JAX, so the JAX imports are optional and only the card test
runs there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.core import transprecision as jtp
    from repro.kernels import kv_cache as jkv
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import transprecision as ttp  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FMTS = [("posit16_2", False), ("posit8_2", False), ("posit4_1", True)]


def _np(t):
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _t(a):
    a = np.array(a)                     # writable copy
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _rows(rng, shape):
    """Float rows whose magnitudes span several binades per row."""
    mag = np.exp2(rng.uniform(-8, 8, shape[:-1] + (1,)))
    return (rng.normal(0, 1, shape) * mag).astype(np.float32)


@pytest.mark.parametrize("name,packed", FMTS)
def test_encode_decode_kv_rows_bit_exact(name, packed):
    rng = np.random.default_rng(0)
    x = _rows(rng, (3, 5, 2, 16))
    x[0, 0, 0] = 0.0                      # all-zero row: scale floor
    jc, js = jkv.encode_kv_rows(jnp.asarray(x), jformats.get(name), packed)
    tc, ts = tkv.encode_kv_rows(torch.from_numpy(x), tformats.get(name),
                                packed)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tkv.decode_kv_rows(tc, ts, tformats.get(name), packed).numpy(),
        np.asarray(jkv.decode_kv_rows(jc, js, jformats.get(name), packed)))
    assert tc.shape[-1] == tkv.code_channels(16, tformats.get(name), packed)


def test_nibble_pack_roundtrip():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 16, (3, 5, 8)).astype(np.uint8)
    packed = tkv.pack_nibbles(torch.from_numpy(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jkv.pack_nibbles(jnp.asarray(codes))))
    np.testing.assert_array_equal(tkv.unpack_nibbles(packed).numpy(), codes)


@pytest.mark.parametrize("name,packed", FMTS)
@pytest.mark.parametrize("t,pos", [(1, [0, 7]), (1, [13, 30]),
                                   (3, [6, 2]), (8, [0, 0])])
def test_kv_append_rows_bit_exact(name, packed, t, pos):
    """In-place ring append at (pos[b] + t) mod W, incl. wraparound; rows
    not written keep their (random) contents."""
    rng = np.random.default_rng(2)
    fj, ft = jformats.get(name), tformats.get(name)
    b, w, h, hd = 2, 8, 3, 16
    dc = tkv.code_channels(hd, ft, packed)
    hi = 1 << (16 if fj.bits == 16 else 8)        # any stored byte/word
    kc = rng.integers(0, hi, (b, w, h, dc)).astype(fj.np_storage_dtype)
    vc = rng.integers(0, hi, (b, w, h, dc)).astype(fj.np_storage_dtype)
    ks = np.exp2(rng.integers(-4, 4, (b, w, h))).astype(np.float32)
    vs = np.exp2(rng.integers(-4, 4, (b, w, h))).astype(np.float32)
    kn, vn = _rows(rng, (b, t, h, hd)), _rows(rng, (b, t, h, hd))
    pos = np.asarray(pos, np.int32)
    want = jkv.kv_append_rows(jnp.asarray(kc), jnp.asarray(ks),
                              jnp.asarray(vc), jnp.asarray(vs),
                              jnp.asarray(kn), jnp.asarray(vn),
                              jnp.asarray(pos), fj, packed=packed,
                              interpret=True)
    bufs = [_t(kc), _t(ks), _t(vc), _t(vs)]
    got = tkv.kv_append_rows_ref(*bufs, torch.from_numpy(kn),
                                 torch.from_numpy(vn), torch.from_numpy(pos),
                                 ft, packed)
    for g, buf, wv in zip(got, bufs, want):
        assert g is buf                   # updated in place
        np.testing.assert_array_equal(_np(g), np.asarray(wv))
    # the dispatching wrapper takes the same plain path for CPU tensors
    bufs2 = [_t(kc), _t(ks), _t(vc), _t(vs)]
    got2 = tkv.kv_append_rows(*bufs2, torch.from_numpy(kn),
                              torch.from_numpy(vn), torch.from_numpy(pos),
                              ft, packed=packed)
    for g, wv in zip(got2, want):
        np.testing.assert_array_equal(_np(g), np.asarray(wv))


@pytest.mark.parametrize("name,packed", FMTS)
@pytest.mark.parametrize("cache_len", [[1, 16], [5, 9], [16, 16], [0, 9]])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_attention_ref_matches_reference(name, packed, cache_len,
                                                q_dtype):
    """f32 q: against the Pallas kernel (interpret mode) and the reference's
    plain version.  bf16 q: against the reference's plain version only,
    which like the port's casts q to f32 before the hd^-0.5 scale (the
    Pallas kernel scales in bf16, which differs unless hd^-0.5 is a power
    of two); the bf16 output allows one bf16 rounding (rtol 2^-7)."""
    rtol = {"float32": 1e-5, "bfloat16": 2.0 ** -7}[q_dtype]
    rng = np.random.default_rng(3)
    fj, ft = jformats.get(name), tformats.get(name)
    b, w, nkv, grp, hd = 2, 16, 2, 3, 8
    kc, ks = jkv.encode_kv_rows(jnp.asarray(_rows(rng, (b, w, nkv, hd))),
                                fj, packed)
    vc, vs = jkv.encode_kv_rows(jnp.asarray(_rows(rng, (b, w, nkv, hd))),
                                fj, packed)
    ks, vs = ks[..., 0], vs[..., 0]
    q = rng.normal(0, 1, (b, 1, nkv * grp, hd)).astype(np.float32)
    qj = jnp.asarray(q).astype(q_dtype)
    qt = torch.from_numpy(q).to(getattr(torch, q_dtype))
    cl = np.asarray(cache_len, np.int32)
    wants = [jkv.decode_attention_ref(qj, kc, ks, vc, vs, jnp.asarray(cl),
                                      fj, packed)]
    if q_dtype == "float32":
        wants.append(jkv.decode_attention(qj, kc, ks, vc, vs,
                                          jnp.asarray(cl), fj, packed=packed,
                                          block_w=4, interpret=True))
    args = [_t(a) for a in (kc, ks, vc, vs)]
    for fn in (tkv.decode_attention_ref, tkv.decode_attention):
        got = fn(qt, *args, torch.from_numpy(cl), ft, packed=packed)
        assert got.dtype == qt.dtype
        for want in wants:
            np.testing.assert_allclose(got.to(torch.float32).numpy(),
                                       np.asarray(want, np.float32),
                                       rtol=rtol, atol=1e-6)


def test_kv_storage_resolution_matches_reference():
    for name, spec in ttp.KV_FORMATS.items():
        jspec = jtp.KV_FORMATS[name]
        assert spec.is_posit == jspec.is_posit
        assert spec.packed == jspec.packed
        assert spec.bytes_per_value(64) == jspec.bytes_per_value(64)
    assert ttp.kv_storage(ttp.BF16) is None
    legacy = ttp.kv_storage(ttp.SERVE_P16)
    assert legacy.is_posit and legacy.fmt.bits == 16
    with pytest.raises(KeyError):
        ttp.kv_storage(ttp.TCPolicy(name="x", kv_format="fp7"))


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K4's split walk and combine over ring rows against the plain version
    on the card: cache_len at every split boundary, 0, -1 and past W, a
    ring of 2 R + 72 rows (a partial last split), posit16/8 and packed
    posit4; f32 q within rtol/atol 1e-5, bf16 q (output bf16) within one
    bf16 rounding (2^-7) of the plain version on the same bf16 q (hd^-0.5
    = 1/8 scales bf16 exactly); one launch per call, and unsupported
    shapes and dtypes raise before any."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    sr = tkv.SPLIT_ROWS
    nkv, grp, hd = 2, 3, 64
    w = 2 * sr + 72
    lens = torch.tensor([-1, 0, 1, sr - 1, sr, sr + 1, 2 * sr - 1, 2 * sr,
                         2 * sr + 1, w - 1, w, w + 1, 5 * w],
                        dtype=torch.int32, device=dev)
    b = len(lens)
    for name, packed in FMTS:
        ft = tformats.get(name)
        ring = []
        for _ in range(2):
            mag = np.exp2(rng.uniform(-2, 2, (b, w, nkv, 1)))
            c, sc = tkv.encode_kv_rows(torch.from_numpy((rng.normal(
                0, 1, (b, w, nkv, hd)) * mag).astype(np.float32)), ft, packed)
            ring += [c.to(dev), sc[..., 0].contiguous().to(dev)]
        q = torch.from_numpy(rng.normal(0, 1, (b, 1, nkv * grp, hd))
                             .astype(np.float32)).to(dev)
        for qd, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
            want = tkv.decode_attention_ref(q.to(qd), *ring, lens, ft,
                                            packed)
            before = LAUNCHES["decode_attention"]
            got = tkv.decode_attention(q.to(qd), *ring, lens, ft,
                                       packed=packed)
            assert LAUNCHES["decode_attention"] == before + 1
            assert got.dtype == qd and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
    before = LAUNCHES["decode_attention"]
    c, sc = tkv.encode_kv_rows(torch.zeros(1, 16, 2, 48), tformats.POSIT8_2)
    c, sc = c.to(dev), sc[..., 0].contiguous().to(dev)
    with pytest.raises(ValueError, match="head dim"):
        tkv.decode_attention(torch.zeros(1, 1, 2, 48, device=dev), c, sc, c,
                             sc, 3, tformats.POSIT8_2)
    c64, sc64 = tkv.encode_kv_rows(torch.zeros(1, 16, 2, 64),
                                   tformats.POSIT8_2)
    c64, sc64 = c64.to(dev), sc64[..., 0].contiguous().to(dev)
    with pytest.raises(TypeError, match="q must be"):
        tkv.decode_attention(torch.zeros(1, 1, 2, 64, dtype=torch.float16,
                                         device=dev), c64, sc64, c64, sc64, 3,
                             tformats.POSIT8_2)
    assert LAUNCHES["decode_attention"] == before
