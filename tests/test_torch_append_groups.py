"""The arithmetic of K5's lane-group encoder, checked on the CPU.

On the card K5 gives each (b, t, head) row of K or V a group of G =
min(32, row bytes / 16) lanes; lane li loads chunks li + k G (k < C, C =
row bytes / (16 G)) of E = 16 / (element size) elements, in f32 or bf16 as
the model made them.  The row's sum |x| is each lane's own sum (chunk by
chunk, element by element) and then a butterfly over the group; the pow2
scale is the exponent bits of max(mean, 1e-30); the codes are the
flushing RNE encoder's.  Nibble-packed 4-bit codes pair element j with
j + hd/2: the codes of chunk li + G/2 come to lane li by one shuffle (C =
1), or are the lane's own second chunk (C = 2).  A destination row outside
[0, R) is skipped.  A plain model of exactly that is held bit-exact to the
port's ``paged_kv_append_rows_ref`` and to the reference's Pallas
``paged_kv_append_rows`` in interpret mode (on the rows past trash page
0, where idle slots collide), with f32 and bf16 inputs, G = 2 to 32 and
C = 1 and 2.  ``append_geometry`` (the contract of K5 and of the ring's K3,
which runs the same kernel) and the wrapper's row strides are checked
here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.kernels import paged_kv as jpkv  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402
from repro_torch.kernels.posit_encode import encode_tile  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

FMTS = [("posit16_2", False), ("posit8_2", False), ("posit4_1", True)]
PS, PMAX = 4, 3


def _np(t):
    a = t.numpy()
    return a.view(np.uint16) if a.dtype == np.int16 else a


def _t(a):
    a = np.array(a)                     # writable copy
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def group_row_model(x, fmt, packed, lanes, loads):
    """One row (hd,) f32 as K5's group of ``lanes`` lanes encodes it:
    returns (codes as stored, scale)."""
    hd = x.shape[0]
    e = hd // (lanes * loads)                          # elements per load
    chunk = x.reshape(lanes * loads, e)                # chunk c: elements
    own = [np.float32(0)] * lanes                      # c e .. c e + e - 1
    for li in range(lanes):
        for k in range(loads):
            for v in chunk[li + k * lanes]:
                own[li] = np.float32(own[li] + np.float32(abs(v)))
    s = np.asarray(own, np.float32)
    o = lanes // 2
    while o:                           # butterfly: s_l + s_(l xor o)
        s = (s + s[np.arange(lanes) ^ o]).astype(np.float32)
        o //= 2
    assert len({v.tobytes() for v in s}) == 1      # every lane agrees
    mean = np.float32(s[0] / np.float32(hd))
    m = mean if np.isnan(mean) else max(mean, np.float32(1e-30))
    scale = (np.asarray(m, np.float32).view(np.uint32)
             & np.uint32(0x7F800000)).view(np.float32)
    codes = encode_tile(torch.from_numpy(x / scale), fmt).numpy()
    if not packed:
        return codes, scale
    c = codes.reshape(lanes * loads, e).astype(np.uint32)
    out = np.zeros((lanes * loads // 2, e), np.uint8)
    for li in range(lanes):
        if loads == 2:                 # the lane's own second chunk
            out[li] = c[li] | (c[li + lanes] << 4)
        elif li < lanes // 2:          # one shuffle: lane li xor G/2's word
            word = sum(int(v) << (4 * j) for j, v in
                       enumerate(c[li ^ (lanes // 2)]))
            hi = np.asarray([(word >> (4 * j)) & 0xF for j in range(e)])
            out[li] = c[li] | (hi << 4)
    return out.reshape(-1), scale


def group_append_model(k_codes, k_scale, v_codes, v_scale, k_new, v_new,
                       dst, fmt, packed):
    """K5 on numpy buffers (updated in place): K rows then V rows, in
    (b, t, head) order; rows whose dst is outside [0, R) are skipped."""
    lanes, loads = tkv.append_geometry("model", k_new.shape[-1],
                                        k_new.dtype)
    r = k_codes.shape[0]
    for codes, scale, new in ((k_codes, k_scale, k_new),
                              (v_codes, v_scale, v_new)):
        x = new.to(torch.float32).numpy()
        b, t, h, _ = x.shape
        for bi in range(b):
            for ti in range(t):
                row = int(dst[bi, ti])
                if not 0 <= row < r:
                    continue
                for hi in range(h):
                    c, s = group_row_model(x[bi, ti, hi], fmt, packed,
                                           lanes, loads)
                    codes[row, hi] = c.astype(codes.dtype)
                    scale[row, hi] = s


def _case(name, packed, hd, x_dtype, t, seed):
    """Random pool (stored words of any value), a shuffled table with idle
    slots 1 and 3, rows whose magnitudes span several binades."""
    rng = np.random.default_rng(seed)
    fj = jformats.get(name)
    b, h = 4, 2
    r = (1 + b * PMAX) * PS
    dc = hd // 2 if packed else hd
    hi = 1 << (16 if fj.bits == 16 else 8)
    bufs = [rng.integers(0, hi, (r, h, dc)).astype(fj.np_storage_dtype),
            np.exp2(rng.integers(-4, 4, (r, h))).astype(np.float32),
            rng.integers(0, hi, (r, h, dc)).astype(fj.np_storage_dtype),
            np.exp2(rng.integers(-4, 4, (r, h))).astype(np.float32)]
    table = (1 + rng.permutation(b * PMAX)).reshape(b, PMAX).astype(np.int32)
    table[[1, 3]] = 0
    pos = np.asarray([2, 0, 5, 30], np.int32)
    dst = np.array(jpkv.flat_dst_rows_chunk(jnp.asarray(table),
                                            jnp.asarray(pos), t, PS))
    new = []
    for _ in range(2):
        mag = np.exp2(rng.uniform(-8, 8, (b, t, h, 1)))
        x = torch.from_numpy((rng.normal(0, 1, (b, t, h, hd)) * mag)
                             .astype(np.float32)).to(x_dtype)
        new.append(x)
    return fj, tformats.get(name), bufs, dst, new


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("name,packed", FMTS)
def test_group_model_vs_plain_and_jax(name, packed, hd, x_dtype):
    """hd 16, 64, 256: G = 4, 16, 32 (C = 2 at hd 256) for f32 rows and
    G = 2, 8, 32 for bf16 rows, T = 2 with a page boundary inside."""
    fj, ft, bufs, dst, (kn, vn) = _case(name, packed, hd, x_dtype, 2,
                                        seed=hd)
    got = [np.array(a) for a in bufs]
    group_append_model(*got, kn, vn, dst, ft, packed)
    plain = [_t(a) for a in bufs]
    tpkv.paged_kv_append_rows_ref(*plain, kn, vn, torch.from_numpy(dst), ft,
                                  packed)
    # the reference casts rows to f32 before its kernel; bf16 -> f32 is exact
    want = jpkv.paged_kv_append_rows(
        *[jnp.asarray(a) for a in bufs],
        jnp.asarray(kn.to(torch.float32).numpy()),
        jnp.asarray(vn.to(torch.float32).numpy()), jnp.asarray(dst), fj,
        packed=packed, interpret=True)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g[PS:], _np(p)[PS:])
        np.testing.assert_array_equal(g[PS:], np.asarray(w)[PS:])


@pytest.mark.parametrize("name,packed", FMTS)
def test_group_model_skips_rows_outside_the_pool(name, packed):
    """dst -1 and R + 3 (slots 1 and 2) write nothing; the other slots'
    rows are those of the plain version on those slots alone."""
    _, ft, bufs, dst, (kn, vn) = _case(name, packed, 64, torch.bfloat16, 3,
                                       seed=9)
    r = bufs[0].shape[0]
    dst[1], dst[2] = -1, r + 3
    got = [np.array(a) for a in bufs]
    group_append_model(*got, kn, vn, dst, ft, packed)
    keep = [0, 3]
    plain = [_t(a) for a in bufs]
    tpkv.paged_kv_append_rows_ref(*plain, kn[keep], vn[keep],
                                  torch.from_numpy(dst[keep]), ft, packed)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g[PS:], _np(p)[PS:])


def test_group_model_nan_and_zero_rows():
    """A row holding a NaN gets the scale of a NaN mean (exponent bits all
    ones) and NaR codes where the plain version has them; an all-zero row
    the 1e-30 floor."""
    ft = tformats.get("posit8_2")
    x = np.zeros((2, 64), np.float32)
    x[1, 7] = np.nan
    x[1, :7] = 3.0
    for row in x:
        c, s = group_row_model(row, ft, False, 16, 1)
        pc, ps_ = tkv.encode_kv_rows(torch.from_numpy(row), ft)
        np.testing.assert_array_equal(c, pc.numpy())
        np.testing.assert_array_equal(np.asarray([s]), ps_.numpy())


@pytest.mark.parametrize("hd,dtype,want", [
    (64, torch.float32, (16, 1)),       # the main path from f32 rows
    (64, torch.bfloat16, (8, 1)),       # ... and from the model's bf16
    (8, torch.float32, (2, 1)),
    (16, torch.bfloat16, (2, 1)),
    (128, torch.float32, (32, 1)),
    (256, torch.float32, (32, 2)),      # two loads per lane
    (256, torch.bfloat16, (32, 1)),
])
def test_append_geometry(hd, dtype, want):
    assert tkv.append_geometry("k5", hd, dtype) == want


@pytest.mark.parametrize("hd,dtype,err", [
    (4, torch.float32, ValueError),     # a 16-B row: one lane, no pairs
    (8, torch.bfloat16, ValueError),
    (48, torch.float32, ValueError),    # not 32 * 2^i bytes
    (96, torch.bfloat16, ValueError),
    (512, torch.bfloat16, ValueError),  # hd > 256
    (64, torch.float16, TypeError),
    (64, torch.float64, TypeError),
])
def test_append_geometry_raises(hd, dtype, err):
    with pytest.raises(err):
        tkv.append_geometry("k5", hd, dtype)


def test_row_strides_of_the_models_views():
    """v from the fused QKV split is a strided view: its strides go to the
    kernel as they are (0 along an axis of size 1); a row that does not
    start 16-byte aligned raises."""
    b, s, nh, nkv, hd = 2, 3, 4, 2, 16
    qkv = torch.zeros(b, s, (nh + 2 * nkv) * hd, dtype=torch.bfloat16)
    vp = qkv[..., (nh + nkv) * hd:].reshape(b, s, nkv, hd)
    assert tkv._row_strides("k5", vp) == ((nh + 2 * nkv) * hd * s,
                                           (nh + 2 * nkv) * hd, hd)
    one = torch.zeros(b, 1, nkv, hd)
    assert tkv._row_strides("k5", one) == (nkv * hd, 0, hd)
    with pytest.raises(ValueError, match="aligned"):
        tkv._row_strides("k5", qkv[..., 1:1 + nkv * hd].reshape(
            b, s, nkv, hd))
