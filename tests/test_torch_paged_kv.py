"""Paged posit KV pool of the PyTorch port vs the JAX package.

Row addressing (``flat_dst_rows``/``flat_dst_rows_chunk``) and
``gather_pages`` are equal to the reference's.  The plain K5 is bit-exact
against the reference's Pallas ``paged_kv_append_rows`` in interpret mode
on every row outside trash page 0 (idle slots collide there in no set
order).  The plain K6 is within rtol/atol 1e-5 of the reference's Pallas
``paged_decode_attention`` in interpret mode at f32 q (online vs dense
softmax: float32 summation order); at bf16 q the plain version rounds the
softmax weights to bf16 where the Pallas kernel keeps them in f32, so it
is held to one bf16 rounding (2^-7).  ``test_kernel_matches_plain_on_card``
and ``test_append_kernel_matches_plain_on_card`` need the GPU (marker
``cuda``) and hold K6's split-walk kernels and K5's lane-group append to
the plain versions there; the machine with the GPU has no JAX, so the JAX
imports are optional and only the card tests run there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.kernels import kv_cache as jkv
    from repro.kernels import paged_kv as jpkv
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402
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


def _shuffled_table(rng, b, pmax, idle=()):
    """(b, pmax) table over a seeded shuffle of pages 1..b*pmax; ``idle``
    slots point every entry at trash page 0."""
    table = (1 + rng.permutation(b * pmax)).reshape(b, pmax).astype(np.int32)
    table[list(idle)] = 0
    return table


@pytest.mark.parametrize("t", [1, 3, 9])
def test_flat_dst_rows_and_gather_match_reference(t):
    rng = np.random.default_rng(1)
    b, pmax, ps = 4, 3, 4
    table = _shuffled_table(rng, b, pmax, idle=[2])
    table[3, 2] = 0                              # unallocated tail entry
    pos = np.asarray([0, 5, 40, 7], np.int32)    # slot 2 runs past Pmax*ps
    want = jpkv.flat_dst_rows_chunk(jnp.asarray(table), jnp.asarray(pos), t,
                                    ps)
    got = tpkv.flat_dst_rows_chunk(torch.from_numpy(table),
                                   torch.from_numpy(pos), t, ps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpkv.flat_dst_rows(torch.from_numpy(table), torch.from_numpy(pos),
                           ps).numpy(),
        np.asarray(jpkv.flat_dst_rows(jnp.asarray(table), jnp.asarray(pos),
                                      ps)))
    pool = rng.normal(0, 1, ((1 + b * pmax) * ps, 2, 3)).astype(np.float32)
    bad = table.copy()
    bad[0, 0], bad[1, 1] = -2, 99                # clipped to the pool
    for tb in (table, bad):
        np.testing.assert_array_equal(
            tpkv.gather_pages(torch.from_numpy(pool), torch.from_numpy(tb),
                              ps).numpy(),
            np.asarray(jpkv.gather_pages(jnp.asarray(pool), jnp.asarray(tb),
                                         ps)))


@pytest.mark.parametrize("name,packed", FMTS)
@pytest.mark.parametrize("t", [1, 5])
def test_paged_append_rows_bit_exact(name, packed, t):
    """In-place append at table-addressed rows, incl. a page boundary
    inside the chunk; rows not written keep their (random) contents; two
    idle slots write trash page 0, which is not compared."""
    rng = np.random.default_rng(2)
    fj, ft = jformats.get(name), tformats.get(name)
    b, h, hd, ps, pmax = 4, 2, 16, 4, 3
    r = (1 + b * pmax) * ps
    dc = tkv.code_channels(hd, ft, packed)
    hi = 1 << (16 if fj.bits == 16 else 8)       # any stored byte/word
    kc = rng.integers(0, hi, (r, h, dc)).astype(fj.np_storage_dtype)
    vc = rng.integers(0, hi, (r, h, dc)).astype(fj.np_storage_dtype)
    ks = np.exp2(rng.integers(-4, 4, (r, h))).astype(np.float32)
    vs = np.exp2(rng.integers(-4, 4, (r, h))).astype(np.float32)
    table = _shuffled_table(rng, b, pmax, idle=[1, 3])
    pos = np.asarray([2, 0, 6, 30], np.int32)
    dst = np.array(jpkv.flat_dst_rows_chunk(
        jnp.asarray(table), jnp.asarray(pos), t, ps))
    kn, vn = _rows(rng, (b, t, h, hd)), _rows(rng, (b, t, h, hd))
    want = jpkv.paged_kv_append_rows(
        jnp.asarray(kc), jnp.asarray(ks), jnp.asarray(vc), jnp.asarray(vs),
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(dst), fj,
        packed=packed, interpret=True)
    live = slice(ps, None)                       # every row but page 0
    for fn in (tpkv.paged_kv_append_rows_ref, tpkv.paged_kv_append_rows):
        bufs = [_t(kc), _t(ks), _t(vc), _t(vs)]
        got = fn(*bufs, torch.from_numpy(kn), torch.from_numpy(vn),
                 torch.from_numpy(dst), ft, packed=packed)
        for g, buf, wv in zip(got, bufs, want):
            assert g is buf                      # updated in place
            np.testing.assert_array_equal(_np(g)[live], np.asarray(wv)[live])
    if t == 1:       # the T=1 entry points take (B,) destination rows
        for fn in (tpkv.paged_kv_append_ref, tpkv.paged_kv_append):
            bufs = [_t(kc), _t(ks), _t(vc), _t(vs)]
            fn(*bufs, torch.from_numpy(kn), torch.from_numpy(vn),
               torch.from_numpy(dst[:, 0]), ft, packed=packed)
            for g, wv in zip(bufs, want):
                np.testing.assert_array_equal(_np(g)[live],
                                              np.asarray(wv)[live])


def _attention_case(name, packed, q_dtype, seed=3):
    rng = np.random.default_rng(seed)
    fj = jformats.get(name)
    nkv, grp, hd, ps, pmax = 2, 2, 8, 4, 3
    lens = np.asarray([0, 1, ps - 1, ps, ps + 1, pmax * ps], np.int32)
    b = len(lens)
    r = (1 + b * pmax) * ps
    kc, ks = jkv.encode_kv_rows(
        jnp.asarray(rng.normal(0, 1, (r, nkv, hd)).astype(np.float32)), fj,
        packed)
    vc, vs = jkv.encode_kv_rows(
        jnp.asarray(rng.normal(0, 1, (r, nkv, hd)).astype(np.float32)), fj,
        packed)
    table = _shuffled_table(rng, b, pmax)
    table[1, 1:] = 0                             # unallocated tail
    table[4, 2], table[5, 0] = -5, 1 + b * pmax + 7   # out of range
    q = rng.normal(0, 1, (b, 1, nkv * grp, hd)).astype(np.float32)
    jargs = (jnp.asarray(q).astype(q_dtype), kc, ks[..., 0], vc, vs[..., 0],
             jnp.asarray(table), jnp.asarray(lens))
    targs = (torch.from_numpy(q).to(getattr(torch, q_dtype)),
             *[_t(a) for a in (kc, ks[..., 0], vc, vs[..., 0])],
             torch.from_numpy(table), torch.from_numpy(lens))
    return jargs, targs, ps


@pytest.mark.parametrize("name,packed", FMTS)
def test_paged_decode_attention_f32_q(name, packed):
    """seq_lens {0, 1, ps-1, ps, ps+1, Pmax*ps}, a shuffled table with
    unallocated and out-of-range entries: against the Pallas kernel and
    the reference's plain version."""
    jargs, targs, ps = _attention_case(name, packed, "float32")
    fj, ft = jformats.get(name), tformats.get(name)
    wants = [jpkv.paged_decode_attention(*jargs, fj, page_size=ps,
                                         packed=packed, interpret=True),
             jpkv.paged_decode_attention_ref(*jargs, fj, page_size=ps,
                                             packed=packed)]
    for fn in (tpkv.paged_decode_attention_ref, tpkv.paged_decode_attention):
        got = fn(*targs, ft, page_size=ps, packed=packed)
        assert got.dtype == torch.float32 and got.shape == targs[0].shape
        for want in wants:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,packed", FMTS)
def test_paged_decode_attention_bf16_q_against_kernel(name, packed):
    jargs, targs, ps = _attention_case(name, packed, "bfloat16")
    fj, ft = jformats.get(name), tformats.get(name)
    want = np.asarray(jpkv.paged_decode_attention(
        *jargs, fj, page_size=ps, packed=packed, interpret=True), np.float32)
    got = tpkv.paged_decode_attention(*targs, ft, page_size=ps,
                                      packed=packed)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=2.0 ** -7, atol=2.0 ** -7)


def test_paged_decode_matches_ring_decode_on_identity_table():
    """The plain K6 over an identity page table reads the same rows as the
    plain K4 over the ring those pages spell out: equal outputs."""
    rng = np.random.default_rng(4)
    ft = tformats.get("posit8_2")
    b, nkv, grp, hd, ps, pmax = 2, 2, 2, 8, 4, 4
    w = ps * pmax
    kc, ks = tkv.encode_kv_rows(torch.from_numpy(
        rng.normal(0, 1, (b, w, nkv, hd)).astype(np.float32)), ft)
    vc, vs = tkv.encode_kv_rows(torch.from_numpy(
        rng.normal(0, 1, (b, w, nkv, hd)).astype(np.float32)), ft)
    q = torch.from_numpy(rng.normal(0, 1, (b, 1, nkv * grp, hd)).astype(
        np.float32))
    lens = torch.tensor([5, 16], dtype=torch.int32)
    ring = tkv.decode_attention_ref(q, kc, ks[..., 0], vc, vs[..., 0], lens,
                                    ft)
    # pool = one trash page, then slot 0's pages, then slot 1's
    pool = [torch.cat([torch.zeros_like(a[0, :ps]), a.reshape(
        (b * w,) + a.shape[2:])]) for a in (kc, ks[..., 0], vc, vs[..., 0])]
    table = (1 + torch.arange(b * pmax, dtype=torch.int32)).reshape(b, pmax)
    paged = tpkv.paged_decode_attention_ref(q, *pool, table, lens, ft,
                                            page_size=ps)
    torch.testing.assert_close(paged, ring, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """K6's split walk and combine against the plain version on the card:
    seq_lens at every page and split boundary (-1, 0, 1, ps - 1, ps,
    ps + 1, R - 1, R, R + 1, Pmax * ps for R = SPLIT_ROWS), page sizes 8
    and 16, out-of-range table entries, posit16/8 and packed posit4; f32 q
    within rtol/atol 1e-5, bf16 q (output bf16) within one bf16 rounding of
    the plain version on the same q values in f32 (hd^-0.5 = 1/8 scales
    bf16 exactly, and the plain version would round its softmax weights
    to bf16); one launch per call, and an unsupported head dim raises
    before any."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    sr = tpkv.SPLIT_ROWS
    nkv, grp, hd = 2, 3, 64
    w = 2 * sr
    for name, packed in FMTS:
        ft = tformats.get(name)
        for ps in (8, 16):
            pmax = w // ps
            lens = torch.tensor([-1, 0, 1, ps - 1, ps, ps + 1, sr - 1, sr,
                                 sr + 1, w], dtype=torch.int32, device=dev)
            b = len(lens)
            num_pages = 1 + b * pmax
            pool = []
            for _ in range(2):
                mag = np.exp2(rng.uniform(-2, 2, (num_pages * ps, nkv, 1)))
                c, sc = tkv.encode_kv_rows(torch.from_numpy((rng.normal(
                    0, 1, (num_pages * ps, nkv, hd)) * mag).astype(
                        np.float32)), ft, packed)
                pool += [c.to(dev), sc[..., 0].contiguous().to(dev)]
            table = torch.from_numpy(_shuffled_table(rng, b, pmax)).to(dev)
            table[2, pmax // 2:] = 0
            table[8, 0], table[9, -1] = -3, num_pages + 5
            q = torch.from_numpy(rng.normal(0, 1, (b, 1, nkv * grp, hd))
                                 .astype(np.float32)).to(dev)
            for qd, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -8)):
                want = tpkv.paged_decode_attention_ref(
                    q.to(qd).float(), *pool, table, lens, ft, page_size=ps,
                    packed=packed)
                before = LAUNCHES["paged_decode_attention"]
                got = tpkv.paged_decode_attention(
                    q.to(qd), *pool, table, lens, ft, page_size=ps,
                    packed=packed)
                assert LAUNCHES["paged_decode_attention"] == before + 1
                assert got.dtype == qd and got.shape == q.shape
                torch.testing.assert_close(got.float(), want, rtol=rtol,
                                           atol=1e-5)
    before = LAUNCHES["paged_decode_attention"]
    c, sc = tkv.encode_kv_rows(torch.zeros(16, 2, 48), tformats.POSIT8_2)
    with pytest.raises(ValueError, match="head dim"):
        tpkv.paged_decode_attention(
            torch.zeros(1, 1, 2, 48, device=dev), c.to(dev),
            sc[..., 0].contiguous().to(dev), c.to(dev),
            sc[..., 0].contiguous().to(dev),
            torch.ones(1, 4, dtype=torch.int32, device=dev),
            torch.tensor([3], dtype=torch.int32, device=dev),
            tformats.POSIT8_2, page_size=4)
    assert LAUNCHES["paged_decode_attention"] == before


@pytest.mark.cuda
def test_append_kernel_matches_plain_on_card():
    """K5 against the plain version on the card, bit-exact on every row
    past trash page 0 and untouched elsewhere: f32 rows and the model's
    bf16 rows (v a strided view of a fused QKV output), T = 1 and 5 over a
    page boundary, idle slots on the trash page, posit16/8 and packed
    posit4, hd 64 (lane groups of 16 and 8) and f32 hd 256 (two loads per
    lane); one launch per call, and unsupported rows raise before any."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    b, h, ps, pmax = 4, 2, 4, 3
    r = (1 + b * pmax) * ps
    table = torch.from_numpy(_shuffled_table(rng, b, pmax, idle=[1])).to(dev)
    pos = torch.tensor([2, 0, 6, 3], dtype=torch.int32, device=dev)
    for name, packed in FMTS:
        ft = tformats.get(name)
        for hd, dtypes in ((64, (torch.float32, torch.bfloat16)),
                           (256, (torch.float32,))):
            dc = tkv.code_channels(hd, ft, packed)
            for t in (1, 5):
                dst = tpkv.flat_dst_rows_chunk(table, pos, t, ps)
                hi = 1 << (16 if ft.bits == 16 else 8)
                codes = torch.from_numpy(rng.integers(0, hi, (2, r, h, dc)))
                if ft.bits == 16:
                    codes = torch.where(codes >= 1 << 15, codes - hi, codes)
                codes = codes.to(tpkv._build.code_dtype(ft)).to(dev)
                scales = torch.exp2(torch.from_numpy(rng.integers(
                    -4, 4, (2, r, h))).float()).to(dev)
                bufs = (codes[0], scales[0], codes[1], scales[1])
                x = torch.from_numpy(_rows(rng, (b, t, h, 3 * hd))).to(dev)
                for xd in dtypes:
                    kv = x.to(xd)
                    kn, vn = kv[..., hd:2 * hd].contiguous(), kv[..., 2 * hd:]
                    want = tpkv.paged_kv_append_rows_ref(
                        *[a.clone() for a in bufs], kn, vn, dst, ft, packed)
                    before = LAUNCHES["paged_kv_append_rows"]
                    got = tpkv.paged_kv_append_rows(
                        *[a.clone() for a in bufs], kn, vn, dst, ft,
                        packed=packed)
                    assert LAUNCHES["paged_kv_append_rows"] == before + 1
                    for g, w_ in zip(got, want):
                        assert torch.equal(g[ps:], w_[ps:]), (name, hd, t, xd)
    before = LAUNCHES["paged_kv_append_rows"]
    ft = tformats.POSIT8_2
    c = torch.zeros(r, h, 48, dtype=torch.uint8, device=dev)
    sc = torch.ones(r, h, device=dev)
    dst = torch.ones(b, 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        tpkv.paged_kv_append_rows(c, sc, c, sc, torch.zeros(
            b, 1, h, 48, device=dev), torch.zeros(b, 1, h, 48, device=dev),
            dst, ft)
    c = torch.zeros(r, h, 64, dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        x16 = torch.zeros(b, 1, h, 64, dtype=torch.float16, device=dev)
        tpkv.paged_kv_append_rows(c, sc, c, sc, x16, x16, dst, ft)
    assert LAUNCHES["paged_kv_append_rows"] == before
