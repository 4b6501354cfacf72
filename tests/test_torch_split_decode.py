"""The arithmetic of K4's and K6's split walk, checked on the CPU.

On the card K4 (ring) and K6 (paged) cut each (slot, kv-head)'s logical
rows into splits of R rows, one CTA each: a split past the live length
does nothing, a live one keeps a plain softmax over its rows and writes
(m, l, acc), and a second kernel merges a slot's live splits with
log-sum-exp weights.  The two differ only in how logical row j finds its
entry: ring row j of the slot, or row j % ps of page table[j // ps].
Masked slots (length <= 0) score every one of the W listed rows (the
ring's width, or Pmax * ps) with the finite -1e30, so every split weighs
them equally and the merge gives the mean of V, trash page included.  A
plain model of exactly that is held to the port's and the reference's
plain versions within rtol/atol 1e-5 (f32 summation order): for pages
(``paged_decode_attention_ref``) on ``seq_lens`` at every split and page
boundary, page sizes 8 and 16, out-of-range table entries; for the ring
(``decode_attention_ref``) on ``cache_len`` at every split boundary, 0,
negative and above W, rings of 4 R and of 100 rows (a partial last
split), f32 and bf16 q; posit8 and nibble-packed posit4 in both.  The
split walk's contract and geometry (``split_geometry``, shared by both
wrappers) is checked here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.kernels import kv_cache as jkv  # noqa: E402
from repro.kernels import paged_kv as jpkv  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

NEG_INF = -1e30
R = 64                  # split rows of the model (a multiple of 64)
W = 4 * R               # Pmax * ps listed rows per slot
NKV, GRP, HD = 2, 2, 16


def split_walk_model(q, k, v, lens, split_rows):
    """The split walk over decoded logical rows k, v (B, W, nkv, hd) f32:
    per (slot, kv-head) the live R-row splits, each a softmax over its rows
    giving (m, l, acc), merged with weights exp(m_s - max m).  q is scaled
    by hd^-0.5 in its own dtype, as the kernels do; the output is f32."""
    b, w, nkv, hd = k.shape
    grp = q.shape[2] // nkv
    qg = (q.reshape(b, nkv, grp, hd) * hd ** -0.5).to(torch.float32)
    out = torch.empty((b, nkv, grp, hd), dtype=torch.float32)
    for bi in range(b):
        masked = int(lens[bi]) <= 0
        live = w if masked else min(int(lens[bi]), w)
        parts = []
        for r0 in range(0, live, split_rows):
            rows = slice(r0, min(r0 + split_rows, live))
            s = torch.einsum("kgd,jkd->kgj", qg[bi], k[bi, rows])
            if masked:
                s = torch.full_like(s, NEG_INF)
            m = s.max(dim=-1).values
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1),
                          torch.einsum("kgj,jkd->kgd", p, v[bi, rows])))
        mx = torch.stack([m for m, _, _ in parts]).max(dim=0).values
        l_sum = torch.zeros_like(mx)
        acc = torch.zeros((nkv, grp, hd), dtype=torch.float32)
        for m, l_s, a in parts:              # split order, as the combine
            wgt = torch.exp(m - mx)
            l_sum = l_sum + wgt * l_s
            acc = acc + wgt[..., None] * a
        out[bi] = acc / torch.clamp(l_sum, min=1e-30)[..., None]
    return out.reshape(b, 1, nkv * grp, hd)


def split_decode_model(q, k_codes, k_scale, v_codes, v_scale, page_table,
                       seq_lens, fmt, *, page_size, packed, split_rows):
    """K6 as the card computes it: the split walk over the page list."""
    k = tpkv.gather_decode_pages(k_codes, k_scale, page_table, page_size,
                                 fmt, packed)          # (B, W, nkv, hd)
    v = tpkv.gather_decode_pages(v_codes, v_scale, page_table, page_size,
                                 fmt, packed)
    return split_walk_model(q, k, v, seq_lens, split_rows)


def ring_split_model(q, k_codes, k_scale, v_codes, v_scale, cache_len, fmt,
                     *, packed, split_rows):
    """K4 as the card computes it: the split walk over ring rows 0..W-1 of
    each slot (no table: logical row j is ring row j)."""
    k = tkv.decode_kv_rows(k_codes, k_scale[..., None], fmt, packed)
    v = tkv.decode_kv_rows(v_codes, v_scale[..., None], fmt, packed)
    return split_walk_model(q, k, v, cache_len, split_rows)


def _case(name, packed, ps, seed):
    """Slots at every boundary; a seeded shuffled table with an
    unallocated tail and entries out of range on both sides."""
    rng = np.random.default_rng(seed)
    fj = jformats.get(name)
    pmax = W // ps
    lens = np.asarray([-1, 0, 1, ps - 1, ps, ps + 1, R - 1, R, R + 1, W],
                      np.int32)
    b = len(lens)
    num_pages = 1 + b * pmax
    r = num_pages * ps
    pool = []
    for _ in range(2):
        mag = np.exp2(rng.uniform(-2, 2, (r, NKV, 1)))
        c, s = jkv.encode_kv_rows(jnp.asarray(
            (rng.normal(0, 1, (r, NKV, HD)) * mag).astype(np.float32)), fj,
            packed)
        pool += [np.array(c), np.array(s[..., 0])]
    table = (1 + rng.permutation(b * pmax)).reshape(b, pmax).astype(np.int32)
    table[2, pmax // 2:] = 0                     # unallocated tail
    table[8, 0], table[9, pmax - 1] = -3, num_pages + 5
    table[0, 1] = 10_000                          # a masked slot reads it
    q = rng.normal(0, 1, (b, 1, NKV * GRP, HD)).astype(np.float32)
    jargs = (jnp.asarray(q), *[jnp.asarray(a) for a in pool],
             jnp.asarray(table), jnp.asarray(lens))
    targs = (torch.from_numpy(q), *[torch.from_numpy(a) for a in pool],
             torch.from_numpy(table), torch.from_numpy(lens))
    return fj, tformats.get(name), jargs, targs


@pytest.mark.parametrize("ps", [8, 16])
@pytest.mark.parametrize("name,packed", [("posit8_2", False),
                                         ("posit4_1", True)])
def test_split_walk_model_vs_plain_and_jax(name, packed, ps):
    fj, ft, jargs, targs = _case(name, packed, ps, seed=ps)
    got = split_decode_model(*targs, ft, page_size=ps, packed=packed,
                             split_rows=R)
    plain = tpkv.paged_decode_attention_ref(*targs, ft, page_size=ps,
                                            packed=packed)
    ref = np.asarray(jpkv.paged_decode_attention_ref(*jargs, fj,
                                                     page_size=ps,
                                                     packed=packed))
    assert torch.isfinite(got).all()
    for want in (plain.numpy(), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("split_rows", [64, 128, 256])
def test_split_count_does_not_change_the_result(split_rows):
    """One split or many: the merge reproduces the single softmax."""
    _, ft, _, targs = _case("posit8_2", False, 16, seed=5)
    got = split_decode_model(*targs, ft, page_size=16, packed=False,
                             split_rows=split_rows)
    one = split_decode_model(*targs, ft, page_size=16, packed=False,
                             split_rows=W)
    np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_masked_slot_is_the_mean_of_every_listed_row():
    """seq_lens <= 0: each split weighs its rows equally, the merge gives
    the mean of V over all Pmax * ps listed rows (clipped entries and
    trash included)."""
    _, ft, _, targs = _case("posit8_2", False, 8, seed=6)
    got = split_decode_model(*targs, ft, page_size=8, packed=False,
                             split_rows=R)
    v = tpkv.gather_decode_pages(targs[3], targs[4], targs[5], 8, ft)
    for bi in (0, 1):                               # seq_lens -1 and 0
        want = v[bi].mean(dim=0).repeat_interleave(GRP, dim=0)
        np.testing.assert_allclose(got[bi, 0].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# K4: the same walk over ring rows
# ---------------------------------------------------------------------------

def _ring_case(name, packed, w, seed):
    """A (B, w) ring of posit K/V rows with per-row scales over 2^-2..2^2;
    one slot per cache_len at a split boundary, 0, negative or above w."""
    rng = np.random.default_rng(seed)
    fj = jformats.get(name)
    lens = sorted({-2, 0, 1, R - 1, R, R + 1, 2 * R - 1, 2 * R, 2 * R + 1,
                   w - 1, w, w + 1, 3 * w})
    lens = np.asarray(lens, np.int32)
    b = len(lens)
    ring = []
    for _ in range(2):
        mag = np.exp2(rng.uniform(-2, 2, (b, w, NKV, 1)))
        c, sc = jkv.encode_kv_rows(jnp.asarray(
            (rng.normal(0, 1, (b, w, NKV, HD)) * mag).astype(np.float32)),
            fj, packed)
        ring += [np.array(c), np.array(sc[..., 0])]
    q = rng.normal(0, 1, (b, 1, NKV * GRP, HD)).astype(np.float32)
    return fj, tformats.get(name), q, ring, lens


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [W, 100])
@pytest.mark.parametrize("name,packed", [("posit8_2", False),
                                         ("posit4_1", True)])
def test_ring_split_walk_model_vs_plain_and_jax(name, packed, w, q_dtype):
    """A ring of 4 R rows, or of 100 (a partial last split).  bf16 q: the
    model scales q in bf16 as K4 does, the plain versions scale it in f32;
    hd^-0.5 = 1/4 makes both exact, so both get the same q values."""
    fj, ft, q, ring, lens = _ring_case(name, packed, w, seed=w)
    qt = torch.from_numpy(q).to(getattr(torch, q_dtype))
    targs = [torch.from_numpy(a) for a in ring]
    got = ring_split_model(qt, *targs, torch.from_numpy(lens), ft,
                           packed=packed, split_rows=R)
    q32 = qt.to(torch.float32)
    plain = tkv.decode_attention_ref(q32, *targs, torch.from_numpy(lens), ft,
                                     packed)
    ref = np.asarray(jkv.decode_attention_ref(
        jnp.asarray(q32.numpy()), *[jnp.asarray(a) for a in ring],
        jnp.asarray(lens), fj, packed))
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    for want in (plain.numpy(), ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ring_masked_slot_is_the_mean_of_the_ring():
    """cache_len <= 0: the merge gives the mean of V over all W ring rows,
    partial last split included."""
    _, ft, q, ring, lens = _ring_case("posit8_2", False, 100, seed=7)
    targs = [torch.from_numpy(a) for a in ring]
    got = ring_split_model(torch.from_numpy(q), *targs,
                           torch.from_numpy(lens), ft, packed=False,
                           split_rows=R)
    v = tkv.decode_kv_rows(targs[2], targs[3][..., None], ft)
    for bi in np.flatnonzero(lens <= 0):
        want = v[bi].mean(dim=0).repeat_interleave(GRP, dim=0)
        np.testing.assert_allclose(got[bi, 0].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The split walk's contract and geometry, shared by K4 and K6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,row_bytes,grp,listed,want", [
    (64, 64, 3, 1024, (8, 4)),        # posit8, the main path
    (64, 128, 3, 1024, (8, 8)),       # posit16
    (64, 32, 3, 1024, (8, 2)),        # nibble-packed posit4
    (16, 8, 2, 100, (1, 2)),          # 8-B rows: 4-B loads
    (8, 4, 1, 129, (2, 1)),           # 4-B rows: one lane
    (256, 512, 128, 128, (1, 32)),    # the limits
])
def test_split_geometry(hd, row_bytes, grp, listed, want):
    assert tkv.split_geometry("k", hd, row_bytes, grp, torch.bfloat16,
                              listed) == want
    assert tpkv.SPLIT_ROWS is tkv.SPLIT_ROWS


@pytest.mark.parametrize("hd,row_bytes,grp,dtype,err", [
    (64, 48, 3, torch.float32, ValueError),     # not 4 * 2^i bytes
    (64, 2, 3, torch.float32, ValueError),
    (512, 512, 3, torch.float32, ValueError),   # hd > 256
    (256, 1024, 3, torch.float32, ValueError),  # over 512 B
    (64, 64, 129, torch.float32, ValueError),   # grp over 128
    (64, 64, 0, torch.float32, ValueError),
    (64, 64, 3, torch.float16, TypeError),
])
def test_split_geometry_raises(hd, row_bytes, grp, dtype, err):
    with pytest.raises(err):
        tkv.split_geometry("k", hd, row_bytes, grp, dtype, 1024)
