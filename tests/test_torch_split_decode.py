"""The arithmetic of K6's split walk, checked on the CPU.

On the card K6 cuts each (slot, kv-head)'s logical rows into splits of R
rows, one CTA each: a split past the live length does nothing, a live one
keeps a plain softmax over its rows and writes (m, l, acc), and a second
kernel merges a slot's live splits with log-sum-exp weights.  Masked slots
(``seq_lens[b] <= 0``) score every one of the Pmax * ps listed rows with
the finite -1e30, so every split weighs them equally and the merge gives
the mean of V, trash page included.  A plain model of exactly that is held
to the port's ``paged_decode_attention_ref`` and the reference's
``paged_decode_attention_ref`` within rtol/atol 1e-5 (f32 summation
order), on ``seq_lens`` at every split and page boundary, page sizes 8 and
16, out-of-range table entries, posit8 and nibble-packed posit4.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.kernels import kv_cache as jkv  # noqa: E402
from repro.kernels import paged_kv as jpkv  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402

NEG_INF = -1e30
R = 64                  # split rows of the model (a multiple of 64)
W = 4 * R               # Pmax * ps listed rows per slot
NKV, GRP, HD = 2, 2, 16


def split_decode_model(q, k_codes, k_scale, v_codes, v_scale, page_table,
                       seq_lens, fmt, *, page_size, packed, split_rows):
    """K6 as the card computes it: per (slot, kv-head) the live R-row
    splits, each a softmax over its rows giving (m, l, acc), merged with
    weights exp(m_s - max m)."""
    k = tpkv.gather_decode_pages(k_codes, k_scale, page_table, page_size,
                                 fmt, packed)          # (B, W, nkv, hd)
    v = tpkv.gather_decode_pages(v_codes, v_scale, page_table, page_size,
                                 fmt, packed)
    b, w, nkv, hd = k.shape
    grp = q.shape[2] // nkv
    qg = (q.reshape(b, nkv, grp, hd) * hd ** -0.5).to(torch.float32)
    out = torch.empty((b, nkv, grp, hd), dtype=torch.float32)
    for bi in range(b):
        masked = int(seq_lens[bi]) <= 0
        live = w if masked else min(int(seq_lens[bi]), w)
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
