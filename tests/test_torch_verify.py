"""The verify half of speculative decoding in the PyTorch port vs the JAX
package, on paper-edge smoke at float32 under ``paper_edge_p8`` weights.

* ``draft_policy`` derives the reference's fields.
* ``verify_step`` (B = 2, T = 4, after a bucketed prefill and one decode
  step) against the reference's, ring and paged, posit8 / posit16 / f32
  KV: logits within rtol 1e-4, atol 1e-5 (1e-4 with posit16, whose codes
  may flip by one step where the frameworks' f32 K/V differ in the last
  bit: ROADMAP fault 3); posit8 codes and every scale bit-exact, posit16
  codes within one step on under 1 % of values, f32 K/V within 1e-5
  (the helpers of ``test_torch_serve`` / ``test_torch_paged_serve``): in
  ``test_torch_verify_{ring,paged}.py``, on this file's helpers.
* ``verify_step`` against T sequential ``decode_step`` calls in the port
  itself: logits and every cache leaf bit-identical on the CPU (the
  verify's GEMMs at M = B*T give the same bits as decode's at M = B here).
* ``rollback_ring_cache`` / ``rollback_paged_cache`` bit-exact against
  the reference's on the same cache and indices.
* On the card (marker ``cuda``): K3 and K5 at T = gamma + 1 from bf16 rows
  with per-slot ``pos``, and the verify's K1 read, against the plain
  versions.  The machine with the GPU has no JAX, so the JAX imports are
  optional and only the card test runs there.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp
    from repro.core.transprecision import BF16 as J_BF16
    from repro.core.transprecision import draft_policy as j_draft_policy
    from repro.core.transprecision import get_policy as j_get_policy
    from repro.models import serve_model as jsm
    from repro.serve import engine_api as japi
    from test_torch_paged_serve import _check_pool
    from test_torch_serve import (_J_DECODE, _J_PREFILL, _check_cache_f32,
                                  _f32, smoke_pair)
    _J_VERIFY = jax.jit(jsm.verify_step, static_argnums=(3, 4))
except ImportError:      # the GPU machine: only the card test runs there
    jax = None
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core.transprecision import BF16 as T_BF16  # noqa: E402
from repro_torch.core.transprecision import draft_policy as t_draft_policy  # noqa: E402
from repro_torch.core.transprecision import get_policy as t_get_policy  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.kernels import paged_kv as tpkv  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from repro_torch.serve import engine_api as tapi  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PS, MAX_LEN, T = 4, 32, 4


@functools.lru_cache(maxsize=None)
def _pair(dtype_name):
    return smoke_pair(dtype_name)


@pytest.fixture(scope="module")
def pair():
    return _pair("float32")


def _clone(cache):
    return {k: (tuple({n: t.clone() for n, t in b.items()} for b in v)
                if k == "blocks" else v.clone()) for k, v in cache.items()}


def _policies(kv_format, layout):
    kw = dict(kv_format=kv_format, kv_layout=layout, kv_page_size=PS)
    return (dataclasses.replace(j_get_policy("paper_edge_p8"), **kw),
            dataclasses.replace(t_get_policy("paper_edge_p8"), **kw))


# ---------------------------------------------------------------------------
# draft_policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["bf16", "paper_edge_p8", "overrides"])
@pytest.mark.parametrize("fmts", [("posit8_2", "posit8"),
                                  ("posit16_2", "posit16")])
def test_draft_policy_matches_reference(target, fmts):
    if target == "overrides":
        kw = dict(kv_format="f32", kv_layout="paged", name="tgt",
                  layer_overrides=((0, "mlp_weights", "posit16_2"),))
        jt, tt = (dataclasses.replace(J_BF16, **kw),
                  dataclasses.replace(T_BF16, **kw))
    else:
        jt, tt = j_get_policy(target), t_get_policy(target)
    j = j_draft_policy(jt, weights_fmt=fmts[0], kv_format=fmts[1])
    t = t_draft_policy(tt, weights_fmt=fmts[0], kv_format=fmts[1])
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.kv_layout == "ring" and t.layer_overrides == ()
    assert t.embed_weights == (tt.embed_weights or "posit16_2")
    assert t_draft_policy("bf16").name == "bf16+draft_posit8"


# ---------------------------------------------------------------------------
# verify_step
# ---------------------------------------------------------------------------

def _prefilled(pair, jpol, tpol):
    """Both packages' caches after a bucketed prefill (true lengths 11 and
    16) and one decode step, so the slots sit at different positions."""
    jc, tc, jp, tp = pair
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tc.vocab, (2, 16))
    true_len = np.array([11, 16], np.int32)
    _, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                           MAX_LEN, jpol, true_len=jnp.asarray(true_len))
    _, tcache = tsm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                            MAX_LEN, tpol, true_len=torch.from_numpy(true_len))
    tok = rng.integers(0, tc.vocab, (2, 1))
    _, jcache = _J_DECODE(jp, jcache, jnp.asarray(tok, jnp.int32), jc, jpol)
    _, tcache = tsm.decode_step(tp, tcache, torch.from_numpy(tok), tc, tpol)
    return jcache, tcache, rng.integers(0, tc.vocab, (2, T))


def check_verify(pair, layout, kv_format):
    """``verify_step`` against the reference's on the same prefilled
    cache: logits, ``pos`` and the cache leaves."""
    jc, tc, jp, tp = pair
    jpol, tpol = _policies(kv_format, layout)
    jcache, tcache, chunk = _prefilled(pair, jpol, tpol)
    jl, jcache = _J_VERIFY(jp, jcache, jnp.asarray(chunk, jnp.int32), jc,
                           jpol)
    tl, tcache = tsm.verify_step(tp, tcache, torch.from_numpy(chunk), tc,
                                 tpol)
    assert tuple(tl.shape) == (2, T, tc.vocab_pad)
    atol = 1e-4 if kv_format == "posit16" else 1e-5
    np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=atol)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["pos"].tolist() == [12 + T, 17 + T]
    if layout == "paged":
        _check_pool(jcache, tcache, kv_format)
    else:
        _check_cache_f32(jcache, tcache, kv_format)


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("kv_format", ["posit8", "posit4", "f32"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_verify_step_equals_sequential_decode(layout, kv_format, dtype_name):
    """One (B, T) verify pass == T decode_step calls: logits and every cache
    leaf bit-identical on the CPU, B = 3 slots at three positions."""
    _, tc, _, tp = _pair(dtype_name)
    _, pol = _policies(kv_format, layout)
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, tc.vocab, (3, 12)))
    _, cache = tsm.prefill(tp, {"tokens": toks}, tc, MAX_LEN, pol,
                           true_len=torch.tensor([5, 12, 9]))
    cache2 = _clone(cache)
    chunk = torch.from_numpy(rng.integers(0, tc.vocab, (3, T + 1)))
    seq = []
    for t in range(T + 1):
        lg, cache = tsm.decode_step(tp, cache, chunk[:, t:t + 1], tc, pol)
        seq.append(lg)
    lv, cache2 = tsm.verify_step(tp, cache2, chunk, tc, pol)
    assert torch.equal(lv, torch.stack(seq, 1))
    assert torch.equal(cache["pos"], cache2["pos"])
    for name, leaf in cache["blocks"][0].items():
        assert torch.equal(leaf, cache2["blocks"][0][name]), name


def test_verify_step_refuses_unrewindable_configs(pair):
    """The reference's refusals, on configs the port cannot build (its
    ModelCfg is dense only), forced onto a copy."""
    tc, tp = pair[1], pair[3]
    _, pol = _policies("posit8", "ring")
    cache = tsm.init_cache(tc, 1, 8, policy=pol, device="cpu")
    for field, value, match in (("family", "moe", "MoE"),
                                ("family", "audio", "encoder-decoder"),
                                ("window", 4, "sliding-window"),
                                ("block_types", ("attn", "rec"),
                                 "attention-only")):
        cfg = dataclasses.replace(tc)
        object.__setattr__(cfg, field, value)
        with pytest.raises(ValueError, match=match):
            tsm.verify_step(tp, cache, torch.zeros((1, 2), dtype=torch.int64),
                            cfg, pol)


# ---------------------------------------------------------------------------
# Rollback
# ---------------------------------------------------------------------------

def _random_blocks(rng, lead, kv_format):
    """Stacked cache leaves (lead + (nkv, Dc | hd)) of random content."""
    nkv, hd = 2, 16
    if kv_format == "f32":
        return {n: rng.normal(0, 1, lead + (nkv, hd)).astype(np.float32)
                for n in ("k", "v")}
    return {"k": rng.integers(0, 256, lead + (nkv, hd)).astype(np.uint8),
            "v": rng.integers(0, 256, lead + (nkv, hd)).astype(np.uint8),
            "k_scale": np.exp2(rng.integers(-4, 4, lead + (nkv,))).astype(
                np.float32),
            "v_scale": np.exp2(rng.integers(-4, 4, lead + (nkv,))).astype(
                np.float32)}


def _both(blocks, pos):
    jcache = {"pos": jnp.asarray(pos, jnp.int32),
              "blocks": ({n: jnp.asarray(a) for n, a in blocks.items()},)}
    tcache = {"pos": torch.from_numpy(np.asarray(pos, np.int32)),
              "blocks": ({n: torch.from_numpy(a.copy())
                          for n, a in blocks.items()},)}
    return jcache, tcache


def _assert_same(jcache, tcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert tcache["pos"].dtype == torch.int32
    for name, leaf in jcache["blocks"][0].items():
        np.testing.assert_array_equal(tcache["blocks"][0][name].numpy(),
                                      np.asarray(leaf), err_msg=name)


@pytest.mark.parametrize("kv_format", ["posit8", "f32"])
def test_rollback_ring_matches_reference(kv_format):
    """Slots that keep part of the window, keep all of it (scrub_from ==
    window_end), are idle (window_end < t, floored at t) or sit at the
    ring's end."""
    rng = np.random.default_rng(5)
    p, b, w, t = 2, 4, 16, 5
    blocks = _random_blocks(rng, (p, b, w), kv_format)
    jcache, tcache = _both(blocks, [12, 9, 5, 16])
    new_pos = np.array([9, 9, 0, 13])
    window_end = np.array([12, 9, 2, 16])
    scrub_from = np.array([9, 9, 2, 13])
    jcache = japi.rollback_ring_cache(jcache, new_pos, window_end,
                                      scrub_from, t)
    out = tapi.rollback_ring_cache(tcache, new_pos, window_end, scrub_from,
                                   t)
    assert out is tcache                         # in place
    _assert_same(jcache, tcache)


@pytest.mark.parametrize("kv_format", ["posit8", "f32"])
def test_rollback_paged_matches_reference(kv_format):
    """Pool rows scrubbed, padding on trash row 0."""
    rng = np.random.default_rng(6)
    p, r = 2, 10 * PS
    blocks = _random_blocks(rng, (p, r), kv_format)
    jcache, tcache = _both(blocks, [7, 30])
    scrub = np.array([13, 14, 15, 33, 0, 0, 0, 0])
    new_pos = np.array([5, 21])
    jcache = japi.rollback_paged_cache(jcache, new_pos, scrub)
    tapi.rollback_paged_cache(tcache, new_pos, scrub)
    _assert_same(jcache, tcache)


# ---------------------------------------------------------------------------
# On the card: the speculative shapes of K3, K5 and the K1 read
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_verify_kernels_match_plain_on_card():
    """K3 and K5 at T = gamma + 1 in 2..5 from bf16 rows with per-slot
    ``pos`` (K3 wrapping the ring), bit-exact against their plain versions
    (K5 past trash page 0, where idle slots collide); the verify's read
    through K1 (``decode_kv_rows_device``, ``gather_decode_pages_device``)
    bit-exact against ``decode_kv_rows`` / ``gather_decode_pages``, posit8,
    posit16 and packed posit4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    rng = np.random.default_rng(23)
    b, w, h, hd, ps, pmax = 4, 32, 4, 64, 4, 8
    r = (1 + b * pmax) * ps
    pos = torch.tensor([0, 7, 29, 13], dtype=torch.int32, device=dev)
    table = torch.from_numpy(1 + rng.permutation(b * pmax).reshape(
        b, pmax).astype(np.int32)).to(dev)
    table[2] = 0                                  # an idle slot
    for name, packed in (("posit8_2", False), ("posit16_2", False),
                         ("posit4_1", True)):
        fmt = tformats.get(name)
        dc = tkv.code_channels(hd, fmt, packed)
        for t in (2, 3, 4, 5):
            qkv = torch.from_numpy(rng.normal(0, 2, (b, t, 3 * h, hd)).astype(
                np.float32)).to(dev).to(torch.bfloat16)
            k_new, v_new = qkv[:, :, :h], qkv[:, :, 2 * h:]   # strided rows
            for lead, fn, ref, index in (
                    ((b, w), tkv.kv_append_rows, tkv.kv_append_rows_ref, pos),
                    ((r,), tpkv.paged_kv_append_rows,
                     tpkv.paged_kv_append_rows_ref,
                     tpkv.flat_dst_rows_chunk(table, pos, t, ps))):
                codes = torch.zeros(lead + (h, dc), dtype=fmt.storage_dtype,
                                    device=dev)
                scales = torch.ones(lead + (h,), device=dev)
                got = [x.clone() for x in (codes, scales, codes, scales)]
                want = [x.clone() for x in got]
                before = LAUNCHES[fn.__name__]
                fn(*got, k_new, v_new, index, fmt, packed=packed)
                assert LAUNCHES[fn.__name__] == before + 1
                ref(*want, k_new.float(), v_new.float(), index, fmt, packed)
                cut = ps if len(lead) == 1 else 0
                for g_, w_ in zip(got, want):
                    assert torch.equal(g_[cut:], w_[cut:]), (name, t)
                # the verify's read of what was written, through K1
                before = LAUNCHES["posit_decode"]
                if cut:
                    read = tpkv.gather_decode_pages_device(
                        want[0], want[1], table, ps, fmt, packed)
                    plain = tpkv.gather_decode_pages(want[0], want[1], table,
                                                     ps, fmt, packed)
                else:
                    read = tkv.decode_kv_rows_device(
                        want[0], want[1][..., None], fmt, packed)
                    plain = tkv.decode_kv_rows(want[0], want[1][..., None],
                                               fmt, packed)
                assert LAUNCHES["posit_decode"] == before + 1
                assert torch.equal(read, plain), (name, t)
        # ... and of random codes (NaR included) through a table
        pool_c = torch.from_numpy(rng.integers(0, 256, (r, h, dc)).astype(
            np.uint8)).to(dev)
        if fmt.bits == 16:
            pool_c = torch.from_numpy(rng.integers(
                -2 ** 15, 2 ** 15, (r, h, dc)).astype(np.int16)).to(dev)
        pool_s = torch.from_numpy(np.exp2(rng.integers(
            -6, 6, (r, h))).astype(np.float32)).to(dev)
        got = tpkv.gather_decode_pages_device(pool_c, pool_s, table, ps, fmt,
                                              packed)
        want = tpkv.gather_decode_pages(pool_c, pool_s, table, ps, fmt,
                                        packed)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
