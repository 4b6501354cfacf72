"""K3 (the ring append) on K5's lane groups, checked on the CPU.

On the card K3 is K5's kernel (``kv_rows.cuh`` ``launch_append``) with
another destination: row (b, t) of the (B, T, H, hd) K/V lands at flat ring
row b W + (pos[b] + t) mod W of the (B, W, H, Dc) buffers, the mod a floor
mod computed from one int per slot.  The rows are read in the model's
dtype (f32 or bf16) at their own strides, so v may stay a strided view of
the fused QKV output.  The group model of ``test_torch_append_groups.py``
with that destination is held bit-exact to the port's ``kv_append_rows_ref``
and to the reference's Pallas ``kv_append_rows`` in interpret mode (given
the same values as f32: bf16 -> f32 is exact), for G = 2 to 32 lanes per
row, T = 1 at wrapping positions and T > 1 wrapping inside one call,
packed posit4 included; rows not written keep their contents.  The
wrapper's contract (``append_geometry``, ``_row_strides``) and the serving
engine's check of it at construction run here too; ``test_kernel_on_card``
needs the GPU (marker ``cuda``); the machine with the GPU has no JAX, so
the JAX imports are optional and only the card test runs there.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax.numpy as jnp
    from repro.core import formats as jformats
    from repro.kernels import kv_cache as jkv
    from test_torch_append_groups import _np, _t, group_row_model
except ImportError:      # the GPU machine: only the card test runs there
    jnp = None
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import (ServeConfig, ServingEngine,  # noqa: E402
                                      check_kv_kernels)
from _torch_threads import torch_threads  # noqa: E402,F401

FMTS = [("posit16_2", False), ("posit8_2", False), ("posit4_1", True)]
B, W, H = 2, 8, 2


def ring_row(pos: int, t: int, w: int) -> int:
    """RingDst's row: C's truncating % of pos + t, then + W if negative."""
    r = int(np.fmod(pos + t, w))
    return r + w if r < 0 else r


def ring_append_model(k_codes, k_scale, v_codes, v_scale, k_new, v_new, pos,
                      fmt, packed):
    """K3 on numpy buffers (updated in place): K rows then V rows, in
    (b, t, head) order, each by K5's lane groups."""
    lanes, loads = tkv.append_geometry("model", k_new.shape[-1], k_new.dtype)
    w = k_codes.shape[1]
    for codes, scale, new in ((k_codes, k_scale, k_new),
                              (v_codes, v_scale, v_new)):
        x = new.to(torch.float32).numpy()
        b, t, h, _ = x.shape
        for bi in range(b):
            for ti in range(t):
                row = ring_row(int(pos[bi]), ti, w)
                for hi in range(h):
                    c, s = group_row_model(x[bi, ti, hi], fmt, packed, lanes,
                                           loads)
                    codes[bi, row, hi] = c.astype(codes.dtype)
                    scale[bi, row, hi] = s


def _case(name, packed, hd, x_dtype, t, seed):
    """Random ring (stored words of any value) and K/V rows whose
    magnitudes span several binades; v is a strided view of one fused
    (B, T, H, 3 hd) tensor, as the QKV projection's split leaves it."""
    rng = np.random.default_rng(seed)
    fj = jformats.get(name)
    dc = hd // 2 if packed else hd
    hi = 1 << (16 if fj.bits == 16 else 8)
    bufs = [rng.integers(0, hi, (B, W, H, dc)).astype(fj.np_storage_dtype),
            np.exp2(rng.integers(-4, 4, (B, W, H))).astype(np.float32),
            rng.integers(0, hi, (B, W, H, dc)).astype(fj.np_storage_dtype),
            np.exp2(rng.integers(-4, 4, (B, W, H))).astype(np.float32)]
    mag = np.exp2(rng.uniform(-8, 8, (B, t, H, 3)).repeat(hd, axis=-1))
    fused = torch.from_numpy((rng.normal(0, 1, (B, t, H, 3 * hd)) * mag)
                             .astype(np.float32)).to(x_dtype)
    kn = fused[..., :hd].contiguous()
    vn = fused[..., 2 * hd:]
    return fj, tformats.get(name), bufs, kn, vn


@pytest.mark.parametrize("t,pos", [(1, [7, 13]), (5, [6, 2045])])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [16, 64, 256])
@pytest.mark.parametrize("name,packed", FMTS)
def test_ring_group_model_vs_plain_and_jax(name, packed, hd, x_dtype, t,
                                           pos):
    """hd 16, 64, 256: G = 4, 16, 32 (C = 2 at hd 256) for f32 rows and
    G = 2, 8, 32 for bf16 rows; T = 1 at pos 7 and 13 of W = 8 (13 wraps),
    T = 5 from pos 6 and 2045 (both wrap inside the call)."""
    fj, ft, bufs, kn, vn = _case(name, packed, hd, x_dtype, t, seed=hd + t)
    assert not vn.is_contiguous()
    pos = np.asarray(pos, np.int32)
    got = [np.array(a) for a in bufs]
    ring_append_model(*got, kn, vn, pos, ft, packed)
    plain = [_t(a) for a in bufs]
    tkv.kv_append_rows_ref(*plain, kn, vn, torch.from_numpy(pos), ft, packed)
    want = jkv.kv_append_rows(
        *[jnp.asarray(a) for a in bufs],
        jnp.asarray(kn.to(torch.float32).numpy()),
        jnp.asarray(vn.to(torch.float32).numpy()), jnp.asarray(pos), fj,
        packed=packed, interpret=True)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, _np(p))
        np.testing.assert_array_equal(g, np.asarray(w))
    written = {(bi, ring_row(int(pos[bi]), ti, W))
               for bi in range(B) for ti in range(t)}
    keep = [(bi, r) for bi in range(B) for r in range(W)
            if (bi, r) not in written]
    for g, orig in zip(got, bufs):           # rows not written: untouched
        for bi, r in keep:
            np.testing.assert_array_equal(g[bi, r], orig[bi, r])


@pytest.mark.parametrize("pos,t", [(0, 1), (7, 1), (8, 1), (6, 5),
                                   (2047, 3), (-1, 1), (-9, 2)])
def test_ring_rows_are_the_references(pos, t):
    """RingDst's floor mod against the reference's (pos + t) % W, negative
    positions included."""
    want = (np.int32(pos) + np.arange(t, dtype=np.int32)) % W
    assert [ring_row(pos, ti, W) for ti in range(t)] == want.tolist()


def _ring_bufs(fmt, packed, hd, b=B, w=W):
    dc = tkv.code_channels(hd, fmt, packed)
    codes = torch.zeros((b, w, H, dc), dtype=fmt.storage_dtype)
    scale = torch.ones((b, w, H))
    return codes, scale, codes.clone(), scale.clone()


@pytest.mark.parametrize("hd,dtype,err", [
    (64, torch.float16, TypeError),
    (64, torch.float64, TypeError),
    (48, torch.float32, ValueError),    # not 32 * 2^i bytes
    (48, torch.bfloat16, ValueError),
    (8, torch.bfloat16, ValueError),    # 16 B: one lane, no pairs
])
def test_wrapper_contract_raises_before_launch(hd, dtype, err):
    """What K3's wrapper refuses on the card, through the checks it runs
    before its launch (shared with K5): a dtype other than f32/bf16 and a
    head dim whose rows are not 32 * 2^i bytes."""
    from repro_torch.kernels import LAUNCHES
    ft = tformats.POSIT8_2
    bufs = _ring_bufs(ft, False, hd)
    x = torch.zeros((B, 1, H, hd), dtype=dtype)
    pos = torch.zeros(B, dtype=torch.int32)
    before = dict(LAUNCHES)
    with pytest.raises(err):
        tkv.launch_append("kv_append_rows", "kv_cache", bufs, x, x, pos, W,
                          ft)
    assert LAUNCHES == before


def test_wrapper_refuses_a_misaligned_slice():
    """A prefill passes kp[:, start:start + length]; a slice whose rows do
    not start 16-byte aligned raises (here: rows shifted by one bf16)."""
    hd = 64
    flat = torch.zeros(B * 4 * H * hd + 1, dtype=torch.bfloat16)
    x = flat[1:].reshape(B, 4, H, hd)
    with pytest.raises(ValueError, match="aligned"):
        tkv._row_strides("kv_append_rows", x)
    ok = torch.zeros(B, 10, H, hd, dtype=torch.bfloat16)[:, 3:7]
    assert tkv._row_strides("kv_append_rows", ok) == (10 * H * hd, H * hd,
                                                      hd)


def _cfg(hd: int, dtype_name: str = "bfloat16"):
    cfg = get_config("paper-edge", smoke=True)
    return dataclasses.replace(cfg, d_head=hd, dtype_name=dtype_name)


@pytest.mark.parametrize("kv_format", ["posit16", "posit8", "posit4"])
def test_engine_checks_the_kernel_contracts(kv_format):
    """The check a CUDA engine runs when it is built: hd = 48 (rows of 96
    bf16 bytes, and 48-, 96- or 24-byte rows of codes) is refused, naming
    the contract; hd = 64 passes in bf16 and f32; a float KV cache runs no
    kernel and passes."""
    pol = dataclasses.replace(get_policy("paper_edge_p8"),
                              kv_format=kv_format)
    with pytest.raises(ValueError, match="head dim"):
        check_kv_kernels(_cfg(48), pol, 64)
    check_kv_kernels(_cfg(64), pol, 64)
    check_kv_kernels(_cfg(64, "float32"), pol, 64)
    check_kv_kernels(_cfg(48), dataclasses.replace(pol, kv_format="bf16"),
                     64)


def test_cpu_engine_serves_a_shape_the_card_refuses():
    """On the CPU the plain versions take any even hd, as the reference
    does: the check runs for CUDA engines only."""
    cfg = _cfg(48)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=1, max_len=16,
                                                 kv_format="posit8"),
                        policy="paper_edge_p8", device="cpu")
    assert eng.cache["blocks"][0]["k"].shape[-1] == 48


@pytest.mark.cuda
def test_kernel_on_card():
    """K3 against the plain version on the card: posit16/8 and packed
    posit4, f32 rows and the model's bf16 rows with v a strided view of a
    fused tensor, T = 1 at wrapping positions and T = 12 wrapping inside
    the call, codes and scales bit-exact and rows not written untouched;
    one launch per call; a dtype, head dim or slice the kernel refuses
    raises before any launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    from repro_torch.kernels import LAUNCHES
    dev = torch.device("cuda")
    b, w, h, hd = 4, 64, 4, 64
    rng = np.random.default_rng(41)
    for name, packed in FMTS:
        ft = tformats.get(name)
        dc = tkv.code_channels(hd, ft, packed)
        hi = 1 << (16 if ft.bits == 16 else 8)
        for t, pos in ((1, [0, 63, 64, 1000]), (12, [60, 5, 127, 3000])):
            bufs = []
            for _ in range(2):
                c = torch.from_numpy(rng.integers(0, hi, (b, w, h, dc)))
                c = torch.where(c >= 1 << 15, c - (1 << 16), c) \
                    if ft.bits > 8 else c
                bufs += [c.to(ft.storage_dtype).to(dev),
                         torch.from_numpy(np.exp2(rng.integers(
                             -4, 4, (b, w, h))).astype(np.float32)).to(dev)]
            mag = np.exp2(rng.uniform(-8, 8, (b, t, h, 1)))
            fused = torch.from_numpy((rng.normal(0, 1, (b, t, h, 3 * hd))
                                      * mag).astype(np.float32)).to(dev)
            posd = torch.tensor(pos, dtype=torch.int32, device=dev)
            for x in (fused, fused.to(torch.bfloat16)):
                kn, vn = x[..., :hd].contiguous(), x[..., 2 * hd:]
                want = tkv.kv_append_rows_ref(*[a.clone() for a in bufs],
                                              kn, vn, posd, ft, packed)
                before = LAUNCHES["kv_append_rows"]
                got = tkv.kv_append_rows(*[a.clone() for a in bufs], kn, vn,
                                         posd, ft, packed=packed)
                assert LAUNCHES["kv_append_rows"] == before + 1
                for g, wv in zip(got, want):
                    assert torch.equal(g, wv), (name, t, x.dtype)
    before = LAUNCHES["kv_append_rows"]
    ft = tformats.POSIT8_2
    for hd_, dtype, err in ((64, torch.float16, TypeError),
                            (48, torch.float32, ValueError)):
        bufs = [a.to(dev) for a in _ring_bufs(ft, False, hd_)]
        x = torch.zeros((B, 1, H, hd_), dtype=dtype, device=dev)
        with pytest.raises(err):
            tkv.kv_append_rows(*bufs, x, x, 0, ft)
    bufs = [a.to(dev) for a in _ring_bufs(ft, False, 64)]
    flat = torch.zeros(B * H * 64 + 1, dtype=torch.bfloat16, device=dev)
    x = flat[1:].reshape(B, 1, H, 64)
    with pytest.raises(ValueError, match="aligned"):
        tkv.kv_append_rows(*bufs, x, x, 0, ft)
    assert LAUNCHES["kv_append_rows"] == before
