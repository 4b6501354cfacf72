"""KV-sequence-sharded distributed decode of the port
(``serve/distributed.py``) against the reference's, and against its own
undistributed engine.

* ``_local_lse`` against the reference's: float32 within 1e-6, bf16 by the
  port's bf16 logit tolerance, with a scalar and a per-slot ``cache_len``;
  the log-sum-exp identity over 1, 2 and 4 shards, one of them with no
  live row, against the plain ``decode_attention``.
* Two gloo ranks on the CPU (one start per module; ``file://`` init) on
  paper-edge smoke at float32 with live rows on both shards (prompts of
  40, 29 and 35 tokens, 16 new, max_len 64: the ring splits 32 + 32; page
  size 8, 26 pages): ring and paged x f32, posit16 and posit8 KV streams
  token-identical on both ranks, to the reference's ``ServingEngine`` and
  to its distributed engine on two host devices (one subprocess per
  module, an Auto-axis (1, 2) mesh), each rank's KV bytes half the
  undistributed engine's (the port's undistributed engines serve while
  the subprocesses run).  This file runs the ring;
  ``test_torch_distributed_paged.py`` the paged layout and
  ``test_torch_distributed_models.py`` the bf16, granite-moe, qwen2-vl
  and guard cases, each over their own ranks and reference.
* In one process: a plain plug's float32 streams equal ``attn_impl=None``'s,
  the world-1 plug's too; ``paged_kv_append_rows_ref`` skips rows outside
  [0, R); the refusals (an indivisible ring or pool); the hybrid, audio
  and SSM stacks build (``test_torch_distributed_families.py`` and
  ``test_torch_distributed_recurrent.py`` serve them), the SSM's
  rank-local cache split as ``cache_specs`` splits it.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import distributed as jdist  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.formats import get as get_fmt  # noqa: E402
from repro_torch.core.transprecision import get_policy, kv_storage  # noqa: E402
from repro_torch.kernels.paged_kv import paged_kv_append_rows_ref  # noqa: E402
from repro_torch.models import attention, serve_model  # noqa: E402
from repro_torch.serve import (KVShard, Request,  # noqa: E402
                               ServeConfig, ServingEngine,
                               TransprecisionEngine,
                               distributed_decode_attention,
                               make_distributed_decode_step,
                               make_distributed_engine)
from repro_torch.serve.distributed import _local_lse  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
LENS, MAX_NEW = (40, 29, 35), 16
FORMATS = ("f32", "posit16", "posit8")
WAIT_S = 600


def _pair(arch, dtype_name):
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype_name=dtype_name)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             dtype_name=dtype_name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    return tc, params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)


def _inputs():
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n) for n in LENS]
    # one length: the reference compiles an MoE prefill per prompt length
    moe_prompts = [rng.integers(0, 256, 40) for _ in LENS]
    d = get_config("qwen2-vl-2b", smoke=True).d_model
    embeds = rng.normal(0, 1, (2, 40, d)).astype(np.float32)
    steps = rng.normal(0, 1, (3, 2, 1, d)).astype(np.float32)
    return prompts, moe_prompts, embeds, steps


def _env():
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks meet locally
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(HERE)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def dense_runs(root, layout):
    """Both ranks' results and the reference's for ``layout``'s three KV
    formats, from one start each, and the port's undistributed engines'
    (served meanwhile)."""
    prompts = _inputs()[0]
    np.savez(root / "inputs.npz", max_new=MAX_NEW, layout=layout,
             **{f"prompt{i}": p for i, p in enumerate(prompts)})
    models = {"dense32": _pair("paper-edge", "float32")}
    out = start_runs(root, "dense", models, {"prompts": prompts,
                                             "layout": layout}, lambda: {
        (layout, fmt): _plain(*models["dense32"], prompts, layout, fmt)
        for fmt in FORMATS})
    return {**out, "prompts": prompts}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ring layout (``test_torch_distributed_paged.py``: the pool)."""
    return dense_runs(tmp_path_factory.mktemp("distributed"), "ring")


def _plain(cfg, params, prompts, layout, fmt):
    """The undistributed engine's streams, KV bytes and leaf shapes."""
    toks, eng = _serve(cfg, params, prompts, layout, fmt)
    return {"tokens": toks, "kv_bytes": eng.kv_cache_bytes(),
            "shapes": {k: tuple(v.shape)
                       for k, v in eng.cache["blocks"][0].items()}}


def start_runs(root, cases, models, extra, plain):
    """Start the two gloo ranks (``_torch_dist_worker.py ... cases``) and
    the reference (``_jax_dist_reference.py DIR cases``) on ``root``'s
    inputs, run ``plain()`` (the port's undistributed side) while they
    run, and return every result."""
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_jax_dist_reference.py"), str(root),
         cases], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    torch.save({**{k: p for k, (_, p) in models.items()},
                "max_new": MAX_NEW, **extra}, root / "inputs.pt")
    ranks = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), str(r), "2",
         str(root), cases], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        want = plain()
        logs = [p.communicate(timeout=WAIT_S)[0] for p in ranks + [ref]]
    finally:
        for p in ranks + [ref]:
            p.kill()
    for p, log in zip(ranks + [ref], logs):
        assert p.returncode == 0, log[-4000:]
    return {"ranks": [torch.load(root / f"rank{r}.pt", weights_only=False)
                      for r in range(2)],
            "ref": dict(np.load(root / "reference.npz")),
            "models": models, "plain": want}


def _serve(cfg, params, prompts, layout="ring", kv_format="posit8",
           plug=None, **kw):
    """Serve ``prompts`` (16 new tokens each) through a ServingEngine with
    ``plug`` as its decode attention ("distributed": the world-1 sharded
    plug of the engine's policy)."""
    scfg = ServeConfig(max_batch=len(prompts), max_len=64,
                       kv_format=kv_format, kv_layout=layout, page_size=8,
                       num_pages=26 if layout == "paged" else None)
    if plug == "distributed":
        pol = ServingEngine(cfg, params, scfg, device="cpu").policy
        plug = distributed_decode_attention(
            kv_spec=kv_storage(pol), paged=layout == "paged", page_size=8)
    eng = ServingEngine(cfg, params, scfg, attn_impl=plug, device="cpu",
                        **kw)
    reqs = [Request(uid=i, prompt=np.asarray(p), max_new=MAX_NEW)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.out_tokens for r in reqs], eng


# ---------------------------------------------------------------------------
# The shard's arithmetic, in one process
# ---------------------------------------------------------------------------

def _qkv(rng, b=3, w=24, nkv=2, grp=3, hd=16):
    q = rng.normal(0, 1, (b, 1, nkv, grp, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, w, nkv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, w, nkv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [17, (5, 24, 13)],
                         ids=["scalar", "per_slot"])
def test_local_lse_matches_reference(dtype, cache_len):
    q, k, v = _qkv(np.random.default_rng(1))
    start = 8
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jdist._local_lse(*(jnp.asarray(a, jdt) for a in (q, k, v)), start,
                            jnp.asarray(cache_len))
    got = _local_lse(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                     start, torch.as_tensor(cache_len))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
        else:       # the port's bf16 logit tolerance: a few bf16 ulps
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-2, atol=0.1)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_lse_identity_over_shards(shards):
    """Merging the shards' (o, l, m) by the combine's rule gives the plain
    decode attention; slot 0's live rows all lie in shard 0, so the other
    shards hold no live row for it."""
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, w=32))
    cache_len = torch.tensor([3, 32, 19])
    wl = 32 // shards
    parts = [_local_lse(q * 16 ** -0.5, k[:, i * wl:(i + 1) * wl],
                        v[:, i * wl:(i + 1) * wl], i * wl, cache_len)
             for i in range(shards)]
    o, l, m = (torch.stack(t) for t in zip(*parts))
    m_g = m.amax(0)
    corr = torch.exp(m - m_g)
    out = ((o * corr[..., None]).sum(0)
           / torch.clamp((l * corr).sum(0), min=1e-30)[..., None])
    want = attention.decode_attention(q.reshape(3, 1, 6, 16), k, v,
                                      cache_len)
    np.testing.assert_allclose(out.reshape(want.shape).numpy(),
                               want.numpy(), rtol=1e-5, atol=1e-6)
    if shards > 1:
        assert bool((m[1:, 0] <= -1e29).all())    # no live row for slot 0


def test_plain_paged_append_skips_rows_outside_the_pool():
    """-1 (a row another rank owns) and R are dropped, as K5 drops them;
    the old plain version wrote -1 onto the last row."""
    fmt = get_fmt("posit8_2")
    rng = np.random.default_rng(3)
    r, nkv, hd = 8, 2, 16
    codes = [torch.zeros((r, nkv, hd), dtype=torch.uint8) for _ in range(2)]
    scales = [torch.ones((r, nkv)) for _ in range(2)]
    new = [torch.from_numpy(rng.normal(0, 1, (4, 1, nkv, hd)).astype(
        np.float32)) for _ in range(2)]
    paged_kv_append_rows_ref(codes[0], scales[0], codes[1], scales[1],
                             *new, torch.tensor([[2], [-1], [r], [5]]), fmt)
    written = {2, 5}
    for c, s in zip(codes, scales):
        for row in range(r):
            assert bool((c[row] != 0).any()) == (row in written), row
            assert bool((s[row] != 1).any()) == (row in written), row


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_plain_plug_and_world_one_streams_equal_builtin(layout):
    """A plain plug (``attention.decode_attention``, fed decoded rows) and
    the world-1 distributed plug give the float32 streams of
    ``attn_impl=None``."""
    cfg = dataclasses.replace(get_config("paper-edge", smoke=True),
                              dtype_name="float32")
    params = _pair("paper-edge", "float32")[1]
    prompts = _inputs()[0]
    want = _serve(cfg, params, prompts, layout)[0]
    assert _serve(cfg, params, prompts, layout,
                  plug=attention.decode_attention)[0] == want
    toks, eng = _serve(cfg, params, prompts, layout, plug="distributed")
    assert toks == want
    assert eng.engine.kv_shard == KVShard()


def test_refusals():
    cfg = get_config("paper-edge", smoke=True)
    half = KVShard(rank=0, world=2)
    pol = get_policy("bf16")
    paged = dataclasses.replace(pol, kv_layout="paged", kv_page_size=8)
    with pytest.raises(ValueError, match="ring rows"):
        serve_model.init_cache(cfg, 2, 63, policy=pol, device="cpu",
                               kv_shard=half)
    with pytest.raises(ValueError, match="pool pages"):
        serve_model.init_cache(cfg, 3, 64, policy=paged, num_pages=25,
                               device="cpu", kv_shard=half)
    # the full pool of 3 slots x 8 pages + the trash page is odd too
    plug = distributed_decode_attention(paged=True, page_size=8)
    plug.shard = half
    with pytest.raises(ValueError, match="pool pages"):
        TransprecisionEngine(cfg, paged, 3, 64, attn_impl=plug, device="cpu")
    local = serve_model.init_cache(cfg, 3, 64, policy=paged, num_pages=26,
                                   device="cpu", kv_shard=half)
    assert local["blocks"][0]["k"].shape[1] == 26 * 8 // 2
    # the SSM stack, which holds no KV sequence, shards its recurrent
    # state (test_torch_distributed_recurrent serves it over two ranks):
    # its rank-local cache on the meta device has cache_specs' shapes
    c = get_config("mamba2-2.7b", smoke=True)
    local = serve_model.init_cache(c, 2, 64, policy=pol, device="meta",
                                   kv_shard=half)["blocks"][0]
    full = serve_model.init_cache(c, 2, 64, policy=pol, device="meta")
    for name, dim in (("state", 2), ("conv", 3)):
        shape = list(full["blocks"][0][name].shape)
        shape[dim] //= 2
        assert list(local[name].shape) == shape, name
    cut = serve_model.shard_cache(full, c, pol, half)["blocks"][0]
    assert {k: v.shape for k, v in cut.items()} == {
        k: v.shape for k, v in local.items()}
    # the hybrid, audio and SSM stacks shard
    # (test_torch_distributed_families, test_torch_distributed_recurrent)
    for arch in ("recurrentgemma-9b", "whisper-large-v3", "mamba2-2.7b"):
        c = get_config(arch, smoke=True)
        assert make_distributed_engine(c, pol, 2, 64,
                                       device="cpu").kv_shard == KVShard()
        assert make_distributed_decode_step(c, pol).shard == KVShard()
        serve_model.init_cache(c, 2, 64, policy=pol, device="cpu",
                               kv_shard=half)
    eng = make_distributed_engine(cfg, pol, 2, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="verify"):
        eng.verify(None, eng.init_decode_state(), torch.zeros((2, 2)))


# ---------------------------------------------------------------------------
# Two gloo ranks against the reference's two host devices
# ---------------------------------------------------------------------------

def check_streams(runs, layout, fmt):
    """Both ranks' streams equal each other's, the reference's engines'
    and the port's undistributed engine's; a rank's KV bytes half; every
    leaf halved along its "kv_seq" dim."""
    (r0, r1), ref = runs["ranks"], runs["ref"]
    toks = r0[layout, fmt]["tokens"]
    assert r1[layout, fmt]["tokens"] == toks
    assert toks == ref[f"{layout}_{fmt}_engine"].tolist()
    assert toks == ref[f"{layout}_{fmt}_dist"].tolist()
    assert all(len(t) == MAX_NEW for t in toks)
    want = runs["plain"][layout, fmt]
    assert toks == want["tokens"]
    for r in (r0, r1):
        assert 2 * r[layout, fmt]["kv_bytes"] == want["kv_bytes"]
    seq = 2 if layout == "ring" else 1          # the "kv_seq" dim
    for name, shape in r0[layout, fmt]["shapes"].items():
        full = want["shapes"][name]
        assert shape == full[:seq] + (full[seq] // 2,) + full[seq + 1:]


def check_live_rows(runs, layout):
    written = runs["ranks"][1][layout, "posit8"]["written"]
    assert (written > 0).all(), (layout, written)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", ["ring"])
def test_two_rank_streams_equal_reference(runs, layout, fmt):
    check_streams(runs, layout, fmt)


def test_live_rows_on_both_shards(runs):
    """Every slot wrote rows on rank 1 (its ring rows 32-63): shard 1's
    partials enter the combine."""
    check_live_rows(runs, "ring")
