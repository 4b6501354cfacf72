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
  undistributed engine's.  bf16 posit8 ring against the reference's
  distributed path by logit tolerance; granite-moe smoke (ring posit8);
  qwen2-vl smoke through ``make_distributed_decode_step`` fed patch
  embeddings; a guard rung that inherits the plug.
* In one process: a plain plug's float32 streams equal ``attn_impl=None``'s,
  the world-1 plug's too; ``paged_kv_append_rows_ref`` skips rows outside
  [0, R); the refusals (an indivisible ring or pool, the SSM stack; the
  hybrid and audio stacks build, ``test_torch_distributed_families.py``
  serves them).
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
from repro_torch.serve import (Fault, FaultPlan, KVShard, Request,  # noqa: E402
                               ServeConfig, ServingEngine,
                               TransprecisionEngine,
                               distributed_decode_attention,
                               make_distributed_decode_step,
                               make_distributed_engine)
from repro_torch.serve.distributed import _local_lse  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402

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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results and the reference's, from one start each."""
    root = tmp_path_factory.mktemp("distributed")
    prompts, moe_prompts, embeds, steps = _inputs()
    np.savez(root / "inputs.npz", max_new=MAX_NEW, vlm_embeds=embeds,
             vlm_steps=steps, **{f"prompt{i}": p for i, p in
                                 enumerate(prompts)},
             **{f"moe_prompt{i}": p for i, p in enumerate(moe_prompts)})
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_jax_dist_reference.py"), str(root)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    models = {"dense32": _pair("paper-edge", "float32"),
              "dense16": _pair("paper-edge", "bfloat16"),
              "moe32": _pair("granite-moe-1b-a400m", "float32"),
              "vlm32": _pair("qwen2-vl-2b", "float32")}
    torch.save({**{k: p for k, (_, p) in models.items()},
                "prompts": prompts, "moe_prompts": moe_prompts,
                "max_new": MAX_NEW, "vlm_embeds": embeds,
                "vlm_steps": steps}, root / "inputs.pt")
    ranks = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), str(r), "2",
         str(root)], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=WAIT_S)[0] for p in ranks + [ref]]
    finally:
        for p in ranks + [ref]:
            p.kill()
    for p, log in zip(ranks + [ref], logs):
        assert p.returncode == 0, log[-4000:]
    return {"ranks": [torch.load(root / f"rank{r}.pt", weights_only=False)
                      for r in range(2)],
            "ref": dict(np.load(root / "reference.npz")),
            "models": models, "prompts": prompts}


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
    c = get_config("mamba2-2.7b", smoke=True)
    with pytest.raises(NotImplementedError, match="no KV sequence"):
        make_distributed_engine(c, pol, 2, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="no KV sequence"):
        make_distributed_decode_step(c, pol)
    with pytest.raises(NotImplementedError, match="no KV sequence"):
        serve_model.init_cache(c, 2, 64, policy=pol, device="cpu",
                               kv_shard=half)
    # the hybrid and audio stacks shard (test_torch_distributed_families)
    for arch in ("recurrentgemma-9b", "whisper-large-v3"):
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

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_two_rank_streams_equal_reference(runs, layout, fmt):
    (r0, r1), ref = runs["ranks"], runs["ref"]
    toks = r0[layout, fmt]["tokens"]
    assert r1[layout, fmt]["tokens"] == toks
    assert toks == ref[f"{layout}_{fmt}_engine"].tolist()
    assert toks == ref[f"{layout}_{fmt}_dist"].tolist()
    assert all(len(t) == MAX_NEW for t in toks)
    cfg, params = runs["models"]["dense32"]
    want, eng = _serve(cfg, params, runs["prompts"], layout, fmt)
    assert toks == want
    for r in (r0, r1):
        assert 2 * r[layout, fmt]["kv_bytes"] == eng.kv_cache_bytes()
    seq = 2 if layout == "ring" else 1          # the "kv_seq" dim
    for name, shape in r0[layout, fmt]["shapes"].items():
        full = tuple(eng.cache["blocks"][0][name].shape)
        assert shape == full[:seq] + (full[seq] // 2,) + full[seq + 1:]


def test_live_rows_on_both_shards(runs):
    """Every slot wrote rows on rank 1 (its ring rows 32-63; its pool
    pages 13-25): shard 1's partials enter the combine."""
    for layout in ("ring", "paged"):
        written = runs["ranks"][1][layout, "posit8"]["written"]
        assert (written > 0).all(), (layout, written)


def test_two_rank_bf16_against_reference(runs):
    """bf16 rounds at other places in the two frameworks: the first
    decode step's logits within 0.1 of the reference's distributed
    path's (test_torch_serve's bf16 tolerance); both ranks equal."""
    (r0, r1), ref = runs["ranks"], runs["ref"]
    got, want = r0["bf16"]["first_logits"].numpy(), ref["bf16_first_logits"]
    assert np.abs(got - want).max() < 0.1, np.abs(got - want).max()
    assert np.abs(want).max() > 0.5
    assert torch.equal(r0["bf16"]["first_logits"],
                       r1["bf16"]["first_logits"])
    assert r0["bf16"]["tokens"] == r1["bf16"]["tokens"]


def test_two_rank_moe_streams(runs):
    (r0, r1), ref = runs["ranks"], runs["ref"]
    assert r0["moe"] == r1["moe"] == ref["moe_dist"].tolist()
    cfg, params = runs["models"]["moe32"]
    prompts = _inputs()[1]
    assert r0["moe"] == _serve(cfg, params, prompts)[0]


def test_two_rank_vlm_decode_step_with_embeds(runs):
    """make_distributed_decode_step on patch embeddings: logits within the
    vlm parity tolerance of the reference's (M-RoPE's tables agree within
    1e-6) and of the port's undistributed decode_step."""
    (r0, r1), ref = runs["ranks"], runs["ref"]
    cfg, params = runs["models"]["vlm32"]
    _, _, embeds, steps = _inputs()
    policy = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    _, cache = serve_model.prefill(params, {"embeds": torch.from_numpy(
        embeds)}, cfg, 64, policy)
    for i, e in enumerate(steps):
        want, cache = serve_model.decode_step(
            params, cache, None, cfg, policy, embeds=torch.from_numpy(e))
        assert torch.equal(r0["vlm"][i], r1["vlm"][i])
        np.testing.assert_allclose(r0["vlm"][i].numpy(),
                                   ref[f"vlm_logits{i}"], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r0["vlm"][i].numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5)


def test_two_rank_guard_rung_inherits_the_plug(runs):
    """A poisoned round re-decoded by the first rung over the rank-local
    state: the streams equal the undistributed guarded engine's."""
    (r0, r1) = runs["ranks"]
    assert r0["guard"]["rung_inherits"] and r1["guard"]["rung_inherits"]
    assert r0["guard"]["fallbacks"] == r1["guard"]["fallbacks"] == 1
    cfg, params = runs["models"]["dense32"]
    plan = FaultPlan((Fault("poison_logits", at=3, slot=0),))
    want, eng = _serve(cfg, params, runs["prompts"], guard=True, faults=plan)
    assert eng.metrics.counter("guard.fallbacks").value == 1
    assert r0["guard"]["tokens"] == r1["guard"]["tokens"] == want
