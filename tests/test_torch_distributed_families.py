"""KV-sequence-sharded decode of the hybrid and audio stacks
(``serve/distributed.py`` over ``models/serve_model.py``) against the
reference's, and against the port's own undistributed paths.

* Two gloo ranks on the CPU (one start per module, through
  ``tests/_torch_dist_worker.py ... families``) and the reference on two
  host devices (one ``tests/_jax_dist_reference.py DIR families``
  subprocess, an Auto-axis (1, 2) mesh).
* The recurrentgemma smoke config (float32; window 16, so W = 16 ring
  rows split 8 + 8; its tail is a recurrent layer) served through the
  engine, ring, f32 and posit8 KV: prompts of 12 and 20 tokens and 20 new
  tokens, so every ring wraps (the 20-token prompt at its prefill).  The
  streams of both ranks equal the undistributed engine's, the
  reference's undistributed engine's and its distributed engine's; each
  rank's KV bytes half the undistributed engine's, every ring leaf half
  its width and the recurrent ``h`` / ``conv`` half their width
  (``cache_specs``' "model" split).
* The whisper smoke config (float32, f32 KV): ``make_distributed_decode_
  step`` over a ``shard_cache``d prefill of 36 tokens and 24 frames (ring
  rows 32-35 live on rank 1), 4 steps: both ranks' logits equal, within
  1e-5 of the reference's distributed step and of the port's plain
  ``decode_step``; ``xk`` whole on every rank.
* In one process: the refusals (a window, an RG-LRU width or a count of
  SSD heads the world does not divide), the SSM stack's engine, step and
  rank-local cache building, and ``check_kv_shard`` / ``init_cache(...,
  kv_shard=)`` on a hybrid cache on the meta device.
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

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import serve_model  # noqa: E402
from repro_torch.models.common import map_with_path  # noqa: E402
from repro_torch.serve import (KVShard, Request, ServeConfig,  # noqa: E402
                               ServingEngine, TransprecisionEngine,
                               distributed_decode_attention,
                               make_distributed_decode_step,
                               make_distributed_engine)
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
HYBRID_LENS, MAX_NEW = (12, 20, 12), 20
AUDIO_PROMPT, AUDIO_STEPS = 36, 4
WAIT_S = 600


def _pair(arch):
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype_name="float32")
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             dtype_name="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    return tc, params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)


def _inputs():
    rng = np.random.default_rng(28)
    vocab = get_config("recurrentgemma-9b", smoke=True).vocab
    prompts = [rng.integers(0, vocab, n) for n in HYBRID_LENS]
    acfg = get_config("whisper-large-v3", smoke=True)
    tokens = rng.integers(0, acfg.vocab, (2, AUDIO_PROMPT))
    frames = rng.normal(0, 1, (2, acfg.enc_seq, acfg.d_model)).astype(
        np.float32)
    steps = rng.integers(0, acfg.vocab, (AUDIO_STEPS, 2, 1))
    return prompts, tokens, frames, steps


def _env():
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks meet locally
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(HERE)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results and the reference's, from one start each."""
    root = tmp_path_factory.mktemp("distributed_families")
    prompts, tokens, frames, steps = _inputs()
    np.savez(root / "inputs.npz", max_new=MAX_NEW, n_hybrid=len(prompts),
             audio_tokens=tokens, audio_frames=frames, audio_steps=steps,
             **{f"hybrid_prompt{i}": p for i, p in enumerate(prompts)})
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_jax_dist_reference.py"), str(root),
         "families"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    models = {"hybrid32": _pair("recurrentgemma-9b"),
              "audio32": _pair("whisper-large-v3")}
    torch.save({**{k: p for k, (_, p) in models.items()},
                "hybrid_prompts": prompts, "max_new": MAX_NEW,
                "audio_tokens": tokens, "audio_frames": frames,
                "audio_steps": steps}, root / "inputs.pt")
    ranks = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), str(r), "2",
         str(root), "families"], env=_env(), stdout=subprocess.PIPE,
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


@pytest.mark.parametrize("fmt", ["f32", "posit8"])
def test_two_rank_hybrid_streams(runs, fmt):
    (r0, r1), ref = runs["ranks"], runs["ref"]
    toks = r0["hybrid", fmt]["tokens"]
    assert r1["hybrid", fmt]["tokens"] == toks
    assert all(len(t) == MAX_NEW for t in toks)
    assert toks == ref[f"hybrid_{fmt}_engine"].tolist()
    assert toks == ref[f"hybrid_{fmt}_dist"].tolist()
    cfg, params = runs["models"]["hybrid32"]
    eng = ServingEngine(cfg, params, ServeConfig(
        max_batch=len(runs["prompts"]), max_len=64, kv_format=fmt),
        device="cpu")
    reqs = [Request(uid=i, prompt=np.asarray(p), max_new=MAX_NEW)
            for i, p in enumerate(runs["prompts"])]
    eng.serve(reqs)
    assert toks == [r.out_tokens for r in reqs]
    for r in (r0, r1):
        assert 2 * r["hybrid", fmt]["kv_bytes"] == eng.kv_cache_bytes()
    for path, shape in r0["hybrid", fmt]["shapes"].items():
        part, i, name = path.split("/")
        full = tuple(eng.cache[part][int(i)][name].shape)
        if name in ("h", "conv"):           # ([P,] B, [K-1,] width / 2)
            assert shape == full[:-1] + (full[-1] // 2,), path
            assert full[-1] == cfg.d_model
        else:                               # (P, B, W, ...): W / 2 a rank
            assert shape == full[:2] + (full[2] // 2,) + full[3:], path
            assert full[2] == cfg.window


def test_two_rank_audio_decode_step(runs):
    (r0, r1), ref = runs["ranks"], runs["ref"]
    cfg, params = runs["models"]["audio32"]
    _, tokens, frames, steps = _inputs()
    policy = get_policy("bf16")
    _, cache = serve_model.prefill(
        params, {"tokens": torch.from_numpy(tokens),
                 "frames": torch.from_numpy(frames)}, cfg, 64, policy)
    k, xk = cache["blocks"][0]["k"], cache["blocks"][0]["xk"]
    assert r0["audio_k_shape"] == r1["audio_k_shape"] == (
        k.shape[:2] + (k.shape[2] // 2,) + k.shape[3:])
    assert r0["audio_xk_shape"] == r1["audio_xk_shape"] == tuple(xk.shape)
    for i, t in enumerate(steps):
        want, cache = serve_model.decode_step(params, cache,
                                              torch.from_numpy(t), cfg,
                                              policy)
        assert torch.equal(r0["audio"][i], r1["audio"][i])
        np.testing.assert_allclose(r0["audio"][i].numpy(),
                                   ref[f"audio_logits{i}"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r0["audio"][i].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5)


def test_refusals():
    pol = get_policy("bf16")
    half = KVShard(rank=0, world=2)
    ssm = get_config("mamba2-2.7b", smoke=True)
    assert make_distributed_engine(ssm, pol, 2, 64,
                                   device="cpu").kv_shard == KVShard()
    assert make_distributed_decode_step(ssm, pol).shard == KVShard()
    assert serve_model.init_cache(ssm, 2, 64, policy=pol, device="cpu",
                                  kv_shard=half)["blocks"][0][
        "state"].shape[2] == 4
    third = KVShard(rank=0, world=3)
    with pytest.raises(ValueError,
                       match="8 SSD heads do not split over 3 ranks"):
        serve_model.init_cache(ssm, 2, 64, policy=pol, device="cpu",
                               kv_shard=third)
    plug = distributed_decode_attention()
    plug.shard = third
    with pytest.raises(ValueError, match="8 SSD heads"):
        TransprecisionEngine(ssm, pol, 2, 64, attn_impl=plug, device="cpu")
    # a 15-row ring splits over 3 ranks, the 64-wide RG-LRU does not
    hyb = get_config("recurrentgemma-9b", smoke=True)
    with pytest.raises(ValueError,
                       match="64 RG-LRU channels do not split over 3 ranks"):
        serve_model.init_cache(hyb, 2, 15, policy=pol, device="cpu",
                               kv_shard=third)
    odd = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                              window=15)
    with pytest.raises(ValueError, match="15 ring rows"):
        serve_model.init_cache(odd, 2, 64, policy=pol, device="cpu",
                               kv_shard=half)
    plug = distributed_decode_attention()
    plug.shard = half
    with pytest.raises(ValueError, match="15 ring rows"):
        TransprecisionEngine(odd, pol, 2, 64, attn_impl=plug, device="cpu")
    # a window wider than max_len: the ring is max_len rows
    assert serve_model.init_cache(
        odd, 2, 14, policy=pol, device="cpu",
        kv_shard=half)["blocks"][2]["k"].shape[2] == 7


def _leaves(tree):
    out = []
    map_with_path(lambda p, t: out.append((p, t)), tree)
    return out


@pytest.mark.parametrize("fmt", ["f32", "posit8"])
def test_hybrid_rank_local_cache_on_meta(fmt):
    """``check_kv_shard`` checks the attention leaves past the recurrent
    period positions; the rank-local cache halves every ring leaf along
    its "kv_seq" dim and every recurrent leaf along its width (zeros, the
    whole cache's dtypes) and keeps ``pos``; ``shard_cache`` of the whole
    cache gives the same shapes; on the meta device and on the CPU
    alike."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    pol = dataclasses.replace(get_policy("bf16"), kv_format=fmt)
    full = serve_model.init_cache(cfg, 3, 64, policy=pol, device="meta")
    assert "k" not in full["blocks"][0]
    for rank in (0, 1):
        shard = KVShard(rank=rank, world=2)
        serve_model.check_kv_shard(full, cfg, pol, shard)
        for dev in ("meta", "cpu"):
            local = serve_model.init_cache(cfg, 3, 64, policy=pol,
                                           device=dev, kv_shard=shard)
            for part in ("blocks", "tail"):
                for blk_f, blk_l in zip(full[part], local[part]):
                    for name, t in blk_f.items():
                        got = blk_l[name]
                        assert got.dtype == t.dtype, name
                        assert got.device.type == dev, name
                        shape = list(t.shape)
                        if name in ("k", "v", "k_scale", "v_scale"):
                            shape[2] //= 2
                        else:               # h, conv: width last
                            shape[-1] //= 2
                        assert list(got.shape) == shape, (part, name)
                        if dev == "cpu" and name in ("h", "conv"):
                            assert not got.any()
            assert tuple(local["pos"].shape) == ()
        cut = serve_model.shard_cache(full, cfg, pol, shard)
        assert ({p: t.shape for p, t in _leaves(cut)}
                == {p: t.shape for p, t in _leaves(local)})
    with pytest.raises(ValueError, match="ring rows"):
        serve_model.check_kv_shard(full, cfg, pol, KVShard(rank=0, world=3))
