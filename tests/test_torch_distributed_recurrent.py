"""The distributed decode of the SSM stack, its recurrent state split over
ranks (``serve/distributed.py`` over ``models/ssm.py``), against the
reference's engine and the port's own undistributed one.

* Two gloo ranks on the CPU (one start per module, through
  ``tests/_torch_dist_worker.py ... recurrent``) and the reference on two
  host devices (one ``tests/_jax_dist_reference.py DIR recurrent``
  subprocess, an Auto-axis (1, 2) mesh, its engine with the distributed
  decode attention plugged in: the SSM decode does not read the plug, so
  it runs the whole state).
* The mamba2 smoke config (float32; nh 8, ch 160, 2 layers) served
  through the engine, ring layout: prompts of 20, 32 and 64 tokens (at
  most ``ssm_chunk`` = 32 or a multiple of it: fault 7) and 16 new
  tokens.  Both ranks' streams equal the port's undistributed engine's,
  the reference's undistributed engine's and its distributed engine's;
  every decode step's logits within 1e-5 of the reference's and of the
  undistributed engine's; each rank's ``state`` (heads 4 of 8) and
  ``conv`` (channels 80 of 160) at ``launch.mesh.cache_specs``' local
  shape over a (1, 2) ("data", "model") mesh, half the bytes.
"""
import dataclasses
import math
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
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import serve_model  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
ARCH = "mamba2-2.7b"
LENS, MAX_NEW, MAX_LEN = (20, 32, 64), 16, 96
WAIT_S = 600


def _env():
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")     # the ranks meet locally
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC), str(HERE)] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results, the reference's and the port's undistributed
    engine's, from one start each."""
    root = tmp_path_factory.mktemp("distributed_recurrent")
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, get_config(ARCH, smoke=True).vocab, n)
               for n in LENS]
    np.savez(root / "inputs.npz", max_new=MAX_NEW, max_len=MAX_LEN,
             n_ssm=len(prompts),
             **{f"ssm_prompt{i}": p for i, p in enumerate(prompts)})
    ref = subprocess.Popen(
        [sys.executable, str(HERE / "_jax_dist_reference.py"), str(root),
         "recurrent"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              dtype_name="float32")
    jcfg = dataclasses.replace(j_get_config(ARCH, smoke=True),
                               dtype_name="float32")
    params = params_from_numpy(jax_params_to_numpy(
        jlm.init_params(jax.random.PRNGKey(0), jcfg)), "cpu", cfg.dtype)
    torch.save({"ssm32": params, "ssm_prompts": prompts, "max_new": MAX_NEW,
                "max_len": MAX_LEN}, root / "inputs.pt")
    ranks = [subprocess.Popen(
        [sys.executable, str(HERE / "_torch_dist_worker.py"), str(r), "2",
         str(root), "recurrent"], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        # the undistributed engine while the ranks and the reference run
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=len(prompts), max_len=MAX_LEN, kv_format="f32"),
            device="cpu")
        logits, generate = [], eng.engine.generate

        def recorded(p, state):
            state, out = generate(p, state)
            logits.append(out.float().clone())
            return state, out

        eng.engine.generate = recorded
        reqs = [Request(uid=i, prompt=np.asarray(p), max_new=MAX_NEW)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        logs = [p.communicate(timeout=WAIT_S)[0] for p in ranks + [ref]]
    finally:
        for p in ranks + [ref]:
            p.kill()
    for p, log in zip(ranks + [ref], logs):
        assert p.returncode == 0, log[-4000:]
    return {"ranks": [torch.load(root / f"rank{r}.pt", weights_only=False)
                      for r in range(2)],
            "ref": dict(np.load(root / "reference.npz")), "cfg": cfg,
            "plain": {"tokens": [r.out_tokens for r in reqs],
                      "logits": logits, "cache": eng.cache}}


def test_two_rank_ssm_streams_equal_reference(runs):
    (r0, r1), ref, plain = runs["ranks"], runs["ref"], runs["plain"]
    toks = r0["tokens"]
    assert r1["tokens"] == toks
    assert all(len(t) == MAX_NEW for t in toks)
    assert toks == plain["tokens"]
    assert toks == ref["ssm_engine"].tolist()
    assert toks == ref["ssm_dist"].tolist()


def test_two_rank_ssm_logits_equal_reference(runs):
    (r0, r1), ref, plain = runs["ranks"], runs["ref"], runs["plain"]
    assert len(r0["logits"]) == len(plain["logits"]) == MAX_NEW - 1
    for i, lg in enumerate(r0["logits"]):
        assert torch.equal(lg, r1["logits"][i])
        np.testing.assert_allclose(lg.numpy(), ref[f"ssm_logits{i}"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(lg.numpy(), plain["logits"][i].numpy(),
                                   rtol=0, atol=1e-5)


def test_two_rank_ssm_state_split_as_cache_specs(runs):
    """Each rank's ``state`` and ``conv`` have ``cache_specs``' local
    shape over a (1, 2) mesh (the "model" dims halved: 4 of 8 heads, 80
    of 160 channels) and half the whole leaf's bytes."""
    cfg, full = runs["cfg"], runs["plain"]["cache"]
    mesh = tmesh.make_host_mesh(2, model=True)
    specs = tmesh.cache_specs(full, cfg, tmesh.serve_rules(
        mesh, global_batch=len(LENS)))
    blk, spec = full["blocks"][0], specs["blocks"][0]
    for r in runs["ranks"]:
        for name in ("state", "conv"):
            local = tuple(n // math.prod(mesh.shape[a] for a in (
                (ax if isinstance(ax, tuple) else (ax,)) if ax else ()))
                for n, ax in zip(blk[name].shape, spec[name]))
            assert r["shapes"][name] == local, name
            assert 2 * r["bytes"][name] == (blk[name].numel()
                                            * blk[name].element_size())
        assert r["shapes"]["state"][2] == 4 and r["shapes"]["conv"][3] == 80
    # the same split from shard_cache of the whole cache
    from repro_torch.serve import KVShard
    cut = serve_model.shard_cache(full, cfg, get_policy("bf16"),
                                  KVShard(rank=1, world=2))["blocks"][0]
    assert {k: tuple(v.shape) for k, v in cut.items()} == \
        runs["ranks"][1]["shapes"]
