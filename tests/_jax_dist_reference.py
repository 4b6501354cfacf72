"""The reference's side of the port's distributed tests (not a test
module: each test file runs it as one subprocess).

    python tests/_jax_dist_reference.py DIR dense|models|families|recurrent

Sets ``XLA_FLAGS`` for two host devices before ``jax`` is imported, builds
the reference's ``(1, 2)`` ``("data", "model")`` mesh with Auto axes (with
``jax.make_mesh``'s default Explicit axes its ring and posit-paged cache
scatters raise ``ShardingTypeError``), reads the prompts from
``DIR/inputs.npz`` and writes the reference's streams and logits to
``DIR/reference.npz``.  The weights are ``init_params`` at
``PRNGKey(0)``, as the tests build them.

With ``dense`` (``tests/test_torch_distributed{,_paged}.py``) it runs
its ``ServingEngine`` with and without its distributed decode
attention in the layout the inputs name, f32, posit16 and posit8 KV
(float32 model).  With
``models`` (``tests/test_torch_distributed_models.py``) its distributed
engine at bf16 (posit8 ring), the MoE smoke config's distributed streams
and the vlm smoke config's ``make_distributed_decode_step`` fed patch
embeddings.

With ``families`` (``tests/test_torch_distributed_families.py``) it runs
the hybrid and audio stacks instead: the recurrentgemma smoke config's
streams through its ``ServingEngine`` with and without the distributed
decode attention (ring, f32 and posit8 KV, float32 model), and the
whisper smoke config's ``make_distributed_decode_step`` logits over a
prefill of tokens and frames.  With ``recurrent``
(``tests/test_torch_distributed_recurrent.py``) the families' SSM member:
the mamba2 smoke config's streams and every decode step's logits
through its ``ServingEngine`` with and without the distributed decode
attention (ring, f32 KV, float32 model; the SSM decode ignores the plug,
so its distributed engine runs the whole state).
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.transprecision import get_policy, kv_storage  # noqa: E402
from repro.models import lm  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.serve.distributed import (  # noqa: E402
    distributed_decode_attention, make_distributed_decode_step)
from repro.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402


def serve(mesh, cfg, params, prompts, max_new, *, layout="ring",
          kv_format="posit8", distributed=True, share=None, max_len=64):
    """Serve ``prompts`` through the reference's ``ServingEngine``, with
    its distributed decode attention on ``mesh`` where ``distributed``;
    returns the streams, every ``generate``'s logits and the engine.
    ``share``, an engine of the same config, policy and layout, lends its
    compiled prefill and insert (neither reads the plug), so only the
    decode step compiles anew."""
    scfg = ServeConfig(max_batch=len(prompts), max_len=max_len,
                       kv_format=kv_format, kv_layout=layout, page_size=8,
                       num_pages=26 if layout == "paged" else None)
    eng = ServingEngine(cfg, params, scfg)
    if distributed:
        plug = distributed_decode_attention(
            mesh, "model", kv_spec=kv_storage(eng.policy),
            paged=layout == "paged", page_size=8)
        eng = ServingEngine(cfg, params, scfg, attn_impl=plug)
    if share is not None:
        eng.engine._prefill_jits = share.engine._prefill_jits
        eng.engine._insert_jits = share.engine._insert_jits
    logits = []
    generate = eng.engine.generate

    def recorded(p, state):
        state, out = generate(p, state)
        logits.append(np.asarray(out, np.float32))
        return state, out

    eng.engine.generate = recorded
    reqs = [Request(uid=i, prompt=np.asarray(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return np.asarray([r.out_tokens for r in reqs]), logits, eng


def _mesh():
    return jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def dense(root: str) -> None:
    inp = np.load(os.path.join(root, "inputs.npz"))
    prompts = [inp[f"prompt{i}"] for i in range(3)]
    max_new = int(inp["max_new"])
    mesh = _mesh()
    out = {}
    cfg32 = dataclasses.replace(get_config("paper-edge", smoke=True),
                                dtype_name="float32")
    p32 = lm.init_params(jax.random.PRNGKey(0), cfg32)
    layout = str(inp["layout"])
    for fmt in ("f32", "posit16", "posit8"):
        out[f"{layout}_{fmt}_engine"], _, eng = serve(
            mesh, cfg32, p32, prompts, max_new, layout=layout,
            kv_format=fmt, distributed=False)
        out[f"{layout}_{fmt}_dist"] = serve(
            mesh, cfg32, p32, prompts, max_new, layout=layout,
            kv_format=fmt, share=eng)[0]
    np.savez(os.path.join(root, "reference.npz"), **out)


def models(root: str) -> None:
    inp = np.load(os.path.join(root, "inputs.npz"))
    prompts = [inp[f"prompt{i}"] for i in range(3)]
    moe_prompts = [inp[f"moe_prompt{i}"] for i in range(3)]
    max_new = int(inp["max_new"])
    mesh = _mesh()
    out = {}
    cfg16 = get_config("paper-edge", smoke=True)
    toks, logits, _ = serve(mesh, cfg16, lm.init_params(jax.random.PRNGKey(0),
                                                     cfg16), prompts, max_new)
    out["bf16_dist"], out["bf16_first_logits"] = toks, logits[0]
    cfg_moe = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                             smoke=True), dtype_name="float32")
    out["moe_dist"] = serve(mesh, cfg_moe,
                            lm.init_params(jax.random.PRNGKey(0), cfg_moe),
                            moe_prompts, max_new)[0]
    cfg_vlm = dataclasses.replace(get_config("qwen2-vl-2b", smoke=True),
                                  dtype_name="float32")
    p_vlm = lm.init_params(jax.random.PRNGKey(0), cfg_vlm)
    policy = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    _, cache = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))(
        p_vlm, {"embeds": jnp.asarray(inp["vlm_embeds"])}, cfg_vlm, 64,
        policy)
    step = jax.jit(make_distributed_decode_step(cfg_vlm, policy, mesh, None))
    for i, e in enumerate(inp["vlm_steps"]):
        logits, cache = step(p_vlm, cache, jnp.asarray(e))
        out[f"vlm_logits{i}"] = np.asarray(logits, np.float32)
    np.savez(os.path.join(root, "reference.npz"), **out)


def families(root: str) -> None:
    inp = np.load(os.path.join(root, "inputs.npz"))
    mesh = _mesh()
    out = {}
    cfg_h = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                                dtype_name="float32")
    p_h = lm.init_params(jax.random.PRNGKey(0), cfg_h)
    prompts = [inp[f"hybrid_prompt{i}"] for i in range(int(inp["n_hybrid"]))]
    for fmt in ("f32", "posit8"):
        out[f"hybrid_{fmt}_engine"], _, eng = serve(
            mesh, cfg_h, p_h, prompts, int(inp["max_new"]), kv_format=fmt,
            distributed=False)
        out[f"hybrid_{fmt}_dist"] = serve(
            mesh, cfg_h, p_h, prompts, int(inp["max_new"]), kv_format=fmt,
            share=eng)[0]
    cfg_a = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                                dtype_name="float32")
    p_a = lm.init_params(jax.random.PRNGKey(0), cfg_a)
    policy = get_policy("bf16")
    _, cache = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))(
        p_a, {"tokens": jnp.asarray(inp["audio_tokens"]),
              "frames": jnp.asarray(inp["audio_frames"])}, cfg_a, 64, policy)
    step = jax.jit(make_distributed_decode_step(cfg_a, policy, mesh, None))
    for i, t in enumerate(inp["audio_steps"]):
        logits, cache = step(p_a, cache, jnp.asarray(t))
        out[f"audio_logits{i}"] = np.asarray(logits, np.float32)
    np.savez(os.path.join(root, "reference.npz"), **out)


def recurrent(root: str) -> None:
    inp = np.load(os.path.join(root, "inputs.npz"))
    mesh = _mesh()
    cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True),
                              dtype_name="float32")
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    prompts = [inp[f"ssm_prompt{i}"] for i in range(int(inp["n_ssm"]))]
    kw = dict(kv_format="f32", max_len=int(inp["max_len"]))
    out = {}
    out["ssm_engine"], _, eng = serve(mesh, cfg, params, prompts,
                                      int(inp["max_new"]), distributed=False,
                                      **kw)
    out["ssm_dist"], logits, _ = serve(mesh, cfg, params, prompts,
                                       int(inp["max_new"]), share=eng, **kw)
    for i, lg in enumerate(logits):
        out[f"ssm_logits{i}"] = lg
    np.savez(os.path.join(root, "reference.npz"), **out)


if __name__ == "__main__":
    {"dense": dense, "models": models, "families": families,
     "recurrent": recurrent}[sys.argv[2]](sys.argv[1])
