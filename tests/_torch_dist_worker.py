"""One rank of the port's two-rank gloo runs on the CPU (not a test
module: the distributed tests start it as a process).

    python tests/_torch_dist_worker.py RANK WORLD DIR
        dense|models|families|recurrent

Joins the gloo process group through ``file://DIR/rendezvous``, reads the
cases' weights and prompts from ``DIR/inputs.pt`` (written by the test),
serves every case through the port's KV-sequence-sharded decode and
writes what it saw to ``DIR/rank<RANK>.pt``.  The cases: ``dense``
(``tests/test_torch_distributed{,_paged}.py``) paper-edge's float32
engines in one layout;
``models`` (``tests/test_torch_distributed_models.py``) the bf16 and MoE
engines, the guard and the vlm decode step; ``families``
(``tests/test_torch_distributed_families.py``) the hybrid stack's engine
and the audio stack's decode step; ``recurrent``
(``tests/test_torch_distributed_recurrent.py``) the SSM stack's engine.
Imports neither ``jax`` nor ``repro``.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core.transprecision import get_policy, kv_storage
from repro_torch.models import serve_model
from repro_torch.serve import (Fault, FaultPlan, Request, ServeConfig,
                               ServingEngine, distributed_decode_attention,
                               make_distributed_decode_step)

STREAM_FORMATS = ("f32", "posit16", "posit8")


def serve(cfg, params, prompts, max_new, *, layout="ring", kv_format="posit8",
          policy="bf16", page_size=8, num_pages=26, max_len=64, **kw):
    """Serve ``prompts`` through a ServingEngine whose decode attention is
    the sharded plug of the engine's own policy; returns the streams, the
    engine and the logits of every ``generate``."""
    scfg = ServeConfig(max_batch=len(prompts), max_len=max_len,
                       kv_format=kv_format, kv_layout=layout,
                       page_size=page_size,
                       num_pages=num_pages if layout == "paged" else None)
    probe = ServingEngine(cfg, params, scfg, policy=policy, device="cpu")
    plug = distributed_decode_attention(
        kv_spec=kv_storage(probe.policy), paged=layout == "paged",
        page_size=page_size)
    eng = ServingEngine(cfg, params, scfg, policy=policy, attn_impl=plug,
                        device="cpu", **kw)
    logits = []
    generate = eng.engine.generate

    def recorded(p, state):
        state, out = generate(p, state)
        logits.append(out.float().clone())
        return state, out

    eng.engine.generate = recorded
    reqs = [Request(uid=i, prompt=np.asarray(p), max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [r.out_tokens for r in reqs], eng, logits


def run_dense(inp):
    """paper-edge smoke at float32, ``inp["layout"]`` x f32, posit16 and
    posit8 KV: streams, KV bytes, leaf shapes, rows written."""
    out = {}
    cfg32 = dataclasses.replace(get_config("paper-edge", smoke=True),
                                dtype_name="float32")
    layout = inp["layout"]
    for fmt in STREAM_FORMATS:
        toks, eng, _ = serve(cfg32, inp["dense32"], inp["prompts"],
                             inp["max_new"], layout=layout, kv_format=fmt)
        blk = eng.cache["blocks"][0]
        out[layout, fmt] = {
            "tokens": toks, "kv_bytes": eng.kv_cache_bytes(),
            "shapes": {k: tuple(v.shape) for k, v in blk.items()}}
        if fmt == "posit8":     # rows this rank wrote: per slot (ring)
            out[layout, fmt]["written"] = (
                blk["k_scale"][0] != 1).any(-1).sum(-1)
    return out


def run_models(inp):
    """The bf16 and MoE engines, the guard's rung and the vlm decode
    step."""
    out = {}
    cfg32 = dataclasses.replace(get_config("paper-edge", smoke=True),
                                dtype_name="float32")
    cfg16 = get_config("paper-edge", smoke=True)
    toks, _, logits = serve(cfg16, inp["dense16"], inp["prompts"],
                            inp["max_new"])
    out["bf16"] = {"tokens": toks, "first_logits": logits[0]}
    cfg_moe = dataclasses.replace(get_config("granite-moe-1b-a400m",
                                             smoke=True), dtype_name="float32")
    out["moe"] = serve(cfg_moe, inp["moe32"], inp["moe_prompts"],
                       inp["max_new"])[0]
    # the guard: a poisoned round re-decoded by a rung that inherits the
    # plug (the rung's policy is the base one: same logits, same streams)
    plan = FaultPlan((Fault("poison_logits", at=3, slot=0),))
    toks, eng, _ = serve(cfg32, inp["dense32"], inp["prompts"],
                         inp["max_new"], guard=True, faults=plan)
    rung = eng.guard.rung(1)[0]
    out["guard"] = {"tokens": toks,
                    "fallbacks": eng.metrics.counter("guard.fallbacks").value,
                    "rung_inherits": rung.attn_impl is eng.engine.attn_impl}
    # vlm through make_distributed_decode_step, fed patch embeddings
    cfg_vlm = dataclasses.replace(get_config("qwen2-vl-2b", smoke=True),
                                  dtype_name="float32")
    policy = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    _, cache = serve_model.prefill(
        inp["vlm32"], {"embeds": torch.from_numpy(inp["vlm_embeds"])},
        cfg_vlm, 64, policy)
    step = make_distributed_decode_step(cfg_vlm, policy)
    cache = serve_model.shard_cache(cache, cfg_vlm, policy, step.shard)
    logits = []
    for e in inp["vlm_steps"]:
        lg, cache = step(inp["vlm32"], cache, torch.from_numpy(e))
        logits.append(lg.clone())
    out["vlm"] = logits
    return out


def run_families(inp):
    """The hybrid smoke config through the sharded engine (ring, f32 and
    posit8 KV: streams, KV bytes, every ring leaf's shape and the rank's
    recurrent state after the serve), and the audio smoke config's
    ``make_distributed_decode_step`` over a ``shard_cache``d prefill."""
    out = {}
    cfg_h = dataclasses.replace(get_config("recurrentgemma-9b", smoke=True),
                                dtype_name="float32")
    for fmt in ("f32", "posit8"):
        toks, eng, _ = serve(cfg_h, inp["hybrid32"], inp["hybrid_prompts"],
                             inp["max_new"], kv_format=fmt)
        out["hybrid", fmt] = {
            "tokens": toks, "kv_bytes": eng.kv_cache_bytes(),
            "shapes": {f"{part}/{i}/{k}": tuple(v.shape)
                       for part in ("blocks", "tail")
                       for i, blk in enumerate(eng.cache.get(part, ()))
                       for k, v in blk.items()}}
    cfg_a = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                                dtype_name="float32")
    policy = get_policy("bf16")
    _, cache = serve_model.prefill(
        inp["audio32"], {"tokens": torch.from_numpy(inp["audio_tokens"]),
                         "frames": torch.from_numpy(inp["audio_frames"])},
        cfg_a, 64, policy)
    step = make_distributed_decode_step(cfg_a, policy)
    cache = serve_model.shard_cache(cache, cfg_a, policy, step.shard)
    out["audio_k_shape"] = tuple(cache["blocks"][0]["k"].shape)
    out["audio_xk_shape"] = tuple(cache["blocks"][0]["xk"].shape)
    logits = []
    for t in inp["audio_steps"]:
        lg, cache = step(inp["audio32"], cache, torch.from_numpy(t))
        logits.append(lg.clone())
    out["audio"] = logits
    return out


def run_recurrent(inp):
    """The mamba2 smoke config through the sharded engine (ring, float32):
    streams, every decode step's logits and the rank's recurrent leaves'
    shapes and bytes after the serve."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True),
                              dtype_name="float32")
    toks, eng, logits = serve(cfg, inp["ssm32"], inp["ssm_prompts"],
                              inp["max_new"], kv_format="f32",
                              max_len=inp["max_len"])
    blk = eng.cache["blocks"][0]
    return {"tokens": toks, "logits": logits,
            "shapes": {k: tuple(v.shape) for k, v in blk.items()},
            "bytes": {k: v.numel() * v.element_size()
                      for k, v in blk.items()}}


CASES = {"dense": run_dense, "models": run_models, "families": run_families,
         "recurrent": run_recurrent}


def main(rank: int, world: int, root: Path, cases: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            world_size=world, rank=rank)
    try:
        inp = torch.load(root / "inputs.pt", weights_only=False)
        out = CASES[cases](inp)
        torch.save(out, root / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]), sys.argv[4])
