"""The distributed decode of the port (``serve/distributed.py``) on the
bf16, MoE and vlm configs and under the numeric guard, against the
reference's and the port's undistributed paths: two gloo ranks on the
CPU (``tests/_torch_dist_worker.py ... models``) and the reference on
two host devices (``tests/_jax_dist_reference.py DIR models``), one start
each per module, started as ``test_torch_distributed.py`` starts its own
(its helpers), the port's undistributed side served meanwhile.

* paper-edge smoke at bf16, posit8 ring: the first decode step's logits
  within 0.1 of the reference's distributed path's; both ranks equal.
* granite-moe smoke (float32, ring posit8, three 40-token prompts): both
  ranks' streams equal the reference's distributed engine's and the
  port's undistributed engine's.
* qwen2-vl smoke through ``make_distributed_decode_step`` fed patch
  embeddings over a ``shard_cache``d prefill: logits within the vlm
  parity tolerance of the reference's and of the port's
  ``decode_step``.
* A poisoned round re-decoded by a guard rung that inherits the plug:
  the streams equal the undistributed guarded engine's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import serve_model  # noqa: E402
from repro_torch.serve import Fault, FaultPlan  # noqa: E402
from test_torch_distributed import (MAX_NEW, _inputs, _pair,  # noqa: E402
                                    _serve, start_runs)
from _torch_threads import torch_threads  # noqa: E402,F401

PLAN = FaultPlan((Fault("poison_logits", at=3, slot=0),))


def _vlm_plain(cfg, params, embeds, steps):
    """The port's undistributed decode_step logits over the prefill."""
    policy = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    _, cache = serve_model.prefill(params, {"embeds": torch.from_numpy(
        embeds)}, cfg, 64, policy)
    out = []
    for e in steps:
        logits, cache = serve_model.decode_step(
            params, cache, None, cfg, policy, embeds=torch.from_numpy(e))
        out.append(logits)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results and the reference's, from one start each, and
    the port's undistributed side (served meanwhile)."""
    root = tmp_path_factory.mktemp("distributed_models")
    prompts, moe_prompts, embeds, steps = _inputs()
    np.savez(root / "inputs.npz", max_new=MAX_NEW, vlm_embeds=embeds,
             vlm_steps=steps, **{f"prompt{i}": p for i, p in
                                 enumerate(prompts)},
             **{f"moe_prompt{i}": p for i, p in enumerate(moe_prompts)})
    models = {"dense32": _pair("paper-edge", "float32"),
              "dense16": _pair("paper-edge", "bfloat16"),
              "moe32": _pair("granite-moe-1b-a400m", "float32"),
              "vlm32": _pair("qwen2-vl-2b", "float32")}

    def plain():
        guard, eng = _serve(*models["dense32"], prompts, guard=True,
                            faults=PLAN)
        return {"moe": _serve(*models["moe32"], moe_prompts)[0],
                "vlm": _vlm_plain(*models["vlm32"], embeds, steps),
                "guard": guard,
                "guard_fallbacks": eng.metrics.counter(
                    "guard.fallbacks").value}

    return start_runs(root, "models", models, {
        "prompts": prompts, "moe_prompts": moe_prompts,
        "vlm_embeds": embeds, "vlm_steps": steps}, plain)


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
    assert r0["moe"] == runs["plain"]["moe"]


def test_two_rank_vlm_decode_step_with_embeds(runs):
    """make_distributed_decode_step on patch embeddings: logits within the
    vlm parity tolerance of the reference's (M-RoPE's tables agree within
    1e-6) and of the port's undistributed decode_step."""
    (r0, r1), ref = runs["ranks"], runs["ref"]
    assert len(runs["plain"]["vlm"]) == len(r0["vlm"]) == len(_inputs()[3])
    for i, want in enumerate(runs["plain"]["vlm"]):
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
    assert runs["plain"]["guard_fallbacks"] == 1
    assert r0["guard"]["tokens"] == r1["guard"]["tokens"] == \
        runs["plain"]["guard"]
