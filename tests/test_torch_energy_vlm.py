"""Modeled energy per token of the vlm family (qwen2-vl smoke, ring)
against ``repro.obs.energy``'s on the same weights, and full-width
qwen2-vl-2b priced on the meta device to a fixed joules per token; split
from ``tests/test_torch_energy.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import EnergyAccountant as JAccountant  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.obs import EnergyAccountant  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeConfig, ServingEngine)
from test_torch_energy import JPT_QWEN2VL, MAX_LEN, POLICY  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def test_accountant_matches_reference_vlm():
    """qwen2-vl smoke (float32, ring, posit8 KV format, max_batch 2):
    three 7-token prompts, 4 tokens each, one exact-length prefill per
    prompt.  The stages' calls and MACs equal the reference's exactly
    (M-RoPE's tables are elementwise: no MACs), modeled bytes and J/token
    within 1e-3."""
    from test_torch_vlm import family_pair
    jc, tc, jp, tp = family_pair("qwen2-vl-2b")
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    je = JServingEngine(jc, jp, JServeConfig(**kw), policy=POLICY)
    te = ServingEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                       device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, 7) for _ in range(3)]
    jr = [JRequest(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    je.serve(jr)
    te.serve(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jb, tb = JAccountant(je).breakdown(), EnergyAccountant(te).breakdown()
    assert "errors" not in tb and "errors" not in jb
    assert set(tb["stages"]) == set(jb["stages"]) == {"prefill", "insert",
                                                      "generate"}
    for name, j in jb["stages"].items():
        t = tb["stages"][name]
        assert (t["calls"], t["mac_flops"]) == (j["calls"],
                                                j["mac_flops"]), name
        assert t["model_bytes"] == pytest.approx(j["model_bytes"],
                                                 rel=1e-3), name
        assert t["pj_per_call"] == pytest.approx(j["pj_per_call"],
                                                 rel=1e-3), name
        assert t["mac_mix"] == j["mac_mix"], name
    assert tb["joules_per_token"] == pytest.approx(jb["joules_per_token"],
                                                   rel=1e-3)


def test_full_width_vlm_prices_on_the_meta_device():
    """Full-width qwen2-vl-2b (bf16, 28 layers, max_batch 8, max_len 1024,
    posit8 KV) priced with no weight, cache or activation allocated: one
    894-token exact-length prefill, an insert and a decode step on meta
    tensors, then the calls of an 8-prompt run (8 prefills, 8 inserts, 31
    decode steps, 256 tokens).  MACs are the analytic count: per layer
    QKV, ``wo`` and the gated MLP, QK + PV (decode over the 1024-row
    ring, prefill over every padded tile of the blockwise loop), and the
    tied head."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm
    from repro_torch.serve.engine_api import TransprecisionEngine
    cfg = get_config("qwen2-vl-2b")
    policy = dataclasses.replace(get_policy(POLICY), kv_format="posit8")
    meta = torch.device("meta")
    eng = TransprecisionEngine(cfg, lm.weights_free(policy, cfg.tie_embed),
                               8, 1024, weight_policy=policy, device=meta)
    params = lm.init_params(cfg, device=meta)
    state = eng.init_decode_state()
    s = 894
    prefix = eng.prefill(params, torch.empty((1, s), dtype=torch.int64,
                                             device=meta))
    eng.generate(params, eng.insert(prefix, state, 0))
    bd = EnergyAccountant(eng).breakdown(
        calls={"prefill": 8, "insert": 8, "generate": 31}, tokens=256)
    assert "errors" not in bd
    d, f, v, hd, nh, n_l = (cfg.d_model, cfg.d_ff, cfg.vocab_pad,
                            cfg.head_dim, cfg.n_heads, cfg.n_layers)
    layer = d * (nh + 2 * cfg.n_kv_heads) * hd + nh * hd * d + 3 * d * f
    st = bd["stages"]
    assert st["generate"]["mac_flops"] == 2 * 8 * (
        n_l * (layer + 2 * nh * 1024 * hd) + d * v)
    # padded tiles: q blocks of min(512, s) rows, kv blocks of min(1024, s)
    sp, skp = -(-s // 512) * 512, s
    assert st["prefill"]["mac_flops"] == 2 * (
        n_l * (s * layer + 2 * nh * sp * skp * hd) + d * v)
    assert st["insert"]["mac_flops"] == 0
    assert bd["joules_per_token"] == pytest.approx(JPT_QWEN2VL, rel=1e-12)
