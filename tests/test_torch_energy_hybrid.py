"""Modeled energy per token of the hybrid family (recurrentgemma smoke,
ring) against ``repro.obs.energy``'s on the same weights, and full-width
recurrentgemma-9b priced on the meta device to a fixed joules per token;
split from ``tests/test_torch_energy.py`` (its helpers and tolerances) so
that the driver's ``--dist loadfile`` spreads the reference's
compiles."""
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
from test_torch_energy import JPT_RGEMMA, MAX_LEN, POLICY  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


def test_accountant_matches_reference_hybrid():
    """recurrentgemma smoke (float32, ring, posit8 KV format, max_batch
    2): prompts of 5, 12 and 30 tokens (the last wraps the 16-row
    window), 4 tokens each.  The stages' calls and MACs equal the
    reference's exactly (the RG-LRU scan and the conv are elementwise:
    no MACs; the prefill's separate ``h @ wx`` product counts beside the
    fused ``[wy | wx]`` one, as XLA keeps both), with the recurrent
    projections priced at ``mlp_weights``' format in both; modeled bytes
    and J/token within 1e-3."""
    from test_torch_rglru import hybrid_pair
    jc, tc, jp, tp = hybrid_pair("float32")
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    je = JServingEngine(jc, jp, JServeConfig(**kw), policy=POLICY)
    te = ServingEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                       device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (5, 12, 30)]
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


def test_full_width_hybrid_prices_on_the_meta_device():
    """Full-width recurrentgemma-9b (bf16, 38 layers, max_batch 8,
    max_len 4096, 2048-row rings) priced with no weight, state or
    activation allocated: one 2500-token prefill (past the window), an
    insert and a decode step on meta tensors, then the calls of an
    8-prompt run (8 prefills, 8 inserts, 31 decode steps, 256 tokens).
    MACs are the analytic count: per recurrent layer ``wy``, ``wx``, the
    fused RG-LRU gates, ``w_out`` and the MLP (the prefill's fused ``[wy |
    wx]`` product and its own ``h @ wx``), per attention layer QKV, ``wo``,
    the MLP and QK + PV (decode over the 2048-row ring, prefill over every
    padded tile of the blockwise loop), and the tied head."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm
    from repro_torch.serve.engine_api import TransprecisionEngine
    cfg = get_config("recurrentgemma-9b")
    policy = dataclasses.replace(get_policy(POLICY), kv_format="posit8")
    meta = torch.device("meta")
    eng = TransprecisionEngine(cfg, lm.weights_free(policy, cfg.tie_embed),
                               8, 4096, weight_policy=policy, device=meta)
    params = lm.init_params(cfg, device=meta)
    state = eng.init_decode_state()
    s = 2500
    prefix = eng.prefill(params, torch.empty((1, s), dtype=torch.int64,
                                             device=meta))
    eng.generate(params, eng.insert(prefix, state, 0))
    bd = EnergyAccountant(eng).breakdown(
        calls={"prefill": 8, "insert": 8, "generate": 31}, tokens=256)
    assert "errors" not in bd
    d, f, v, hd, nh = (cfg.d_model, cfg.d_ff, cfg.vocab_pad, cfg.head_dim,
                       cfg.n_heads)
    n_rec, n_attn = cfg.block_types.count("rec"), cfg.block_types.count(
        "attn")
    qkv_o = d * (nh + 2 * cfg.n_kv_heads) * hd + nh * hd * d
    mlp, w = 2 * d * f, cfg.window
    st = bd["stages"]
    assert st["generate"]["mac_flops"] == 2 * 8 * (
        n_rec * (5 * d * d + mlp) + n_attn * (qkv_o + mlp + 2 * nh * w * hd)
        + d * v)
    sp, skp = -(-s // 512) * 512, -(-s // 1024) * 1024     # padded tiles
    assert st["prefill"]["mac_flops"] == 2 * (
        s * n_rec * (6 * d * d + mlp)
        + n_attn * (s * (qkv_o + mlp) + 2 * nh * sp * skp * hd) + d * v)
    assert st["insert"]["mac_flops"] == 0
    assert bd["joules_per_token"] == pytest.approx(JPT_RGEMMA, rel=1e-12)
