"""Modeled energy per token of the SSM family (mamba2 smoke, ring)
against ``repro.obs.energy``'s on the same weights, and full-width
mamba2-2.7b priced on the meta device to a fixed joules per token; split
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
from test_torch_energy import (  # noqa: E402,F401
    JPT_MAMBA2, MAX_LEN, POLICY)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_accountant_matches_reference_ssm():
    """mamba2 smoke (float32, ring, posit8 KV format, max_batch 2): prompts
    of 5, 12 and 32 tokens, 4 tokens each.  The stages' calls and MACs
    equal the reference's exactly: 6 generate calls of 299,008 MAC FLOPs
    (the pairwise SSD products keep XLA's contractions: the decode's
    outer product is no product), 3 prefills priced at the first call's
    5 tokens, 671,808 (in_proj counted once, as XLA's CSE leaves it), and
    inserts of 0; modeled bytes and J/token within 1e-3 (the port's slot
    and row are Python ints, the reference's 4-byte arrays)."""
    from test_torch_ssm_serve import ssm_pair
    jc, tc, jp, tp = ssm_pair("float32")
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    je = JServingEngine(jc, jp, JServeConfig(**kw), policy=POLICY)
    te = ServingEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                       device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (5, 12, 32)]
    jr = [JRequest(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    tr = [Request(uid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)]
    je.serve(jr)
    te.serve(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jb, tb = JAccountant(je).breakdown(), EnergyAccountant(te).breakdown()
    assert "errors" not in tb and "errors" not in jb
    assert set(tb["stages"]) == set(jb["stages"]) == {"prefill", "insert",
                                                      "generate"}
    want = {"generate": (6, 299_008), "prefill": (3, 671_808),
            "insert": (3, 0)}
    for name, j in jb["stages"].items():
        t = tb["stages"][name]
        assert (t["calls"], t["mac_flops"]) == want[name] == (
            j["calls"], j["mac_flops"]), name
        assert t["model_bytes"] == pytest.approx(j["model_bytes"],
                                                 rel=1e-3), name
        assert t["pj_per_call"] == pytest.approx(j["pj_per_call"],
                                                 rel=1e-3), name
        assert t["mac_mix"] == j["mac_mix"], name
    assert tb["joules_per_token"] == pytest.approx(jb["joules_per_token"],
                                                   rel=1e-3)


def test_full_width_ssm_prices_on_the_meta_device():
    """Full-width mamba2-2.7b (bf16, 64 layers, max_batch 8, W 1024)
    priced with no weight, state or activation allocated: one 256-token
    prefill (one chunk), an insert and a decode step on meta tensors,
    then the calls of an 8-prompt run (8 prefills, 8 inserts, 31 decode
    steps, 256 tokens).  MACs are the analytic count: the decode step's
    two projections, SSD readout and the tied head per slot; the
    prefill's projections, the chunk's C.B scores, intra-chunk sum,
    chunk state and inter-chunk readout, and the head at one row."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm
    from repro_torch.models.ssm import dims
    from repro_torch.serve.engine_api import TransprecisionEngine
    cfg = get_config("mamba2-2.7b")
    policy = dataclasses.replace(get_policy(POLICY), kv_format="posit8")
    meta = torch.device("meta")
    eng = TransprecisionEngine(cfg, lm.weights_free(policy, cfg.tie_embed),
                               8, 1024, weight_policy=policy, device=meta)
    params = lm.init_params(cfg, device=meta)
    state = eng.init_decode_state()
    s = 256
    prefix = eng.prefill(params, torch.empty((1, s), dtype=torch.int64,
                                             device=meta))
    eng.generate(params, eng.insert(prefix, state, 0))
    bd = EnergyAccountant(eng).breakdown(
        calls={"prefill": 8, "insert": 8, "generate": 31}, tokens=256)
    assert "errors" not in bd
    d, n_l, v = cfg.d_model, cfg.n_layers, cfg.vocab_pad
    d_in, nh, _ = dims(cfg)
    hd, ds, ng = cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_groups
    proj = d * (2 * d_in + 2 * ng * ds + nh) + d_in * d
    st = bd["stages"]
    assert st["generate"]["mac_flops"] == 2 * 8 * (
        n_l * (proj + nh * hd * ds) + d * v)
    assert st["prefill"]["mac_flops"] == 2 * (
        n_l * (s * proj + ng * s * s * ds + nh * s * s * hd
               + 2 * nh * hd * ds * s) + d * v)
    assert st["insert"]["mac_flops"] == 0
    assert bd["joules_per_token"] == pytest.approx(JPT_MAMBA2, rel=1e-12)
