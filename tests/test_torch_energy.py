"""Modeled energy per token of the port (``repro_torch.obs.energy``) on
paper-edge smoke at float32, where the two packages' greedy streams are
token-identical: every invariant of ``tests/test_energy.py`` (the
constants pinned to ``benchmarks.hwmodel``, by-dtype splits, the packed-KV
traffic against ``kv_cache_bytes``, determinism, monotone joules, gauges
and windows, the draft step cheaper than a target step), the accountant
against ``repro.obs.energy``'s on the same weights (ring posit8 and
posit16, paged posit8, speculative gamma 2: per-stage MACs exactly equal,
modeled bytes within 0.1 %, pJ per call and J/token within rel 1e-3, equal
calls), pricing that leaves the engine's state and weights as they
were, and full-width paper-edge priced on the meta device (no weights, no
card) to fixed joules per token."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import EnergyAccountant as JAccountant  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch.core.transprecision import PRESETS  # noqa: E402
from repro_torch.core.transprecision import hbm_bytes_per_param  # noqa: E402
from repro_torch.launch.op_cost import analyze  # noqa: E402
from repro_torch.launch.op_cost import entry_param_bytes_by_dtype  # noqa: E402
from repro_torch.obs import EnergyAccountant, format_energy  # noqa: E402
from repro_torch.obs import energy as energy_mod  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.speculative import SpeculativeEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402

MAX_LEN = 64
POLICY = "paper_edge_p8"


@pytest.fixture(scope="module")
def pair():
    return smoke_pair("float32")


def _requests(R, vocab, n=3, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [R(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 13))),
              max_new=max_new) for i in range(n)]


def _engine(pair, policy=POLICY, max_batch=2, **kw):
    _, tc, _, tp = pair
    return ServingEngine(tc, tp, ServeConfig(max_batch=max_batch,
                                             max_len=MAX_LEN, **kw),
                         policy=policy, device="cpu")


@pytest.fixture(scope="module")
def served(pair):
    """A posit8-KV ring engine that has served a batch (tracer on)."""
    eng = _engine(pair, kv_format="posit8")
    eng.tracer.enable()
    eng.serve(_requests(Request, pair[1].vocab))
    return eng


def _cache_bytes(eng, dtype):
    return sum(t.numel() * t.element_size()
               for blk in eng.cache["blocks"] for t in blk.values()
               if t.dtype == dtype)


# ---- constants pinned to the hardware model ----

def test_energy_constants_match_hwmodel():
    from benchmarks.hwmodel import TALU
    from benchmarks.hwmodel import DRAM_PJ_PER_BYTE as HW_DRAM
    from benchmarks.hwmodel import pj_per_mac as hw_pj
    from repro.core.transprecision import PRESETS as J_PRESETS
    from repro.core.transprecision import hbm_bytes_per_param as j_hbm
    assert TALU.pdp_pj == (38.9, 43.44, 46.15)   # paper Table IV
    assert energy_mod.DRAM_PJ_PER_BYTE == HW_DRAM == 20.0
    for bits, want in ((4, 38.9), (8, 38.9), (9, 43.44), (16, 43.44),
                       (17, 46.15), (32, 46.15)):
        assert energy_mod.pj_per_mac(bits) == hw_pj(bits) == want
    # the storage-width rule the accountant re-prices weights with
    for name, pol in PRESETS.items():
        for role in ("attn_weights", "mlp_weights", "embed_weights"):
            assert hbm_bytes_per_param(pol, role) == j_hbm(J_PRESETS[name],
                                                           role)


# ---- op counter by-dtype splits on a served stage ----

def test_by_dtype_splits_sum_to_totals(served):
    fn, spec = served.engine.stage_specs["generate"]
    ana = analyze(fn, spec)
    assert ana["flops"] > 0 and ana["bytes"] > 0
    assert sum(ana["flops_by_dtype"].values()) == pytest.approx(
        ana["flops"], rel=1e-9)
    assert sum(ana["bytes_by_dtype"].values()) == pytest.approx(
        ana["bytes"], rel=1e-9)
    assert 0 < ana["mac_flops"] <= ana["flops"]


def test_posit8_kv_traffic_matches_kv_cache_bytes(served):
    """The u8 entry bytes of the decode stage are exactly the engine's
    uint8 KV code buffers, and those bytes are in ``kv_cache_bytes``."""
    pb = entry_param_bytes_by_dtype(served.engine.stage_specs["generate"][1])
    cache_u8 = _cache_bytes(served, torch.uint8)
    assert cache_u8 > 0, "posit8 KV cache should store u8 codes"
    assert pb.get("u8", 0) == pytest.approx(cache_u8)
    assert cache_u8 <= served.kv_cache_bytes()


def test_posit16_kv_traffic_is_16_bit_codes(pair):
    """posit16 codes enter at 2 bytes each.  The port keeps them in int16
    (the reference's u16 bits; torch's uint16 lacks the ops), so they
    count under ``s16``."""
    eng = _engine(pair, max_batch=1, kv_format="posit16")
    eng.serve(_requests(Request, pair[1].vocab, n=1, max_new=2))
    pb = entry_param_bytes_by_dtype(eng.engine.stage_specs["generate"][1])
    cache_16 = _cache_bytes(eng, torch.int16)
    assert cache_16 > 0 and "u8" not in pb
    assert pb.get("s16", 0) == pytest.approx(cache_16)


# ---- energy table ----

def test_pj_table_deterministic(served):
    t1 = {k: v.as_dict() for k, v in EnergyAccountant(served).table().items()}
    energy_mod._COST_CACHE.clear()      # force a full re-trace
    t2 = {k: v.as_dict() for k, v in EnergyAccountant(served).table().items()}
    assert t1 == t2
    assert set(t1) == {"prefill", "insert", "generate"}
    for e in t1.values():
        assert e["pj_per_call"] >= 0


def test_joules_monotone_in_tokens(pair):
    eng = _engine(pair, kv_format="posit8")
    acct = EnergyAccountant(eng)
    eng.serve(_requests(Request, pair[1].vocab, n=2, max_new=4))
    b1 = acct.breakdown()
    eng.serve(_requests(Request, pair[1].vocab, n=2, max_new=8, seed=1))
    b2 = acct.breakdown()
    assert b2["joules_total"] > b1["joules_total"] > 0
    assert b2["tokens"] > b1["tokens"]
    assert b1["joules_per_token"] > 0
    g = eng.metrics.snapshot()["gauges"]
    assert g["energy.joules_total"] == pytest.approx(b2["joules_total"])
    assert g["energy.joules_per_token"] == pytest.approx(
        b2["joules_per_token"])
    delta = acct.calls_delta(acct.calls_snapshot(), {})
    win = acct.breakdown(calls=delta, tokens=b2["tokens"])
    assert win["joules_total"] == pytest.approx(b2["joules_total"])
    text = format_energy(b2)
    assert text.startswith("energy (modeled: TALU Table IV, 20 pJ/B DRAM)")
    assert all(name in text for name in ("prefill", "insert", "generate"))


def test_draft_step_cheaper_than_target_step(pair):
    """A posit8-weight draft decode step prices below a decode step at the
    target's precision (the default policy: float weights)."""
    _, tc, _, tp = pair
    scfg = ServeConfig(max_batch=2, max_len=MAX_LEN, kv_format="posit8")
    spec = SpeculativeEngine(tc, tp, scfg, gamma=2, device="cpu")
    spec.serve(_requests(Request, tc.vocab))
    base = ServingEngine(tc, tp, scfg, device="cpu")
    base.serve(_requests(Request, tc.vocab))
    d = EnergyAccountant(spec).table()["draft.generate"]
    t = EnergyAccountant(base).table()["generate"]
    assert d.pj_total < t.pj_total
    assert d.pj_compute < t.pj_compute
    assert d.pj_memory < t.pj_memory
    assert max(d.mac_mix.values(), key=lambda v: v["frac"])["bits"] == 8


# ---- the accountant against the reference's ----

CASES = {"ring_posit8": ({"kv_format": "posit8"}, None),
         "ring_posit16": ({"kv_format": "posit16"}, None),
         "paged_posit8": ({"kv_format": "posit8", "kv_layout": "paged",
                           "page_size": 8}, None),
         "speculative_ring": ({"kv_format": "posit8"}, 2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_accountant_matches_reference(pair, case):
    jc, tc, jp, tp = pair
    kw, gamma = CASES[case]
    if gamma is None:
        je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                                 **kw), policy=POLICY)
        te = _engine(pair, **kw)
    else:
        je = JSpeculative(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                               **kw), policy=POLICY,
                          gamma=gamma)
        te = SpeculativeEngine(tc, tp, ServeConfig(max_batch=2,
                                                   max_len=MAX_LEN, **kw),
                               policy=POLICY, gamma=gamma, device="cpu")
    jr, tr = _requests(JRequest, tc.vocab), _requests(Request, tc.vocab)
    je.serve(jr)
    te.serve(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jb, tb = JAccountant(je).breakdown(), EnergyAccountant(te).breakdown()
    assert "errors" not in tb and "errors" not in jb
    assert set(tb["stages"]) == set(jb["stages"])
    if gamma is not None:
        assert {"draft.generate", "draft.rollback", "verify",
                "rollback"} <= set(tb["stages"])
    for name, j in jb["stages"].items():
        t = tb["stages"][name]
        assert t["calls"] == j["calls"], name
        assert t["mac_flops"] == j["mac_flops"], name
        assert t["model_bytes"] == pytest.approx(j["model_bytes"],
                                                 rel=1e-3), name
        assert t["pj_per_call"] == pytest.approx(j["pj_per_call"],
                                                 rel=1e-3), name
        assert t["mac_mix"] == j["mac_mix"], name
    assert tb["tokens"] == jb["tokens"]
    assert tb["joules_per_token"] == pytest.approx(jb["joules_per_token"],
                                                   rel=1e-3)


def test_pricing_leaves_state_and_weights_unchanged(pair):
    eng = _engine(pair, kv_format="posit8", kv_layout="paged", page_size=8)
    eng.serve(_requests(Request, pair[1].vocab))
    before = _tensors((eng.cache, eng.params))
    energy_mod._COST_CACHE.clear()
    table = EnergyAccountant(eng).table()
    assert set(table) == {"prefill", "insert", "generate"}
    after = _tensors((eng.cache, eng.params))
    assert len(after) == len(before) > 0
    for (a, x), (b, y) in zip(before, after):
        assert a is b and torch.equal(x, y)


def _tensors(tree):
    """(tensor, a copy of it) for every tensor leaf of ``tree``."""
    if isinstance(tree, torch.Tensor):
        return [(tree, tree.clone())]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [p for v in tree for p in _tensors(v)]
    return []


# ---- full width on the meta device ----

@pytest.mark.parametrize("layout,num_pages,steps,jpt", [
    ("ring", None, 31, 0.011653017143471608),
    ("paged", 257, 62, 0.016746763060541008)])
def test_full_width_prices_on_the_meta_device(layout, num_pages, steps,
                                              jpt):
    """Full-width paper-edge (bf16, max_batch 8, W 1024, posit8 KV) priced
    with no weight, cache or activation allocated: one B = 1 prefill at
    bucket 64, an insert and a decode step on meta tensors, then the
    calls of an 8-prompt run (8 prefills, 8 inserts, ``steps`` decode
    steps, 256 tokens).  ``generate``'s MACs are the analytic count: every
    block matrix and the head per slot, plus QK and PV over 1024 rows."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models import lm
    from repro_torch.serve.engine_api import TransprecisionEngine
    cfg = get_config("paper-edge")
    policy = dataclasses.replace(get_policy(POLICY), kv_format="posit8",
                                 kv_layout=layout, kv_page_size=16)
    meta = torch.device("meta")
    eng = TransprecisionEngine(cfg, lm.weights_free(policy), 8, 1024,
                               weight_policy=policy, num_pages=num_pages,
                               device=meta)
    params = lm.init_params(cfg, device=meta)
    state = eng.init_decode_state()
    prefix = eng.prefill(params, torch.empty((1, 64), dtype=torch.int64,
                                             device=meta),
                         torch.empty((1,), dtype=torch.int32, device=meta))
    dst = (torch.empty((64,), dtype=torch.int64, device=meta)
           if num_pages else None)
    eng.generate(params, eng.insert(prefix, state, 0, dst_rows=dst))
    bd = EnergyAccountant(eng).breakdown(
        calls={"prefill": 8, "insert": 8, "generate": steps}, tokens=256)
    assert "errors" not in bd
    d, hd, n_l = cfg.d_model, cfg.head_dim, cfg.n_layers
    per_token = n_l * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
                       + cfg.n_heads * hd * d + 3 * d * cfg.d_ff)
    assert bd["stages"]["generate"]["mac_flops"] == (
        2 * 8 * (per_token + d * cfg.vocab_pad)
        + 4 * 8 * n_l * cfg.n_heads * 1024 * hd)
    assert bd["joules_per_token"] == pytest.approx(jpt, rel=1e-12)
