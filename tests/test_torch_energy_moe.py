"""Modeled energy per token of the MoE family (granite-moe smoke at
float32, ring and paged) against ``repro.obs.energy``'s on the same
weights: per-stage MACs exactly equal, modeled bytes within 0.1 %, pJ per
call and J/token within rel 1e-3, equal calls; split from
``tests/test_torch_energy.py`` (its helpers and tolerances) so that the
driver's ``--dist loadfile`` spreads the reference's compiles."""
import pytest

pytest.importorskip("torch")

from repro.obs import EnergyAccountant as JAccountant  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.obs import EnergyAccountant  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeConfig, ServingEngine)
from test_torch_energy import _requests, MAX_LEN, POLICY  # noqa: E402,F401
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_accountant_matches_reference_moe(layout):
    """The MoE family (granite-moe-1b-a400m smoke, float32): one
    exact-length prefill per prompt into a max_len-wide prefix, the
    router and the expert products priced; the same rules as the dense
    cases."""
    from test_torch_moe_serve import moe_pair
    jc, tc, jp, tp = moe_pair("float32")
    kw = dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
              **({"kv_layout": "paged", "page_size": 8}
                 if layout == "paged" else {}))
    je = JServingEngine(jc, jp, JServeConfig(**kw), policy=POLICY)
    te = ServingEngine(tc, tp, ServeConfig(**kw), policy=POLICY,
                       device="cpu")
    jr, tr = _requests(JRequest, tc.vocab), _requests(Request, tc.vocab)
    je.serve(jr)
    te.serve(tr)
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    jb, tb = JAccountant(je).breakdown(), EnergyAccountant(te).breakdown()
    assert "errors" not in tb and "errors" not in jb
    assert set(tb["stages"]) == set(jb["stages"]) == {"prefill", "insert",
                                                      "generate"}
    for name, j in jb["stages"].items():
        t = tb["stages"][name]
        assert t["calls"] == j["calls"], name
        assert t["mac_flops"] == j["mac_flops"], name
        assert t["model_bytes"] == pytest.approx(j["model_bytes"],
                                                 rel=1e-3), name
        assert t["pj_per_call"] == pytest.approx(j["pj_per_call"],
                                                 rel=1e-3), name
        assert t["mac_mix"] == j["mac_mix"], name
    assert tb["joules_per_token"] == pytest.approx(jb["joules_per_token"],
                                                   rel=1e-3)
