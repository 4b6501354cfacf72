"""The donated ``generate`` over the MoE smoke stack (granite-moe), on
the CPU (the fixed-buffer step runs eagerly there), at float32 under
``paper_edge_p8`` with a posit8 KV format, ring and paged: a donating
``ServingEngine``'s greedy streams equal a non-donating one's and the
reference's ``ServingEngine``'s.  Every prompt has one length, so each
reference engine compiles one exact-length prefill (``check_streams``,
which the other families' files share).

The SSM and hybrid stacks are in ``test_torch_donate_recurrent.py``, the
vlm and audio stacks in ``test_torch_donate_vlm_audio.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve import ServeConfig, ServingEngine  # noqa: E402
from test_torch_donate import donating, serve  # noqa: E402
from test_torch_vlm import family_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

POLICY = "paper_edge_p8"
MAX_LEN = 64


def check_streams(arch, layout, lens=(12, 12, 12)):
    jc, tc, jp, tp = family_pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tc.vocab, n) for n in lens]
    kw = dict(kv_layout="paged", page_size=8) if layout == "paged" else {}
    je = JServingEngine(jc, jp, JServeConfig(
        max_batch=2, max_len=MAX_LEN, kv_format="posit8", **kw),
        policy=POLICY)
    jr = [JRequest(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    je.serve(jr)
    scfg = ServeConfig(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
                       **kw)
    eager = serve(ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu"),
                  prompts)
    donated = serve(donating(ServingEngine(tc, tp, scfg, policy=POLICY,
                                           device="cpu")), prompts)
    assert donated == eager == [r.out_tokens for r in jr]


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_moe_streams(layout):
    check_streams("granite-moe-1b-a400m", layout)
