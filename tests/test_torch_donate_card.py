"""The donated ``generate`` captured and replayed on the card (marker
``cuda``; skips without a GPU): the first tick after
``init_decode_state`` runs eagerly, the second captures the fixed-buffer
step as a CUDA graph and replays it, later ones replay; logits, tokens
and the wrappers' launch counts equal a non-donating engine's tick by
tick, on paper-edge smoke (ring) and mamba2 smoke (two graphs, one per
parity of its recurrent sets).  No JAX import: the machine with the GPU
has none (``test_torch_donate.py`` holds the CPU path to the
reference)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["paper-edge", "mamba2-2.7b"])
def test_capture_and_replay_on_card(arch):
    """Six ticks of a donating and a non-donating engine from one prefix
    in slot 0: equal logits, tokens and launches at every tick; one eager
    tick, then replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (graph capture has no CPU mode)")
    from repro_torch.kernels import LAUNCHES, reset_launches
    cfg = get_config(arch, smoke=True)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    pol = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    engines = [TransprecisionEngine(cfg, pol, 2, 64, device="cuda",
                                    donate=d) for d in (True, False)]
    assert engines[0].donate
    toks = torch.randint(0, cfg.vocab, (1, 32), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(
                             1))
    states = [e.insert(e.prefill(params, toks), e.init_decode_state(), 0)
              for e in engines]
    for n in range(6):
        out = []
        for i, e in enumerate(engines):
            reset_launches()
            states[i], logits = e.generate(params, states[i])
            torch.cuda.synchronize()
            out.append((logits, states[i]["tok"].clone(), dict(LAUNCHES)))
        assert torch.equal(out[0][0], out[1][0]), n
        assert torch.equal(out[0][1], out[1][1]), n
        assert out[0][2] == out[1][2], n
    stats = engines[0].graph_stats()
    assert stats["eager_ticks"] == 1 and stats["replays"] == 5
    assert len(stats["launches"]) == (2 if cfg.family == "ssm" else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_speculative_round_captured_on_card(layout):
    """A speculative engine (gamma 2) whose verify and rollbacks replay
    CUDA graphs against one serving eagerly (``donate=False`` on target
    and draft), paper-edge smoke: equal streams, every verify's logits
    equal, the same launches per round, one eager call per (stage, shape)
    and then replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (graph capture has no CPU mode)")
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.serve import Request, ServeConfig, SpeculativeEngine
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), device="cuda")
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=torch.Generator(
        ).manual_seed(n)).tolist() for n in (5, 9, 12, 7)]
    kw = {"kv_layout": "paged", "page_size": 8} if layout == "paged" else {}
    runs = []
    for donate in (True, False):
        eng = SpeculativeEngine(cfg, params, ServeConfig(
            max_batch=2, max_len=64, kv_format="posit8", **kw), gamma=2,
            device="cuda")
        assert eng.engine.donate and eng.draft_engine.donate
        if not donate:
            eng.engine.donate = eng.draft_engine.donate = False
        logits, verify = [], eng.engine.verify

        def logged(p, state, chunk, _v=verify, _l=logits):
            state, lg = _v(p, state, chunk)
            _l.append(lg.clone())
            return state, lg

        eng.engine.verify = logged
        reqs = [Request(uid=i, prompt=p, max_new=12)
                for i, p in enumerate(prompts)]
        reset_launches()
        eng.serve(reqs)
        torch.cuda.synchronize()
        runs.append(([r.out_tokens for r in reqs], logits, dict(LAUNCHES),
                     eng))
    (c_out, c_lg, c_n, eng), (e_out, e_lg, e_n, _) = runs
    assert c_out == e_out
    assert len(c_lg) == len(e_lg)
    assert all(torch.equal(a, b) for a, b in zip(c_lg, e_lg))
    assert c_n == e_n
    for engine in (eng.engine, eng.draft_engine):
        stats = engine.graph_stats()
        for stage in ("verify", "rollback_ring", "rollback_paged"):
            for rec in stats.get(stage, {}).values():
                assert rec["eager_calls"] == 1, (stage, rec)
                if rec["replays"]:
                    assert rec["launches"] is not None
