"""MoE serving through the port against the reference, split from
``tests/test_torch_moe_serve.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles:
granite-moe smoke's ``ServingEngine`` greedy streams token-identical at
float32 in the ring layout (5 prompts of 3-14 tokens over 2 slots, the
engine stats equal), and the ``Orchestrator`` over one slot streaming
what ``serve()`` streams, over two slots every stream error-free."""
import pytest

pytest.importorskip("torch")

from repro_torch.serve import (  # noqa: E402
    Orchestrator, Request, ServeConfig, ServingEngine, StreamingRequest)
from test_torch_moe_serve import (  # noqa: E402,F401
    _prompts, ARCH, check_streams, LAYOUTS, MAX_LEN, pair, POLICY)
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("arch,layout", [(ARCH, "ring")])
def test_engine_streams_token_identical(arch, layout, pair):
    check_streams(arch, layout, pair)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_orchestrator_streams_equal_serve(pair, layout):
    _, tc, _, tp = pair
    prompts = _prompts(tc.vocab, (5, 12, 9))
    scfg = dict(max_len=MAX_LEN, kv_format="posit8", **LAYOUTS[layout])

    def engine(max_batch):
        return ServingEngine(tc, tp, ServeConfig(max_batch=max_batch,
                                                 **scfg),
                             policy=POLICY, device="cpu")

    ref = [Request(uid=i, prompt=p, max_new=6) for i, p in
           enumerate(prompts)]
    engine(1).serve(ref)
    for max_batch in (1, 2):
        with Orchestrator(engine(max_batch)) as orch:
            sreqs = [StreamingRequest(p.tolist(), max_new=6)
                     for p in prompts]
            for s in sreqs:
                assert orch.submit(s, timeout=60.0)
            for s in sreqs:
                assert s.wait(120.0)
        assert all(s.error is None and len(s.out_tokens) == 6
                   for s in sreqs)
        assert orch.stats["finished"] == 3
        if max_batch == 1:
            assert [s.out_tokens for s in sreqs] == \
                [r.out_tokens for r in ref]
