"""Paged-layout ServingEngine of the PyTorch port vs the JAX package's, at
float32 on paper-edge smoke under the paper_edge_p8 weight policy, split
from ``tests/test_torch_paged_engine.py`` (its helpers and fixture) so
that the driver's ``--dist loadfile`` spreads the reference's compiles:
slot reuse after EOS that frees pages, and admission without
head-of-line blocking; streams token-identical and the paging
bookkeeping equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeConfig, ServingEngine)
from test_torch_paged_engine import (  # noqa: E402,F401
    _assert_same, _serve, model)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_slot_reuse_after_eos_frees_pages(model):
    """EOS mid-stream frees the slot and its pages; later entries reuse
    both.  The EOS token is one the port's own stream emits second, so the
    EOS path runs."""
    _, tc, _, tp, prompts = model
    specs = [(prompts[i % 3], 5) for i in range(5)]
    probe = Request(uid=0, prompt=prompts[0], max_new=5)
    ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=32,
                                      kv_format="f32", kv_layout="paged",
                                      page_size=4),
                  policy="paper_edge_p8", device="cpu").serve([probe])
    eos = probe.out_tokens[1]
    j, t = _serve(model, specs, max_batch=2, max_len=32, kv_format="f32",
                  page_size=4, eos_id=eos)
    _assert_same(j, t)
    assert t[1]["prefills"] == 5
    assert any(r.out_tokens[-1] == eos and len(r.out_tokens) < 5
               for r in t[0])


def test_no_head_of_line_blocking(model):
    """An oversized head is rejected outright; feasible entries behind it
    still run (the 12-token one needs every allocatable page)."""
    tc = model[1]
    rng = np.random.default_rng(1)
    specs = [(rng.integers(0, tc.vocab, 20), 4),
             (rng.integers(0, tc.vocab, 11), 3),
             (rng.integers(0, tc.vocab, 3), 3)]
    j, t = _serve(model, specs, max_batch=2, max_len=16, kv_format="f32",
                  page_size=4, num_pages=5)
    _assert_same(j, t)
    too_long, big, small = t[0]
    assert too_long.error is not None and not too_long.out_tokens
    assert t[1]["rejected"] == 1
    assert len(big.out_tokens) == 3 and len(small.out_tokens) == 3
