"""Paged-layout ServingEngine of the PyTorch port vs the JAX package's, at
float32 on paper-edge smoke under the paper_edge_p8 weight policy, split
from ``tests/test_torch_paged_engine.py`` (its helpers and fixture) so
that the driver's ``--dist loadfile`` spreads the reference's compiles:
``max_new=0`` reserving the first append page and ``page_overcommit``
eviction with recompute-on-readmit, streams token-identical and the
paging bookkeeping equal."""
import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_paged_engine import (  # noqa: E402,F401
    _assert_same, _serve, model)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_max_new_zero_reserves_first_append_page(model):
    tc = model[1]
    prompt = np.random.default_rng(3).integers(0, tc.vocab, 4)
    j, t = _serve(model, [(prompt, 0)], max_ticks=50, max_batch=1,
                  max_len=16, kv_format="f32", page_size=4, num_pages=3)
    _assert_same(j, t)
    req, eng = t[0][0], t[2]
    assert eng._worst_pages(req) == 2 == j[2]._worst_pages(j[0][0])
    assert len(req.out_tokens) == 1


def test_overcommit_evicts_and_readmits(model):
    """Worst-case reservation waived: 5 usable pages admit both prompts on
    current demand (2 + 3), the 11-token one's growth dries the pool, and
    the newest sequence is evicted and recomputed on readmission; streams
    equal the amply-pooled run and the reference's, with equal eviction
    counts.  Without overcommit the same pool runs them one at a time."""
    prompts = model[4]
    specs = [(prompts[0], 5), (prompts[1], 5)]
    full = dict(max_batch=2, max_len=32, kv_format="posit8", page_size=4)
    ref = _serve(model, specs, **full)
    j, t = _serve(model, specs, num_pages=6, page_overcommit=True, **full)
    _assert_same(j, t)
    assert t[1]["evictions"] >= 1
    assert [r.out_tokens for r in t[0]] == [r.out_tokens for r in ref[1][0]]
    strict = _serve(model, specs, num_pages=6, **full)
    _assert_same(*strict)
    assert strict[1][1]["evictions"] == 0
    assert [r.out_tokens for r in strict[1][0]] == \
        [r.out_tokens for r in ref[1][0]]
