"""Paged-layout ServingEngine of the PyTorch port vs the JAX package's, at
float32 on paper-edge smoke under the paper_edge_p8 weight policy.

Greedy streams must be token-identical, and the paging bookkeeping equal
(prefills, decode steps, evictions, peak live pages, reserved / live /
peak-live KV bytes), across mixed prompt lengths, slot reuse after EOS
that frees pages, admission without head-of-line blocking, transient page
pressure, ``max_new=0`` and ``page_overcommit`` eviction with
recompute-on-readmit.  On ``benchmarks/bench_paged_kv.py``'s shape the
peak live KV bytes come to 0.1719x the ring's for every format, as in the
reference's baseline.  The cases past the mixed prompt lengths are in
``test_torch_paged_{reuse,overcommit,pressure}.py``, on this file's
helpers, so that the driver's ``--dist loadfile`` spreads the
reference's compiles.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

STATS = ("prefills", "decode_steps", "tokens", "rejected", "evictions",
         "peak_live_pages", "kv_cache_bytes", "kv_peak_live_bytes")


@pytest.fixture(scope="module")
def model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (4, 11, 7)]
    return jc, tc, jp, tp, prompts


def _serve(model, specs, policy="paper_edge_p8", max_ticks=10_000,
           **scfg):
    """Serve requests ``specs`` [(prompt, max_new)] through both engines
    with the same ServeConfig fields; returns ((jax reqs, stats, engine),
    (port reqs, stats, engine))."""
    jc, tc, jp, tp, _ = model
    out = []
    for eng_cls, cfg_cls, req_cls, cfg, params, kw in (
            (JServingEngine, JServeConfig, JRequest, jc, jp, {}),
            (ServingEngine, ServeConfig, Request, tc, tp,
             {"device": "cpu"})):
        eng = eng_cls(cfg, params, cfg_cls(kv_layout="paged", **scfg),
                      policy=policy, **kw)
        reqs = [req_cls(uid=i, prompt=np.asarray(p), max_new=n)
                for i, (p, n) in enumerate(specs)]
        stats = eng.serve(reqs, max_ticks=max_ticks)
        out.append((reqs, stats, eng))
    return out


def _assert_same(j, t):
    (jr, js, je), (tr, ts, te) = j, t
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert [r.error is None for r in tr] == [r.error is None for r in jr]
    assert all(r.done for r in tr)
    for key in STATS:
        assert ts[key] == js[key], key
    assert te.kv_cache_live_bytes() == je.kv_cache_live_bytes() == 0
    assert te.allocator.live_pages == 0
    te.allocator.assert_consistent()


@pytest.mark.parametrize("kv_format", ["f32", "posit16", "posit8", "posit4"])
def test_mixed_lengths_greedy_token_identical(model, kv_format):
    """Heterogeneous prompt lengths over 2 slots: the third request reuses
    a slot (and pages) the first two freed."""
    prompts = model[4]
    j, t = _serve(model, [(p, 5) for p in prompts], max_batch=2,
                  max_len=32, kv_format=kv_format, page_size=4)
    _assert_same(j, t)
    assert all(len(r.out_tokens) == 5 for r in t[0])
    assert t[1]["peak_live_pages"] > 0
