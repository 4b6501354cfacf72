"""Paged-layout ServingEngine of the PyTorch port vs the JAX package's, at
float32 on paper-edge smoke under the paper_edge_p8 weight policy, split
from ``tests/test_torch_paged_engine.py`` (its helpers and fixture) so
that the driver's ``--dist loadfile`` spreads the reference's compiles:
admission under transient page pressure; on
``benchmarks/bench_paged_kv.py``'s shape the peak live KV bytes at
0.1719x the ring's for every format, as in the reference's baseline; the
engine's stages scattering a prefix into pages."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve.engine import (  # noqa: E402
    Request, ServeConfig, ServingEngine)
from test_torch_paged_engine import (  # noqa: E402,F401
    _assert_same, _serve, model)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_transient_page_pressure_admits_later_entries(model):
    """With the pool too tight for the queue head beside a small request,
    the small ones go first and the head lands once pages free up."""
    tc = model[1]
    rng = np.random.default_rng(2)
    specs = [(rng.integers(0, tc.vocab, 3), 3),
             (rng.integers(0, tc.vocab, 11), 3),
             (rng.integers(0, tc.vocab, 3), 3)]
    j, t = _serve(model, specs, max_batch=2, max_len=16, kv_format="posit8",
                  page_size=4, num_pages=6)
    _assert_same(j, t)
    assert t[1]["rejected"] == 0
    assert all(len(r.out_tokens) == 3 for r in t[0])


@pytest.mark.parametrize("kv_format", ["bf16", "posit16", "posit8", "posit4"])
def test_bench_paged_kv_bytes_match_reference(model, kv_format):
    """``bench_paged_kv.py``'s shape and schedule (one warm-up request,
    stats reset, 6 requests): reserved, live and peak-live bytes equal the
    reference's, and peak live / ring reserved = 0.1719."""
    jc, tc, jp, tp, _ = model
    max_batch, max_len, page_size, max_new = 4, 128, 8, 8
    got = []
    for eng_cls, cfg_cls, req_cls, cfg, params, kw in (
            (JServingEngine, JServeConfig, JRequest, jc, jp, {}),
            (ServingEngine, ServeConfig, Request, tc, tp,
             {"device": "cpu"})):
        def engine(layout):
            return eng_cls(cfg, params, cfg_cls(
                max_batch=max_batch, max_len=max_len, kv_format=kv_format,
                kv_layout=layout, page_size=page_size), **kw)
        rng = np.random.default_rng(0)
        reqs = [req_cls(uid=i, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(4, 17))), max_new=max_new)
            for i in range(6)]
        eng = engine("paged")
        eng.serve([req_cls(uid=99, prompt=reqs[0].prompt.copy(),
                           max_new=2)])
        eng.stats.update(prefills=0, decode_steps=0, tokens=0, rejected=0,
                         peak_live_pages=0)
        eng.serve(reqs)
        got.append((engine("ring").kv_cache_bytes(), eng.kv_cache_bytes(),
                    eng.kv_cache_live_bytes(),
                    eng.kv_cache_peak_live_bytes()))
    assert got[1] == got[0]
    ring, _, live, peak = got[1]
    assert live == 0
    assert round(peak / ring, 4) == 0.1719


def test_engine_stages_scatter_prefix_into_pages(model):
    """Driving the stages by hand: the prefix comes from a ring prefill at
    bucket width and ``insert`` scatters its rows to the given pool rows
    (padding rows to trash row 0); ``generate`` reads them back."""
    _, tc, _, tp, prompts = model
    import torch
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=32,
                                            kv_format="posit8",
                                            kv_layout="paged", page_size=4,
                                            num_pages=9),
                        policy="paper_edge_p8", device="cpu")
    api = eng.engine
    assert api._prefill_policy.kv_layout == "ring"
    p = prompts[1]                                   # 11 tokens, bucket 16
    padded = np.zeros((1, 16), np.int64)
    padded[0, :len(p)] = p
    prefix = api.prefill(eng.params, torch.from_numpy(padded),
                         torch.tensor([len(p)]))
    pages = [7, 2, 5]
    dst = np.zeros(16, np.int64)
    t = np.arange(len(p))
    dst[:len(p)] = np.asarray(pages)[t // 4] * 4 + t % 4
    state = api.insert(prefix, eng.cache, slot=1, dst_rows=dst)
    blk, pblk = state["blocks"][0], prefix["cache"]["blocks"][0]
    for name in ("k", "v", "k_scale", "v_scale"):
        assert torch.equal(blk[name][:, dst[:len(p)]],
                           pblk[name][:, 0, :len(p)])
    assert int(state["pos"][1]) == len(p)
    state["page_table"][1, :3] = torch.tensor(pages)
    state, logits = api.generate(eng.params, state)
    assert int(state["pos"][1]) == len(p) + 1
    assert tuple(logits.shape) == (2, tc.vocab_pad)
