"""Paged-layout ServingEngine of the PyTorch port vs the JAX package's, at
float32 on paper-edge smoke under the paper_edge_p8 weight policy.

Greedy streams must be token-identical, and the paging bookkeeping equal
(prefills, decode steps, evictions, peak live pages, reserved / live /
peak-live KV bytes), across mixed prompt lengths, slot reuse after EOS
that frees pages, admission without head-of-line blocking, transient page
pressure, ``max_new=0`` and ``page_overcommit`` eviction with
recompute-on-readmit.  On ``benchmarks/bench_paged_kv.py``'s shape the
peak live KV bytes come to 0.1719x the ring's for every format, as in the
reference's baseline.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402

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
