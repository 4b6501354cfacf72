"""The donated speculative round of the port's engine (``verify``,
``rollback_ring``, ``rollback_paged`` over the engine's fixed buffers, as
the reference jits them with a donated state), on the CPU, where the
fixed-buffer stages run eagerly.

* Paper-edge smoke at float32 (BF16 target, posit8 KV) at
  ``benchmarks/bench_speculative.py``'s shape, ring and paged, gamma 2
  and 4: a speculative engine whose target and draft donate streams what
  a non-donating one does and what the reference's ``SpeculativeEngine``
  does; every verify's logits and every cache leaf after each verify and
  each rollback (target and draft) equal the eager stages' bit for bit;
  the returned states hold the engines' own ``pos``, and the chunk and
  rollback inputs land in one fixed buffer per stage and shape.
* A state whose K/V leaves are not the engine's own raises
  ``ValueError`` in each stage; ``stage_specs`` keep the eager stage
  functions for the energy accountant.
* Capture hazards: ``verify``, ``rollback_ring`` and ``rollback_paged``
  on the fixed buffers, traced on the meta device, build no tensor from
  host data and read nothing back to the host (the scan of
  ``test_torch_donate.py``), and write no Python number through an index
  (on the card a host copy).

Capture and replay on the card are ``chip_smoke.py``'s phase 22b and
``test_torch_donate_card.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import Request, ServeConfig, SpeculativeEngine  # noqa: E402
from repro_torch.serve.engine_api import (TransprecisionEngine,  # noqa: E402
                                          rollback_paged_cache,
                                          rollback_ring_cache)
from test_torch_donate import _HostCopies, _HostData  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

# bench_speculative.py's shape
BENCH = dict(max_batch=2, max_len=64, kv_format="posit8", page_size=8)
COUNTS = ("decode_steps", "spec_rounds", "draft_steps", "drafts_proposed",
          "drafts_accepted", "tokens", "prefills")


@functools.lru_cache(maxsize=None)
def _pair():
    return smoke_pair("float32")


def _requests(cls, vocab):
    rng = np.random.default_rng(0)
    return [cls(uid=i, prompt=rng.integers(0, vocab, int(rng.integers(4, 13))),
                max_new=10) for i in range(4)]


@functools.lru_cache(maxsize=None)
def _reference_streams(layout, gamma):
    jc, tc, jp, _ = _pair()
    eng = JSpeculative(jc, jp, JServeConfig(**BENCH, kv_layout=layout),
                       gamma=gamma)
    reqs = _requests(JRequest, tc.vocab)
    eng.serve(reqs)
    return [list(r.out_tokens) for r in reqs]


def _snapshot(state):
    return [t.clone() for blk in state["blocks"] for _, t in
            sorted(blk.items())] + [state["pos"].clone()]


def _logged(eng, log, donated):
    """Wrap the target's verify and both engines' rollbacks: record each
    call's logits and a copy of every cache leaf after it; on a donating
    engine also that the returned state holds the fixed ``pos`` and that
    the stage's inputs sit in the same fixed buffer as at its first
    call."""
    bufs = {}

    def check(engine, state):
        if not donated:
            return
        own = engine._donated
        assert state["pos"] is own.top["pos"]
        for key, buf in own.bufs.items():
            assert bufs.setdefault((id(engine), key), buf) is buf, key

    def wrap(engine, name):
        real = getattr(engine, name)

        def call(*args):
            out = real(*args)
            state, logits = out if name == "verify" else (out, None)
            check(engine, state)
            log.append((engine.stage_prefix + name, logits,
                        _snapshot(state)))
            return out
        setattr(engine, name, call)

    for name in ("verify", "rollback_ring", "rollback_paged"):
        wrap(eng.engine, name)
    wrap(eng.draft_engine, "rollback_ring")


@pytest.mark.parametrize("gamma", [2, 4])
@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_donated_round_equals_eager_and_reference(layout, gamma):
    _, tc, _, tp = _pair()
    runs = []
    for donate in (False, True):
        eng = SpeculativeEngine(tc, tp, ServeConfig(**BENCH,
                                                    kv_layout=layout),
                                gamma=gamma, device="cpu")
        assert not eng.engine.donate and not eng.draft_engine.donate
        if donate:
            eng.engine.donate = eng.draft_engine.donate = True
            eng.cache = eng.engine.init_decode_state()
            eng.draft_cache = eng.draft_engine.init_decode_state()
        log = []
        _logged(eng, log, donate)
        reqs = _requests(Request, tc.vocab)
        stats = eng.serve(reqs)
        assert all(r.done and len(r.out_tokens) == 10 for r in reqs)
        if layout == "paged":
            assert eng.allocator.live_pages == 0
            eng.allocator.assert_consistent()
        runs.append(([r.out_tokens for r in reqs],
                     {k: stats[k] for k in COUNTS}, log, eng))
    (e_out, e_stats, e_log, _), (d_out, d_stats, d_log, eng) = runs
    assert d_out == e_out == _reference_streams(layout, gamma)
    assert d_stats == e_stats
    assert [s for s, _, _ in d_log] == [s for s, _, _ in e_log]
    assert {s for s, _, _ in d_log} == {
        "verify", "draft.rollback_ring",
        "rollback_paged" if layout == "paged" else "rollback_ring"}
    for (stage, dl, dleaves), (_, el, eleaves) in zip(d_log, e_log):
        if dl is not None:
            assert torch.equal(dl, el), stage
        assert all(torch.equal(a, b) for a, b in zip(dleaves, eleaves)), \
            stage
    g = eng.engine.graph_stats()
    rounds = d_stats["spec_rounds"]
    assert sum(r["eager_calls"] for r in g["verify"].values()) == rounds
    assert gamma + 1 in g["verify"]
    assert all(r["replays"] == 0 and r["capture_ms"] is None
               for stage in ("verify", "rollback_" + layout)
               for r in g[stage].values())
    assert set(eng.draft_engine.graph_stats()["rollback_ring"]) <= set(
        range(1, gamma + 1))


def _engine(layout, donate, device="cpu"):
    cfg = get_config("paper-edge", smoke=True)
    pol = dataclasses.replace(get_policy("bf16"), kv_format="posit8",
                              kv_layout=layout, kv_page_size=8)
    return TransprecisionEngine(cfg, pol, 2, 32, num_pages=9, device=device,
                                donate=donate), cfg


def _rollback(eng, state, layout, t=3):
    if layout == "paged":
        return eng.rollback_paged(state, np.array([4, 0]),
                                  np.array([5, 6, 7, 0, 0, 0]))
    return eng.rollback_ring(state, np.array([4, 0]), np.array([7, t]),
                             np.array([5, t]), t)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_foreign_state_raises_and_specs_keep_the_eager_stages(layout):
    eng, cfg = _engine(layout, True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    state = eng.init_decode_state()
    other = _engine(layout, False)[0].init_decode_state()
    chunk = np.zeros((2, 3), np.int64)
    with pytest.raises(ValueError, match="verify: .*own buffers"):
        eng.verify(params, other, chunk)
    with pytest.raises(ValueError, match="rollback: .*own buffers"):
        _rollback(eng, other, layout)
    state, logits = eng.verify(params, state, chunk)
    assert logits.shape == (2, 3, cfg.vocab_pad)
    assert state["pos"].tolist() == [3, 3]
    state = _rollback(eng, state, layout)
    assert state["pos"].tolist() == [4, 0]
    fn, args = eng.stage_specs["verify"]
    assert fn.__wrapped__ is TransprecisionEngine._verify_impl
    assert fn(*args)[1].is_meta             # it runs on the spec
    fn, _ = eng.stage_specs["rollback"]
    assert fn is (rollback_paged_cache if layout == "paged"
                  else rollback_ring_cache)
    # the fixed chunk buffer of a T refuses another batch
    with pytest.raises(ValueError, match="chunk"):
        eng.verify(params, state, np.zeros((1, 3), np.int64))


class _HostScalars(_HostData):
    """``_HostData``, and an indexed write of a Python number into a
    device tensor (``t[idx] = 0``): on the card the number becomes a host
    tensor copied to the device, which a capture refuses; the meta device
    makes it in place, so the call itself is what is flagged."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if (getattr(func, "__name__", "") == "__setitem__"
                and args[0].device.type != "cpu"
                and isinstance(args[2], (int, float, bool))):
            self.seen.append("__setitem__ of a number")
        return super().__torch_function__(func, types, args, kwargs)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_donated_round_takes_no_host_data(layout):
    """Two donated verify and rollback calls on meta tensors (the
    wrappers' plain versions; the card's wrappers pass device tensors
    straight to their kernels), their inputs already on the device as a
    driver's copy-in leaves them, under both scans: nothing from or back
    to the host."""
    cfg = get_config("paper-edge", smoke=True)
    pol = dataclasses.replace(get_policy("paper_edge_p8"),
                              kv_format="posit8", kv_layout=layout,
                              kv_page_size=8)
    params = lm.hoist_weight_quant(lm.init_params(cfg, None, device="meta"),
                                   pol)
    eng = TransprecisionEngine(cfg, lm.weights_free(pol, cfg.tie_embed), 2,
                               64, num_pages=17, device="meta", donate=True)
    state = eng.init_decode_state()

    def meta(n, dtype=torch.int64):
        return torch.zeros(n, dtype=dtype, device="meta")

    with _HostScalars() as h, _HostCopies() as c:
        for _ in range(2):
            state, logits = eng.verify(params, state, meta((2, 5)))
            if layout == "paged":
                state = eng.rollback_paged(state, meta(2), meta(10))
            else:
                state = eng.rollback_ring(state, meta(2), meta(2), meta(2),
                                          5)
    assert h.seen == [] and c.seen == []
    assert logits.shape == (2, 5, cfg.vocab_pad)
    assert state["pos"] is eng._donated.top["pos"]
