"""The donated ``generate`` of the port's engine (the reference's
``donate``), on the CPU, where its fixed-buffer step runs eagerly.

* ``donate`` resolves as the reference's does: off on the CPU, off for a
  guard-armed ``ServingEngine`` and its fallback rungs, off under a
  sharded decode attention (where ``donate=True`` raises
  ``NotImplementedError``: its collectives cannot be captured).
* Paper-edge smoke at float32 (``paper_edge_p8``, posit8 KV), ring and
  paged: a donating ``ServingEngine``'s greedy streams equal a
  non-donating one's and the reference's ``ServingEngine``'s.  A
  speculative gamma-2 engine with a donating draft (rollback writing
  the draft's fixed ``pos``) streams what the non-donating one does.
* The fixed buffers: the returned state holds the engine's own ``pos``
  and ``tok``; a rebound ``tok`` and ``pos`` are copied in (the logits
  equal an eager step's on the same values); a recurrent stack's leaves
  alternate between two sets, set n mod 2 after n steps; a state whose
  K/V or recurrent leaves are not the engine's raises ``ValueError``;
  ``stage_specs`` keeps the eager step for the energy accountant.
* Capture hazards: the donated step of every family, traced on the meta
  device, builds no tensor from host data and reads nothing back to the
  host (either would break a CUDA graph capture on the card).

The other families' streams are in ``test_torch_donate_families.py``
(MoE), ``test_torch_donate_recurrent.py`` (SSM, hybrid) and
``test_torch_donate_vlm_audio.py``; capture and replay on the card are
``chip_smoke.py``'s phase 22 and ``test_torch_donate_card.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.overrides import TorchFunctionMode  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import get_policy  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (Request, ServeConfig, ServingEngine,  # noqa: E402
                               SpeculativeEngine)
from repro_torch.serve.distributed import (KVShard,  # noqa: E402
                                           distributed_decode_attention)
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

POLICY = "paper_edge_p8"
MAX_LEN = 64
PAGED = dict(kv_layout="paged", page_size=8)


def donating(eng):
    """``eng`` (a CPU ``ServingEngine``) with its stage engine donating,
    from a fresh donated state: on the CPU ``donate=None`` resolves off."""
    eng.engine.donate = True
    eng.cache = eng.engine.init_decode_state()
    return eng


def serve(eng, prompts, max_new=6):
    reqs = [Request(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    assert all(r.done and r.error is None for r in reqs)
    return [r.out_tokens for r in reqs]


@pytest.fixture(scope="module")
def pair():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in (5, 9, 13)]
    return jc, tc, jp, tp, prompts


def test_donate_resolves_as_the_reference(pair):
    _, tc, _, tp, _ = pair
    pol = get_policy("bf16")
    assert not TransprecisionEngine(tc, pol, 2, 32, device="cpu").donate
    assert TransprecisionEngine(tc, pol, 2, 32, device="cpu",
                                donate=True).donate
    assert not TransprecisionEngine(tc, pol, 2, 32, device="meta").donate
    guarded = donating(ServingEngine(tc, tp, ServeConfig(
        max_batch=2, max_len=32), device="cpu", guard=True))
    assert guarded.engine.donate       # as the test set it ...
    built = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=32),
                          device="cpu", guard=True)
    assert built.engine.donate is False    # ... the engine resolves off
    assert built.guard.rung(1)[0].donate is False
    plug = distributed_decode_attention()
    plug.shard = KVShard()
    assert TransprecisionEngine(tc, pol, 2, 32, attn_impl=plug,
                                device="cpu").donate is False
    with pytest.raises(NotImplementedError, match="collectives"):
        TransprecisionEngine(tc, pol, 2, 32, attn_impl=plug, device="cpu",
                             donate=True)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_streams_equal_eager_and_reference(pair, layout):
    jc, tc, jp, tp, prompts = pair
    kw = PAGED if layout == "paged" else {}
    je = JServingEngine(jc, jp, JServeConfig(
        max_batch=2, max_len=MAX_LEN, kv_format="posit8", **kw),
        policy=POLICY)
    jr = [JRequest(uid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    je.serve(jr)
    scfg = ServeConfig(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
                       **kw)
    eager = serve(ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu"),
                  prompts)
    eng = donating(ServingEngine(tc, tp, scfg, policy=POLICY, device="cpu"))
    fixed = dict(eng.engine._donated.top)
    donated = serve(eng, prompts)
    assert donated == eager == [r.out_tokens for r in jr]
    for name, buf in fixed.items():     # still the engine's own buffers
        assert eng.cache[name] is buf, name
    if layout == "paged":
        eng.allocator.assert_consistent()
        assert eng.allocator.live_pages == 0


def test_speculative_donated_draft(pair):
    _, tc, _, tp, prompts = pair
    scfg = ServeConfig(max_batch=2, max_len=MAX_LEN, kv_format="f32")
    runs = []
    for donate in (False, True):
        eng = SpeculativeEngine(tc, tp, scfg, policy="bf16", gamma=2,
                                device="cpu")
        if donate:
            eng.draft_engine.donate = True
            eng.draft_cache = eng.draft_engine.init_decode_state()
            pos = eng.draft_engine._donated.top["pos"]
        runs.append(serve(eng, prompts, max_new=8))
        rolled = eng.metrics.histogram("spec.rollback_rows").count
    assert runs[0] == runs[1]
    assert rolled > 0
    # a donating draft's rollback writes the new pos into the fixed
    # buffer, which the state it returns holds
    assert eng.draft_cache["pos"] is pos
    assert eng.draft_engine._donated.top["pos"] is pos


def _engine(arch, donate, dtype_name="float32", batch=2):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype_name=dtype_name)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pol = dataclasses.replace(get_policy("bf16"), kv_format="posit8")
    return (TransprecisionEngine(cfg, pol, batch, 32, device="cpu",
                                 donate=donate), params, cfg)


def _prefilled(eng, params, cfg, n=8):
    """A state with one prompt of ``n`` tokens in slot 0."""
    state = eng.init_decode_state()
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, n)))
    return eng.insert(eng.prefill(params, toks), state, 0)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_recurrent_leaves_alternate_between_two_sets(arch):
    eng, params, cfg = _engine(arch, True)
    state = _prefilled(eng, params, cfg)
    sets = eng._donated.sets
    assert len(sets) == 2
    ref, rparams, _ = _engine(arch, False)
    rstate = _prefilled(ref, rparams, cfg)
    for n in range(1, 4):
        state, logits = eng.generate(params, state)
        rstate, rlogits = ref.generate(rparams, rstate)
        assert torch.equal(logits, rlogits)
        for part, blocks in sets[n % 2].items():
            for got, want in zip(state[part], blocks):
                assert all(got[k] is want[k] for k in want), (n, part)
            for got, want in zip(state[part], rstate[part]):
                for k in want:
                    assert torch.equal(got[k], want[k]), (n, part, k)


def test_rebound_tok_and_pos_are_copied_in():
    eng, params, cfg = _engine("paper-edge", True)
    ref, _, _ = _engine("paper-edge", False)
    state, rstate = _prefilled(eng, params, cfg), _prefilled(ref, params, cfg)
    pos_buf, tok_buf = state["pos"], state["tok"]
    for s in (state, rstate):
        s["tok"] = torch.tensor([[7], [3]], dtype=torch.int32)
        s["pos"] = torch.tensor([5, 2], dtype=torch.int32)
    state, logits = eng.generate(params, state)
    rstate, rlogits = ref.generate(params, rstate)
    assert state["pos"] is pos_buf and state["tok"] is tok_buf
    assert torch.equal(logits, rlogits)
    assert state["pos"].tolist() == [6, 3]
    assert torch.equal(state["tok"], rstate["tok"])


def test_foreign_state_raises():
    eng, params, cfg = _engine("paper-edge", True)
    state = eng.init_decode_state()
    other = TransprecisionEngine(cfg, eng.policy, 2, 32,
                                 device="cpu").init_decode_state()
    with pytest.raises(ValueError, match="own buffers"):
        eng.generate(params, other)
    clone = dict(state, blocks=tuple({k: v.clone() for k, v in b.items()}
                                     for b in state["blocks"]))
    with pytest.raises(ValueError, match="own buffers"):
        eng.generate(params, clone)
    bad = dict(state, tok=torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="'tok'"):
        eng.generate(params, bad)
    eng.generate(params, state)             # its own state serves
    # a recurrent stack's state before a step holds the other set
    ssm, sp, _ = _engine("mamba2-2.7b", True)
    st = ssm.init_decode_state()
    before = dict(st)
    st, _ = ssm.generate(sp, st)
    with pytest.raises(ValueError, match="consumed"):
        ssm.generate(sp, before)
    # a new init_decode_state's buffers become the engine's own
    fresh = eng.init_decode_state()
    with pytest.raises(ValueError):
        eng.generate(params, state)
    eng.generate(params, fresh)
    fresh_engine = TransprecisionEngine(cfg, eng.policy, 2, 32,
                                        device="cpu", donate=True)
    with pytest.raises(ValueError, match="init_decode_state"):
        fresh_engine.generate(params, fresh)


def test_stage_specs_keep_the_eager_step():
    eng, params, cfg = _engine("paper-edge", True)
    state = eng.init_decode_state()
    eng.generate(params, state)
    fn, args = eng.stage_specs["generate"]
    assert fn.__wrapped__ is TransprecisionEngine._generate_impl
    assert fn(*args)[1].is_meta             # it runs on the spec
    assert all(t.is_meta for t in args[1]["blocks"][0].values())
    eng.generate(params, state)
    assert eng.graph_stats() == {"eager_ticks": 2, "replays": 0,
                                 "capture_ms": None, "pool_bytes": None,
                                 "launches": None}


def test_a_dropped_engine_frees_its_buffers_without_the_collector():
    """The stage specs hold their engine weakly: a donating engine that
    served every stage is freed, with its fixed buffers, as soon as its
    driver drops it (no reference cycle waits for ``gc``)."""
    import gc
    import weakref
    eng, params, cfg = _engine("paper-edge", True)
    state = _prefilled(eng, params, cfg)
    eng.generate(params, state)
    buf = weakref.ref(eng._donated.top["pos"])
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng, state
        assert ref() is None and buf() is None
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# capture hazards, on the meta device
# --------------------------------------------------------------------------

_SYNCS = {"item", "tolist", "cpu", "numpy", "__bool__", "__int__",
          "__float__", "__index__", "nonzero"}


class _HostData(TorchFunctionMode):
    """Records each call that builds a device tensor from host data or
    reads a device tensor back to the host."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", str(func))
        dev = str(kwargs.get("device", "cpu"))
        on_device = (args and isinstance(args[0], torch.Tensor)
                     and args[0].device.type != "cpu")
        if name == "tensor" and dev != "cpu":
            self.seen.append(name)
        if name == "as_tensor" and dev != "cpu" and not on_device:
            self.seen.append(name)
        if name in _SYNCS and on_device:
            self.seen.append(name)
        return func(*args, **kwargs)


class _HostCopies(TorchDispatchMode):
    """Records each op that copies a host tensor to the device or reads a
    scalar back."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if (any(i.device.type == "cpu" and i.dim() for i in ins)
                and any(o.device.type != "cpu" for o in outs)) \
                or func is torch.ops.aten._local_scalar_dense.default:
            self.seen.append(str(func))
        return out


def test_the_hazard_scan_sees_host_data():
    x = torch.empty(3, device="meta")
    with _HostData() as h, _HostCopies() as c:
        torch.maximum(x, torch.tensor(1e-30, device="meta"))
        torch.as_tensor(5, device="meta")
        torch.arange(3).to("meta")
    assert h.seen == ["tensor", "as_tensor"]
    assert c.seen == ["aten._to_copy.default"]


@pytest.mark.parametrize("arch,layout", [
    ("paper-edge", "ring"), ("paper-edge", "paged"),
    ("granite-moe-1b-a400m", "ring"), ("mamba2-2.7b", "ring"),
    ("recurrentgemma-9b", "ring"), ("qwen2-vl-2b", "paged"),
    ("whisper-large-v3", "ring")])
def test_donated_step_takes_no_host_data(arch, layout):
    """Two donated ticks on meta tensors (the wrappers' plain versions;
    the card's wrappers pass device tensors straight to their kernels)
    under both scans: nothing from or back to the host."""
    cfg = get_config(arch, smoke=True)
    pol = dataclasses.replace(get_policy(POLICY), kv_format="posit8",
                              kv_layout=layout)
    params = lm.hoist_weight_quant(lm.init_params(cfg, None, device="meta"),
                                   pol)
    eng = TransprecisionEngine(cfg, lm.weights_free(pol, cfg.tie_embed), 2,
                               64, device="meta", donate=True)
    state = eng.init_decode_state()
    with _HostData() as h, _HostCopies() as c:
        for _ in range(2):
            state, logits = eng.generate(params, state)
    assert h.seen == [] and c.seen == []
    assert logits.shape == (2, cfg.vocab_pad)
