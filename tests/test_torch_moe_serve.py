"""Serving the MoE family (granite-moe-1b-a400m smoke, and phi3.5-moe
smoke for the streams) through the port against the reference, on the
reference's weights through ``convert.params_from_numpy``.

* ``prefill`` / ``decode_step`` logits and K/V codes at float32 by the
  dense rules of ``tests/test_torch_serve.py`` (logits rtol 1e-4, atol
  1e-5, posit16 decode logits atol 1e-4; posit8 codes and every scale
  bit-exact, posit16 codes within one step on < 1 %): ring posit8,
  posit16 and f32, paged posit8.  Each case prints the smallest gap
  between neighbouring router gates over the top k + 1 of the rows it
  routes (a gap near f32 noise could route the two packages apart).
* ``ServingEngine`` greedy streams token-identical at float32 in both
  layouts, with prompts of different lengths over 2 slots, so slots free
  and refill mid-run and idle slots take part in every decode step's
  routing; the engine stats equal too.
* bf16 prefill and decode logits within 0.1 of their largest magnitude
  of the reference's bf16 (the dense bound, 0.1 on logits of ~1).
* The ``Orchestrator`` over one slot streams what ``serve()`` streams
  (one slot: the batch a request decodes in does not depend on arrival
  times); over two slots every stream finishes error-free.
* The numeric guard's re-decode through MoE weights hoisted per rung:
  poisoned streams equal the reference's.
* The refusals (``lengths=`` on prefill, ``true_len``, ``verify_step``,
  ``SpeculativeEngine``) raise the reference's exception types.

The engines' streams (ring, paged, phi3.5-moe), the orchestrator, the
guard's re-decode and the refusals are in
``test_torch_moe_streams_{ring,paged,phi}.py``, on this file's helpers,
so that the driver's ``--dist loadfile`` spreads the reference's
compiles.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.transprecision import get_policy as t_get_policy  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from repro_torch.serve import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import (_check_cache_f32, _f32, _snapshot,  # noqa: E402
                              jax_params_to_numpy)
from _torch_threads import torch_threads  # noqa: E402,F401

ARCH = "granite-moe-1b-a400m"
POLICY = "paper_edge_p8"
MAX_LEN = 64
LAYOUTS = {"ring": {}, "paged": dict(kv_layout="paged", page_size=8)}
STATS = ("prefills", "decode_steps", "tokens", "rejected", "evictions",
         "peak_live_pages", "kv_cache_bytes", "kv_peak_live_bytes")


def moe_pair(dtype_name, arch=ARCH):
    """(jax cfg, torch cfg, jax params, torch params) at ``dtype_name``."""
    jc = dataclasses.replace(j_get_config(arch, smoke=True),
                             dtype_name=dtype_name)
    tc = dataclasses.replace(t_get_config(arch, smoke=True),
                             dtype_name=dtype_name)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def pair():
    return moe_pair("float32")


def _prompts(vocab, lens=(5, 12, 9, 3, 14)):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)) for n in lens]


# ---- the serving model: prefill and decode_step -------------------------

_J_PREFILL = jax.jit(jsm.prefill, static_argnums=(2, 3, 4))
_J_DECODE = jax.jit(jsm.decode_step, static_argnums=(3, 4))


def _router_gap(tc, tp, x_rows):
    """Smallest gap between neighbouring sorted gates over the top k + 1,
    over every layer's router on ``x_rows`` (rows of the residual stream
    are not exposed: this is the gap on the given rows' embeddings,
    through each layer's router)."""
    gaps = []
    for i in range(tc.n_layers):
        r = tp["blocks"][0]["moe"]["router"][i].double()
        g = torch.softmax(x_rows.double() @ r, dim=-1)
        top = torch.sort(g, dim=-1, descending=True).values[
            :, :tc.moe_topk + 1]
        gaps.append(float((top[:, :-1] - top[:, 1:]).min()))
    return min(gaps)


CASES = {"ring_posit8": ("posit8", {}), "ring_posit16": ("posit16", {}),
         "ring_f32": ("f32", {}),
         "paged_posit8": ("posit8", dict(kv_layout="paged",
                                         kv_page_size=8))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_decode_f32_matches_reference(pair, case):
    jc, tc, jp, tp = pair
    kv_format, layout = CASES[case]
    jpol = dataclasses.replace(j_get_policy(POLICY), kv_format=kv_format,
                               **layout)
    tpol = dataclasses.replace(t_get_policy(POLICY), kv_format=kv_format,
                               **layout)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab, (2, 12))
    gap = _router_gap(tc, tp, tp["embed"][torch.from_numpy(toks)].reshape(
        -1, tc.d_model))
    print(f"{case}: smallest top-k gap on the embeddings {gap:.3e}")
    jl, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jc, 32, jpol)
    tl, tcache = tsm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32,
                             tpol)
    steps = [(jl, tl, jcache, _snapshot(tcache))]
    for _ in range(2):
        tok = rng.integers(0, tc.vocab, (2, 1))
        jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(tok, jnp.int32), jc,
                               jpol)
        tl, tcache = tsm.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                     tpol)
        steps.append((jl, tl, jcache, _snapshot(tcache)))
    for step, (jl, tl, jcache, tcache) in enumerate(steps):
        atol = 1e-4 if step and kv_format == "posit16" else 1e-5
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=atol)
        _check_cache_f32(jcache, tcache, kv_format)
        np.testing.assert_array_equal(np.asarray(tcache["pos"]),
                                      np.asarray(jcache["pos"]))


def test_hoisted_moe_weights_equal_per_call(pair):
    """``hoist_weight_quant`` quantizes each layer's whole (E, ...) expert
    slice as the per-call hook does, and leaves the router as it is."""
    _, tc, _, tp = pair
    pol = dataclasses.replace(t_get_policy(POLICY), kv_format="posit8")
    hp = tlm.hoist_weight_quant(tp, pol)
    free = tlm.weights_free(pol, tc.tie_embed)
    assert hp["embed"] is tp["embed"]       # tied: the head reads it raw
    moe, hmoe = tp["blocks"][0]["moe"], hp["blocks"][0]["moe"]
    assert hmoe["router"] is moe["router"]
    for name in ("wi", "wo"):
        assert not torch.equal(hmoe[name], moe[name])
        assert torch.equal(hmoe[name][1],
                           pol.quantize_weight(moe[name][1], "mlp_weights"))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tc.vocab, (1, 12)))
    a, ca = tsm.prefill(tp, {"tokens": toks}, tc, 32, pol)
    b, cb = tsm.prefill(hp, {"tokens": toks}, tc, 32, free)
    assert torch.equal(a, b)
    a, _ = tsm.decode_step(tp, ca, toks[:, :1], tc, pol)
    b, _ = tsm.decode_step(hp, cb, toks[:, :1], tc, free)
    assert torch.equal(a, b)


def test_embed_rows_equals_quantized_table_lookup(pair):
    """The tied lookup encodes only the rows it reads, with the table's
    per-column scale: the bits of quantizing the whole table and then
    looking up."""
    _, tc, _, tp = pair
    pol = t_get_policy(POLICY)
    table = tp["embed"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (3, 7)))
    want = pol.quantize_weight(table, "embed_weights")[toks]
    assert torch.equal(tlm.embed_rows(table, toks, pol), want)
    free = tlm.weights_free(pol)            # no embed role: the raw rows
    assert torch.equal(tlm.embed_rows(table, toks, free), table[toks])


# ---- the engine ---------------------------------------------------------

def _serve_both(pair, prompts, scfg, policy=POLICY, faults=None, **kw):
    """Serve ``prompts`` (max_new 6 + i) through the reference's and the
    port's engines; returns [(engine, requests, stats)]."""
    jc, tc, jp, tp = pair
    out = []
    for eng_cls, cfg_cls, req_cls, cfg, params, extra in (
            (JServingEngine, JServeConfig, JRequest, jc, jp, {}),
            (ServingEngine, ServeConfig, Request, tc, tp,
             {"device": "cpu"})):
        if faults is not None:
            extra = dict(extra, faults=faults[len(out)])
        eng = eng_cls(cfg, params, cfg_cls(**scfg), policy=policy, **extra,
                      **kw)
        reqs = [req_cls(uid=i, prompt=np.asarray(p), max_new=6 + i)
                for i, p in enumerate(prompts)]
        stats = eng.serve(reqs)
        out.append((eng, reqs, stats))
    return out


def check_streams(arch, layout, pair):
    """The engines' greedy streams, stats and page accounting at float32
    (5 prompts of 3-14 tokens, max_new 6 + i, over 2 slots)."""
    p = pair if arch == ARCH else moe_pair("float32", arch)
    prompts = _prompts(p[1].vocab)
    (je, jr, js), (te, tr, ts) = _serve_both(
        p, prompts, dict(max_batch=2, max_len=MAX_LEN, kv_format="posit8",
                         **LAYOUTS[layout]))
    assert [r.out_tokens for r in tr] == [r.out_tokens for r in jr]
    assert all(r.done and r.error is None for r in tr)
    assert [len(r.out_tokens) for r in tr] == [6 + i for i in range(5)]
    for key in STATS:
        assert ts[key] == js[key], key
    assert ts["prefills"] == 5          # one exact-length prefill each
    if te.paged:
        assert te.allocator.live_pages == 0
        te.allocator.assert_consistent()


def test_engine_is_not_bucketed(pair):
    _, tc, _, tp = pair
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=2, max_len=MAX_LEN),
                        policy=POLICY, device="cpu")
    api = eng.engine
    assert not api.bucketed and api.bucket_for(7) == 7
    prefix = api.prefill(eng.params, torch.zeros((1, 7), dtype=torch.int64))
    assert prefix["cache"]["blocks"][0]["k"].shape[2] == MAX_LEN
    assert prefix["length"].tolist() == [7]
    # a non-bucketed engine admits one prompt per prefill
    ok = eng.add_requests([Request(uid=i, prompt=np.arange(3 + i),
                                   max_new=4) for i in range(2)])
    assert ok == [True, False]
    assert eng.stats["prefills"] == 1


# ---- refusals -----------------------------------------------------------


# ---- the serve launcher -------------------------------------------------
