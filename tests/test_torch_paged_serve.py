"""Paged serving model of the PyTorch port vs the JAX package on paper-edge
smoke, float32, ``paper_edge_p8`` weights, page size 4.

Bucketed paged ``prefill`` (full pool, identity table) plus two
``decode_step`` calls: logits within rtol 1e-4, atol 1e-5 (matmul summation
order differs between XLA and torch); every pool row outside trash page 0
bit-exact for posit8/posit4 codes and every scale, within 1e-5 for f32.
posit16 codes get ``tests/test_torch_serve.py``'s allowance (one code step
on under 1 % of values; decode logits at atol 1e-4).  Within the port,
paged greedy decode equals ring greedy decode token for token on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro_torch.core.transprecision import get_policy as t_get_policy  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from test_torch_serve import (_J_DECODE, _J_PREFILL, _codes, _f32,  # noqa: E402
                              smoke_pair)
from _torch_threads import torch_threads  # noqa: E402,F401

PS, MAX_LEN = 4, 32


def _policies(kv_format, layout="paged"):
    kw = dict(kv_format=kv_format, kv_layout=layout, kv_page_size=PS)
    return (dataclasses.replace(j_get_policy("paper_edge_p8"), **kw),
            dataclasses.replace(t_get_policy("paper_edge_p8"), **kw))


def _snapshot(cache):
    return {"pos": cache["pos"].clone(),
            "page_table": cache["page_table"].clone(),
            "blocks": tuple({k: v.clone() for k, v in b.items()}
                            for b in cache["blocks"])}


@pytest.fixture(scope="module")
def pair():
    return smoke_pair("float32")


def _run_both(pair, kv_format, steps=2):
    jc, tc, jp, tp = pair
    jpol, tpol = _policies(kv_format)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tc.vocab, (2, 16))
    true_len = np.array([11, 16], np.int32)
    jl, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jc, MAX_LEN, jpol, true_len=jnp.asarray(true_len))
    tl, tcache = tsm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc,
                             MAX_LEN, tpol,
                             true_len=torch.from_numpy(true_len))
    out = [(jl, tl, jcache, _snapshot(tcache))]
    for _ in range(steps):
        tok = rng.integers(0, tc.vocab, (2, 1))
        jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(tok, jnp.int32), jc,
                               jpol)
        tl, tcache = tsm.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                     tpol)
        out.append((jl, tl, jcache, _snapshot(tcache)))
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    return out


def _check_pool(jcache, tcache, kv_format):
    np.testing.assert_array_equal(tcache["page_table"].numpy(),
                                  np.asarray(jcache["page_table"]))
    jb, tb = jcache["blocks"][0], tcache["blocks"][0]
    assert set(jb) == set(tb)
    for name in jb:
        j, t = jb[name], tb[name]
        assert tuple(t.shape) == tuple(j.shape), name
        j, t = np.asarray(j)[:, PS:], t[:, PS:]        # past trash page 0
        if name.endswith("_scale"):
            np.testing.assert_array_equal(_f32(t), _f32(j))
        elif kv_format in ("posit8", "posit4"):
            np.testing.assert_array_equal(_codes(t), _codes(j))
        elif kv_format == "posit16":
            diff = np.abs(_codes(t) - _codes(j))
            assert diff.max() <= 1 and diff.mean() < 0.01, name
        else:
            np.testing.assert_allclose(_f32(t), _f32(j), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("kv_format", ["f32", "posit8", "posit4", "posit16"])
def test_paged_prefill_decode_f32_matches_reference(pair, kv_format):
    for step, (jl, tl, jcache, tcache) in enumerate(_run_both(pair,
                                                              kv_format)):
        atol = 1e-4 if step and kv_format == "posit16" else 1e-5
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=1e-4, atol=atol)
        _check_pool(jcache, tcache, kv_format)


def _greedy(tc, tp, prompt, policy, max_new=5):
    logits, cache = tsm.prefill(tp, {"tokens": torch.from_numpy(prompt)[None]},
                                tc, MAX_LEN, policy)
    out = [int(logits[0, :tc.vocab].argmax())]
    for _ in range(max_new - 1):
        logits, cache = tsm.decode_step(tp, cache, torch.tensor([[out[-1]]]),
                                        tc, policy)
        out.append(int(logits[0, :tc.vocab].argmax()))
    return out


@pytest.mark.parametrize("kv_format", ["f32", "posit16", "posit8", "posit4"])
def test_paged_greedy_equals_ring_greedy(pair, kv_format):
    _, tc, _, tp = pair
    prompt = np.random.default_rng(1).integers(0, tc.vocab, 11)
    ring = _greedy(tc, tp, prompt, _policies(kv_format, "ring")[1])
    paged = _greedy(tc, tp, prompt, _policies(kv_format)[1])
    assert ring == paged


def test_paged_cache_layout_and_scalar_pos(pair):
    """Full pool: 1 trash page + B * Pmax pages with the identity table;
    an explicit pool size gives a zero table; a scalar pos is broadcast to
    every slot; prompts longer than max_len are refused."""
    _, tc, _, tp = pair
    _, pol = _policies("posit8")
    c = tsm.init_cache(tc, 2, 30, policy=pol, device="cpu")
    pmax = 8                                           # ceil(30 / 4)
    assert tuple(c["blocks"][0]["k"].shape) == (2, (1 + 2 * pmax) * PS, 2,
                                                16)
    assert tuple(c["blocks"][0]["k_scale"].shape) == (2, (1 + 2 * pmax) * PS,
                                                      2)
    assert c["page_table"].dtype == torch.int32
    assert c["page_table"][1].tolist() == list(range(1 + pmax, 1 + 2 * pmax))
    assert tuple(c["pos"].shape) == (2,)
    c5 = tsm.init_cache(tc, 2, 30, policy=pol, num_pages=5, device="cpu")
    assert c5["blocks"][0]["v"].shape[1] == 5 * PS
    assert int(c5["page_table"].abs().sum()) == 0
    c["pos"] = torch.tensor(3, dtype=torch.int32)
    tok = torch.tensor([[5], [7]])
    a, ca = tsm.decode_step(tp, c, tok, tc, pol)
    b, cb = tsm.decode_step(tp, tsm.init_cache(tc, 2, 30, policy=pol,
                                               device="cpu") | {
        "pos": torch.tensor([3, 3], dtype=torch.int32)}, tok, tc, pol)
    assert torch.equal(a, b) and int(ca["pos"]) == 4
    with pytest.raises(ValueError, match="exceeds max_len"):
        tsm.prefill(tp, {"tokens": torch.zeros((1, 40), dtype=torch.int64)},
                    tc, 30, pol)
