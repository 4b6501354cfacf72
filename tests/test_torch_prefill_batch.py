"""A prompt's prefill must not depend on the batch it shares: at float32 on
paper-edge smoke, in the ring and the paged layout, 8 prompts prefilled
(i) together at one bucket, (ii) one at a time at that bucket and (iii)
one at a time at each prompt's own bucket give bit-identical last-position
logits and K/V codes and scales over each prompt's true rows, as the JAX
package's prefill does for (i) and (ii).  The head product once ran as one
GEMM over the batch's rows, whose reduction order depended on the row
count.  The verify pass's head runs at max_batch rows; its logits at a
position do not depend on the chunk length."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.serve.engine_api import TransprecisionEngine as JEngine  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import smoke_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

MAX_LEN = 256
LENS = (5, 17, 33, 64, 90, 119, 7, 100)
KV_LEAVES = ("k", "v", "k_scale", "v_scale")


@pytest.fixture(scope="module")
def model():
    jc, tc, jp, tp = smoke_pair("float32")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, n) for n in LENS]
    return jc, tc, jp, tp, prompts


def _padded(prompts, width):
    toks = np.zeros((len(prompts), width), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    return toks, np.array([len(p) for p in prompts], np.int32)


def _rows(prefix, i, n, to_np):
    """(logits row i, the K/V leaves' first n rows of batch row i)."""
    blk = prefix["cache"]["blocks"][0]
    return (to_np(prefix["logits"][i]),
            [to_np(blk[name][:, i, :n]) for name in KV_LEAVES])


def _assert_same(a, b):
    assert np.array_equal(a[0], b[0]), np.abs(a[0] - b[0]).max()
    for x, y in zip(a[1], b[1]):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_port_prefill_rows_do_not_depend_on_the_batch(model, layout):
    _, tc, _, tp, prompts = model
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=8, max_len=MAX_LEN,
                                            kv_format="posit8",
                                            kv_layout=layout),
                        policy="paper_edge_p8", device="cpu")
    api = eng.engine

    def run(ps, width):
        toks, lens = _padded(ps, width)
        return api.prefill(eng.params, torch.from_numpy(toks),
                           torch.from_numpy(lens))

    to_np = lambda t: t.numpy()                          # noqa: E731
    together = run(prompts, MAX_LEN)                             # (i)
    for i, p in enumerate(prompts):
        n = len(p)
        alone = _rows(run([p], MAX_LEN), 0, n, to_np)            # (ii)
        own = _rows(run([p], api.bucket_for(n)), 0, n, to_np)    # (iii)
        _assert_same(_rows(together, i, n, to_np), alone)
        _assert_same(own, alone)


@pytest.mark.parametrize("layout", ["ring", "paged"])
def test_reference_prefill_rows_do_not_depend_on_the_batch(model, layout):
    jc, _, jp, _, prompts = model
    policy = dataclasses.replace(j_get_policy("paper_edge_p8"),
                                 kv_format="posit8", kv_layout=layout)
    api = JEngine(jc, policy, 8, MAX_LEN)

    def run(ps):
        toks, lens = _padded(ps, MAX_LEN)
        return api.prefill(jp, jnp.asarray(toks, jnp.int32), lens)

    together = run(prompts)
    for i, p in enumerate(prompts):
        _assert_same(_rows(together, i, len(p), np.asarray),
                     _rows(run([p]), 0, len(p), np.asarray))


def test_verify_logits_do_not_depend_on_the_chunk_length(model):
    _, tc, _, tp, prompts = model
    eng = ServingEngine(tc, tp, ServeConfig(max_batch=8, max_len=MAX_LEN,
                                            kv_format="posit8"),
                        policy="paper_edge_p8", device="cpu")
    api, state = eng.engine, eng.cache
    for slot, p in enumerate(prompts):
        toks, lens = _padded([p], api.bucket_for(len(p)))
        state = api.insert(api.prefill(eng.params, torch.from_numpy(toks),
                                       torch.from_numpy(lens)), state, slot)
    chunk = torch.from_numpy(np.random.default_rng(1).integers(
        0, tc.vocab, (8, 5)))

    def verify(t):
        s = {**state, "pos": state["pos"].clone(),
             "blocks": tuple({k: v.clone() for k, v in b.items()}
                             for b in state["blocks"])}
        return api.verify(eng.params, s, chunk[:, :t])[1]

    full = verify(5)
    for t in (1, 2, 3):
        assert torch.equal(verify(t), full[:, :t]), t
