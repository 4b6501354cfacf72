"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the same weights and tokens, made from numpy
seeds.

* Routing (``_route``'s ``idx_k``, ``pos``, ``keep`` and ``cap``) equal
  exactly; each case prints its smallest gap between two neighbouring
  gates in the top-k + 1 (where a near tie could order the experts
  differently).
* At float32 the output within atol 1e-5 (rtol 1e-5) and the aux loss
  within 1e-6, for both dispatch paths, top-k 1, 2 and 4 and capacity
  factors 1.0, 1.25, 2.0 and 0 (dropless): the expert products' summation
  order differs between XLA and torch.
* The port's einsum and scatter paths agree (atol 1e-5).
* A row of equal gates (a zero token) picks experts 0..k-1.
* At bf16 the output within 0.1 absolute on values of order 1 (the dense
  serving model's bf16 logit bound, ``tests/test_torch_serve.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

D, FF, E = 32, 24, 8
B, S = 2, 12


def _weights(seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"router": rng.normal(0, D ** -0.5, (D, E)).astype(np.float32),
            "wi": rng.normal(0, D ** -0.5, (E, D, 2 * FF)).astype(dtype),
            "wo": rng.normal(0, FF ** -0.5, (E, FF, D)).astype(dtype)}


def _tokens(seed=1, b=B, s=S):
    return np.random.default_rng(seed).normal(0, 1, (b, s, D)).astype(
        np.float32)


def _jax(w, dtype=jnp.float32):
    return {k: jnp.asarray(v, jnp.float32 if k == "router" else dtype)
            for k, v in w.items()}


def _torch(w, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(torch.float32 if k == "router"
                                      else dtype) for k, v in w.items()}


def _gap(w, x, top_k):
    """Smallest gap between neighbouring sorted gates over the top k + 1
    of each token (the reference's router product in numpy f64)."""
    logits = x.reshape(-1, D).astype(np.float64) @ w["router"]
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g /= g.sum(-1, keepdims=True)
    top = -np.sort(-g, axis=-1)[:, :top_k + 1]
    return float(np.diff(-top, axis=-1).min())


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 0.0])
@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_route_equals_reference(top_k, cf):
    w, x = _weights(), _tokens()
    j = jmoe._route(_jax(w), jnp.asarray(x.reshape(-1, D)), top_k, cf)
    t = tmoe._route(_torch(w), torch.from_numpy(x.reshape(-1, D)), top_k,
                    cf)
    print(f"top_k {top_k} cf {cf}: smallest top-k gap "
          f"{_gap(w, x, top_k):.3e}")
    _, j_idx, j_pos, j_keep, j_cap, _ = j
    _, t_idx, t_pos, t_keep, t_cap, _ = t
    assert t_cap == j_cap
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    np.testing.assert_array_equal(t_keep.numpy(), np.asarray(j_keep))
    if cf == 1.0:           # cap = the mean load: some choices drop
        assert not bool(t_keep.all())


@pytest.mark.parametrize("cf", [1.0, 1.25, 2.0, 0.0])
@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_ffn_f32_equals_reference(dispatch, top_k, cf):
    w, x = _weights(), _tokens()
    jo, ja = jmoe.moe_ffn(_jax(w), jnp.asarray(x), top_k=top_k,
                          capacity_factor=cf, dispatch=dispatch)
    to, ta = tmoe.moe_ffn(_torch(w), torch.from_numpy(x), top_k=top_k,
                          capacity_factor=cf, dispatch=dispatch)
    assert to.shape == (B, S, D) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    assert abs(float(ta) - float(ja)) <= 1e-6


@pytest.mark.parametrize("cf", [1.25, 0.0])
def test_einsum_and_scatter_agree(cf):
    w, x = _torch(_weights(3)), torch.from_numpy(_tokens(4, b=3, s=20))
    a, aux_a = tmoe.moe_ffn(w, x, top_k=2, capacity_factor=cf,
                            dispatch="einsum")
    b, aux_b = tmoe.moe_ffn(w, x, top_k=2, capacity_factor=cf,
                            dispatch="scatter")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert float(aux_a) == float(aux_b)


def test_auto_dispatch_rule():
    assert tmoe.dispatch_for(8, 32, 2) == "einsum"         # a decode step
    assert tmoe.dispatch_for(894, 32, 279) == "scatter"    # a long prefill
    assert tmoe.dispatch_for(1, 1 << 11, 1 << 11) == "einsum"
    assert tmoe.dispatch_for(1, 1 << 11, (1 << 11) + 1) == "scatter"
    assert tmoe.capacity(8, 8, 32, 1.25) == 2
    assert tmoe.capacity(3, 1, 32, 1.25) == 1
    assert tmoe.capacity(7, 8, 32, 0) == 7


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_all_ties_row_picks_lowest_experts(top_k):
    """A zero token gives equal gates: ``jax.lax.top_k`` puts the lower
    index first, and so must the port."""
    w, x = _weights(), _tokens(b=1, s=5)
    x[0, 2] = 0.0
    _, t_idx, *_ = tmoe._route(_torch(w), torch.from_numpy(x[0]), top_k,
                               1.25)
    _, j_idx, *_ = jmoe._route(_jax(w), jnp.asarray(x[0]), top_k, 1.25)
    assert t_idx[2].tolist() == list(range(top_k))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
def test_moe_ffn_bf16_matches_reference_bf16(dispatch):
    w, x = _weights(), _tokens()
    xb = x.astype(jnp.bfloat16)
    jo, ja = jmoe.moe_ffn(_jax(w, jnp.bfloat16), jnp.asarray(xb), top_k=2,
                          capacity_factor=1.25, dispatch=dispatch)
    to, ta = tmoe.moe_ffn(_torch(w, torch.bfloat16),
                          torch.from_numpy(np.asarray(xb, np.float32)).to(
                              torch.bfloat16),
                          top_k=2, capacity_factor=1.25, dispatch=dispatch)
    assert to.dtype == torch.bfloat16
    ref = np.asarray(jo, np.float32)
    d = np.abs(to.to(torch.float32).numpy() - ref)
    assert d.max() < 0.1, d.max()
    assert np.abs(ref).max() > 0.5       # the scale the bound assumes
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_quantize_hook_sees_each_expert_slice_whole():
    """``quantize_w`` gets the whole (E, d, 2 ff) and (E, ff, d) tensors,
    as the reference's hook does."""
    seen = []

    def hook(w):
        seen.append(tuple(w.shape))
        return w

    tmoe.moe_ffn(_torch(_weights()), torch.from_numpy(_tokens()), top_k=2,
                 quantize_w=hook)
    assert seen == [(E, D, 2 * FF), (E, FF, D)]
