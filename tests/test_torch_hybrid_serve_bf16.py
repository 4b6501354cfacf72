"""Serving the hybrid family (recurrentgemma smoke) through the port
against the reference, split from ``tests/test_torch_hybrid_serve.py``
(its helpers and fixtures) so that the driver's ``--dist loadfile``
spreads the reference's compiles: at bf16 the prefill's and two decode
steps' logits within 1/32 of their largest magnitude; a prefill over
packed recurrent weights refused, with the reference's own failure
pinned beside it."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.core.transprecision import pack_params as j_pack_params  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.quant import QuantizedTensor  # noqa: E402
from repro_torch.core.transprecision import (  # noqa: E402
    get_policy, pack_params)
from repro_torch.models import lm, serve_model  # noqa: E402
from test_torch_rglru import hybrid_pair  # noqa: E402
from test_torch_serve import _codes, jax_params_to_numpy  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_hybrid_serve import (  # noqa: E402,F401
    _engine, _f32, _J_PREFILL, _prompts, f32, MAX_LEN, POLICY)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_bf16_logits_within_tolerance():
    """bf16: the prefill's logits (a 40-token prompt, wrapping the ring)
    and two decode steps' within 1/32 of the reference's largest
    magnitude, each engine from its own state."""
    jc, tc, jp, tp = hybrid_pair("bfloat16")
    je = JServingEngine(jc, jp, JServeConfig(max_batch=2, max_len=MAX_LEN,
                                             kv_format="posit8"),
                        policy=POLICY)
    te = _engine((jc, tc, jp, tp))
    prompt = _prompts(tc.vocab, (40,))[0][None]
    logits = []
    for eng, tokens in ((je, jnp.asarray(prompt, jnp.int32)),
                        (te, torch.from_numpy(prompt))):
        api = eng.engine
        prefix = api.prefill(eng.params, tokens)
        state = api.insert(prefix, api.init_decode_state(), 1)
        got = [_f32(prefix["logits"][0])]
        for _ in range(2):
            state, lg = api.generate(eng.params, state)
            got.append(_f32(lg[1]))
        logits.append(got)
    for j, t in zip(*logits):
        np.testing.assert_allclose(t, j, rtol=0, atol=np.abs(j).max() / 32)


def test_packed_recurrent_prefill_refused_as_reference(f32):
    """``pack_params`` packs the recurrent projections under
    ``mlp_weights`` as the reference does (``w_out`` scaled per input row,
    the rest per output column; codes and scales equal the reference's);
    a prefill over them raises ``TypeError`` on both sides (the
    reference reads ``wx`` raw), while a decode step over the packed
    weights serves the logits of their decoded values (served with the
    weight hook off)."""
    jc, tc, jp, tp = f32
    jpol, tpol = j_get_policy(POLICY), get_policy(POLICY)
    rec, tail = jp["blocks"][0], jp["tail"][0]
    jsub = j_pack_params({"blocks": ({"wx": rec["wx"], "w_out": rec["w_out"],
                                      "rglru": {"w_a": rec["rglru"]["w_a"]}},),
                          "tail": ({"w_out": tail["w_out"]},)}, jpol)
    bridged = params_from_numpy(jax_params_to_numpy(jsub), "cpu", tc.dtype)
    tpk = pack_params(tp, tpol)
    for part, keys in (("blocks", ("wx",)), ("blocks", ("w_out",)),
                       ("blocks", ("rglru", "w_a")), ("tail", ("w_out",))):
        t, j = tpk[part][0], bridged[part][0]
        for k in keys:
            t, j = t[k], j[k]
        np.testing.assert_array_equal(_codes(t.data), _codes(j.data))
        np.testing.assert_array_equal(t.scale.numpy(), j.scale.numpy())
    assert tpk["blocks"][0]["w_out"].scale.shape == (1, 64, 1)
    tokens = np.stack(_prompts(tc.vocab, (12,)))
    with pytest.raises(TypeError, match="QuantizedTensor"):
        serve_model.prefill(tpk, {"tokens": torch.from_numpy(tokens)}, tc,
                            MAX_LEN, tpol)
    jpk = dict(jp, blocks=(dict(rec, wx=jsub["blocks"][0]["wx"]),)
               + jp["blocks"][1:])
    with pytest.raises(TypeError, match="QuantizedTensor"):
        _J_PREFILL(jpk, {"tokens": jnp.asarray(tokens)}, jc, MAX_LEN, jpol)

    def decoded(node):
        if isinstance(node, dict):
            return {k: decoded(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(decoded(v) for v in node)
        return (node.dequantize(torch.bfloat16)
                if isinstance(node, QuantizedTensor) else node)

    logits = [serve_model.decode_step(
        params, serve_model.init_cache(tc, 1, MAX_LEN, policy=tpol,
                                       device="cpu"),
        torch.from_numpy(tokens[:, :1]), tc, pol)[0]
        for params, pol in ((tpk, tpol), (decoded(tpk), lm.weights_free(
            tpol, tc.tie_embed)))]
    assert torch.isfinite(logits[0]).all()
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)
