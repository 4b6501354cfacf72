"""MoE serving through the port against the reference, split from
``tests/test_torch_moe_serve.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles:
granite-moe smoke's ``ServingEngine`` greedy streams token-identical at
float32 in the paged layout (5 prompts of 3-14 tokens over 2 slots, the
engine stats and page accounting equal), and the refusals (``lengths=``
on prefill, ``true_len``, ``verify_step``, ``SpeculativeEngine``) raising
the reference's exception types."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro.models import serve_model as jsm  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine_api import TransprecisionEngine as JEngineAPI  # noqa: E402
from repro.serve.speculative import SpeculativeEngine as JSpeculative  # noqa: E402
from repro_torch.core.transprecision import get_policy as t_get_policy  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from repro_torch.serve import ServeConfig  # noqa: E402
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from repro_torch.serve.speculative import SpeculativeEngine  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_moe_serve import (  # noqa: E402,F401
    ARCH, check_streams, MAX_LEN, pair, POLICY)
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("arch,layout", [(ARCH, "paged")])
def test_engine_streams_token_identical(arch, layout, pair):
    check_streams(arch, layout, pair)


def test_refusals_raise_the_reference_types(pair):
    jc, tc, jp, tp = pair
    toks = np.zeros((1, 8), np.int64)
    lens = np.array([5], np.int32)
    japi = JEngineAPI(jc, j_get_policy(POLICY), 2, MAX_LEN)
    tapi = TransprecisionEngine(tc, t_get_policy(POLICY), 2, MAX_LEN,
                                device="cpu")
    assert japi.bucketed == tapi.bucketed is False
    calls = [
        (lambda: japi.prefill(jp, toks, lens),
         lambda: tapi.prefill(tp, torch.from_numpy(toks),
                              torch.from_numpy(lens))),
        (lambda: jsm.prefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                             jc, 32, j_get_policy(POLICY),
                             true_len=jnp.asarray(lens)),
         lambda: tsm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32,
                             t_get_policy(POLICY),
                             true_len=torch.from_numpy(lens))),
        (lambda: jsm.verify_step(jp, jsm.init_cache(jc, 1, 32),
                                 jnp.zeros((1, 2), jnp.int32), jc),
         lambda: tsm.verify_step(tp, tsm.init_cache(tc, 1, 32,
                                                    device="cpu"),
                                 torch.zeros((1, 2), dtype=torch.int64),
                                 tc)),
        (lambda: JSpeculative(jc, jp, JServeConfig(max_batch=2,
                                                   max_len=MAX_LEN)),
         lambda: SpeculativeEngine(tc, tp, ServeConfig(max_batch=2,
                                                       max_len=MAX_LEN),
                                   device="cpu")),
    ]
    for j_call, t_call in calls:
        with pytest.raises(Exception) as je:
            j_call()
        with pytest.raises(type(je.value)):
            t_call()
        assert type(je.value) is ValueError
