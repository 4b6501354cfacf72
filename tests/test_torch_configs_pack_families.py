"""``pack_params`` of the port against the reference's on the MoE,
hybrid and audio smoke configs (granite-moe and whisper also under
``serve_posit16``), and a packed granite-moe smoke decode step against
the reference's logits; split from ``tests/test_torch_configs_pack.py``
(its checks and the registry's helpers) so that the driver's
``--dist loadfile`` spreads the reference's compiles."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_configs import (  # noqa: E402
    jax_params_to_numpy, jconfigs, jlm, params_from_numpy, tconfigs)
from test_torch_configs_pack import (  # noqa: E402,F401
    check_pack_params, FAMILY_ARCHS)
from _torch_threads import torch_threads  # noqa: E402,F401


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_pack_params_equals_reference(arch):
    check_pack_params(arch)


def test_packed_moe_decode_equals_reference():
    """A decode step of granite-moe smoke (float32) over ``pack_params``
    weights (``paper_edge_p8``, posit8 KV) from a fresh cache, three
    steps: the logits within 1e-5 of the reference's over its own packed
    weights, greedy tokens equal."""
    from repro.core.transprecision import get_policy as j_get_policy
    from repro.core.transprecision import pack_params as j_pack_params
    from repro.models import serve_model as jsm
    from repro_torch.core.transprecision import get_policy, pack_params
    from repro_torch.models import serve_model as tsm
    arch = "granite-moe-1b-a400m"
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             dtype_name="float32")
    tc = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                             dtype_name="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    jpol, tpol = j_get_policy("paper_edge_p8"), get_policy("paper_edge_p8")
    jpk = jax.jit(j_pack_params, static_argnums=(1,))(jp, jpol)
    tpk = pack_params(tp, tpol)
    jcache = jsm.init_cache(jc, 2, 16, policy=jpol)
    tcache = tsm.init_cache(tc, 2, 16, policy=tpol, device="cpu")
    tok = np.array([[3], [77]], np.int32)
    step = jax.jit(jsm.decode_step, static_argnums=(3, 4))
    for _ in range(3):
        jl, jcache = step(jpk, jcache, jnp.asarray(tok), jc, jpol)
        tl, tcache = tsm.decode_step(tpk, tcache, torch.from_numpy(
            tok.astype(np.int64)), tc, tpol)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
        tok = np.asarray(jl)[:, :tc.vocab].argmax(-1)[:, None].astype(
            np.int32)
        assert (tl[:, :tc.vocab].argmax(-1).numpy() == tok[:, 0]).all()
