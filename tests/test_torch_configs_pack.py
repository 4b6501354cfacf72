"""``pack_params`` of the port against the reference's, split from
``tests/test_torch_configs.py`` (its helpers) so that the driver's
``--dist loadfile`` spreads the reference's compiles: leaf for leaf
(codes and scales bit-exact, the same scale shapes) on every registered
smoke config under ``paper_edge_p8`` (and ``serve_posit16`` for
granite-moe and whisper; the reference's packing jitted once per policy
and arch): an MoE expert's ``wo`` keeps its last axis, an audio model's
``enc_blocks`` share one scale across their layers; a packed granite-moe
smoke decode step gives the reference's logits."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from test_torch_configs import (  # noqa: E402,F401
    PORTED, _leaves, jax_params_to_numpy, jconfigs, jlm, params_from_numpy)
from _torch_threads import torch_threads  # noqa: E402,F401


# the MoE, hybrid and audio archs: test_torch_configs_pack_families.py
FAMILY_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b",
                "recurrentgemma-9b", "whisper-large-v3")


def check_pack_params(arch):
    """The port's ``pack_params`` on the reference's smoke weights (via
    the bridge) against the reference's on the same weights: the same
    leaves packed, codes and scales bit-exact, scale shapes equal."""
    from repro.core.transprecision import get_policy as j_get_policy
    from repro.core.transprecision import pack_params as j_pack_params
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.core.transprecision import get_policy, pack_params
    jc = jconfigs.get_config(arch, smoke=True)
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", torch.bfloat16)
    j_pack = jax.jit(j_pack_params, static_argnums=(1,))
    for policy in ("paper_edge_p8",) + (
            ("serve_posit16",) if arch in ("granite-moe-1b-a400m",
                                           "whisper-large-v3") else ()):
        want = _leaves(params_from_numpy(jax_params_to_numpy(
            j_pack(jp, j_get_policy(policy))), "cpu", torch.bfloat16))
        got = _leaves(pack_params(tp, get_policy(policy)))
        assert set(got) == set(want)
        n_packed = 0
        for path, t in got.items():
            j = want[path]
            assert isinstance(t, QuantizedTensor) == isinstance(
                j, QuantizedTensor), (policy, path)
            if isinstance(t, QuantizedTensor):
                n_packed += 1
                assert t.fmt.name == j.fmt.name, (policy, path)
                assert tuple(t.scale.shape) == tuple(j.scale.shape), (
                    policy, path, tuple(t.scale.shape))
                assert torch.equal(t.data, j.data), (policy, path)
                assert torch.equal(t.scale, j.scale), (policy, path)
            else:
                assert torch.equal(t, j), (policy, path)
        assert n_packed > 0
    if arch == "granite-moe-1b-a400m":     # an expert's wo: (P, E, f, d)
        wo = pack_params(tp, get_policy("paper_edge_p8"))["blocks"][0][
            "moe"]["wo"]
        assert tuple(wo.scale.shape) == (2, 1, 1, 64)


@pytest.mark.parametrize("arch", [a for a in PORTED
                                  if a not in FAMILY_ARCHS])
def test_pack_params_equals_reference(arch):
    check_pack_params(arch)
