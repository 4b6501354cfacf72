"""The port's architecture registry (``repro_torch.configs``) against the
reference's (``repro.configs``).

* Every registered arch's ``full()`` and ``smoke()`` equal the
  reference's field for field (the reference's fields the port does not
  carry, those of the unported families, sit at their defaults).
* ``param_count()`` equals the reference's at full width (mamba2-2.7b:
  2,702,624,256; recurrentgemma-9b: 7,483,699,200; qwen2-vl-2b:
  1,543,853,568; whisper-large-v3: 1,601,251,840).
* ``pack_params`` equals the reference's leaf for leaf (codes and scales
  bit-exact, the same scale shapes) on every registered smoke config
  under ``paper_edge_p8`` (and ``serve_posit16`` for granite-moe and
  whisper; the reference's packing jitted once per policy and arch): an
  MoE expert's ``wo``
  keeps its last axis, an audio model's ``enc_blocks`` share one scale
  across their layers (the reference stacks only ``blocks``); a packed
  granite-moe smoke decode step gives the reference's logits.  These two
  are in ``test_torch_configs_pack.py``, on this file's helpers.
* Greedy ``ServingEngine`` streams token-identical to the reference's at
  float32 (posit8 KV ring, ``paper_edge_p8``) for the four dense smoke
  configs: qk_norm with d_head != d_model / n_heads (qwen3), a gelu MLP
  (starcoder2), tied embeddings and an odd vocabulary (granite-3), rope
  500k (llama3).
* The two archs that were left unported (the vlm and audio families)
  build now; an unknown arch raises ``KeyError``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from test_torch_serve import jax_params_to_numpy  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PORTED = ("llama3-8b", "granite-3-8b", "qwen3-4b", "starcoder2-15b",
          "phi3.5-moe-42b-a6.6b", "granite-moe-1b-a400m", "mamba2-2.7b",
          "recurrentgemma-9b", "qwen2-vl-2b", "whisper-large-v3",
          "paper-edge")
DENSE = ("llama3-8b", "granite-3-8b", "qwen3-4b", "starcoder2-15b")
UNPORTED = ("qwen2-vl-2b", "whisper-large-v3")
PARAM_COUNTS = {"granite-moe-1b-a400m": 1_334_887_424,
                "phi3.5-moe-42b-a6.6b": 41_874_100_224,
                "mamba2-2.7b": 2_702_624_256,
                "recurrentgemma-9b": 7_483_699_200,
                "qwen2-vl-2b": 1_543_853_568,
                "whisper-large-v3": 1_601_251_840}


def test_registry_covers_the_reference():
    assert set(tconfigs.ARCHS) == set(PORTED)
    assert not tconfigs.UNPORTED
    assert set(tconfigs.ARCHS) == set(jconfigs.ARCHS) | {"paper-edge"}


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_config_fields_equal_reference(arch, smoke):
    t = tconfigs.get_config(arch, smoke=smoke)
    j = jconfigs.get_config(arch, smoke=smoke)
    tf = {f.name: getattr(t, f.name) for f in dataclasses.fields(t)}
    jf = {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert tf == {k: jf[k] for k in tf}
    defaults = type(j)()
    assert {k: v for k, v in jf.items() if k not in tf} == {
        k: getattr(defaults, k) for k in jf if k not in tf}
    assert (t.head_dim, t.vocab_pad) == (j.head_dim, j.vocab_pad)


@pytest.mark.parametrize("arch", PORTED)
def test_param_count_equals_reference(arch):
    t = tconfigs.get_config(arch).param_count()
    assert t == jconfigs.get_config(arch).param_count()
    if arch in PARAM_COUNTS:
        assert t == PARAM_COUNTS[arch]


def test_smoke_init_leaves_match_reference_shapes():
    """``lm.init_params`` builds the reference's tree for a dense tied
    config, an MoE config, the vlm and the audio config: same leaf names
    and shapes (the audio model's cross leaves, ``enc_blocks`` and
    ``enc_norm`` included)."""
    from repro_torch.models import lm as tlm
    for arch in ("granite-3-8b", "granite-moe-1b-a400m", "qwen3-4b",
                 "qwen2-vl-2b", "whisper-large-v3"):
        jc = jconfigs.get_config(arch, smoke=True)
        tc = tconfigs.get_config(arch, smoke=True)
        jp = jax_params_to_numpy(jlm.init_params(jax.random.PRNGKey(0), jc))
        tp = tlm.init_params(tc, torch.Generator().manual_seed(0),
                             device="cpu")

        def shapes(tree, prefix=""):
            if isinstance(tree, dict):
                return {k2: v2 for k, v in tree.items()
                        for k2, v2 in shapes(v, f"{prefix}/{k}").items()}
            if isinstance(tree, (tuple, list)):
                return {k2: v2 for i, v in enumerate(tree)
                        for k2, v2 in shapes(v, f"{prefix}/{i}").items()}
            return {prefix: tuple(tree.shape)}

        assert shapes(tp) == shapes(jp), arch
        assert sum(int(np.prod(s)) for s in shapes(tp).values()) \
            == tc.param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_dense_greedy_streams_equal_reference(arch):
    jc = dataclasses.replace(jconfigs.get_config(arch, smoke=True),
                             dtype_name="float32")
    tc = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                             dtype_name="float32")
    jp = jlm.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax_params_to_numpy(jp), "cpu", tc.dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tc.vocab, int(n)) for n in (5, 12, 9)]
    streams = []
    for eng_cls, cfg_cls, req_cls, cfg, params, kw in (
            (JServingEngine, JServeConfig, JRequest, jc, jp, {}),
            (ServingEngine, ServeConfig, Request, tc, tp,
             {"device": "cpu"})):
        eng = eng_cls(cfg, params, cfg_cls(max_batch=2, max_len=32,
                                           kv_format="posit8"),
                      policy="paper_edge_p8", **kw)
        reqs = [req_cls(uid=i, prompt=p, max_new=6)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        assert all(r.done and r.error is None for r in reqs)
        streams.append([r.out_tokens for r in reqs])
    assert streams[1] == streams[0]


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_raise(arch):
    """The archs once unported build now, full and smoke, in their
    families; only an unknown arch raises."""
    family = {"qwen2-vl-2b": "vlm", "whisper-large-v3": "audio"}[arch]
    assert tconfigs.get_config(arch).family == family
    assert tconfigs.get_config(arch, smoke=True).family == family
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


def _leaves(tree, prefix=""):
    """{path: leaf} of a params tree (a port or a reference
    QuantizedTensor is one leaf)."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (tuple, list)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}
