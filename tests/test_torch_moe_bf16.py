"""MoE serving through the port against the reference, split from
``tests/test_torch_moe_serve.py`` (its helpers and tolerances) so that
the driver's ``--dist loadfile`` spreads the reference's compiles:
granite-moe smoke's bf16 prefill and decode logits within 0.1 of their
largest magnitude of the reference's bf16, and the serve launcher over
the MoE arch."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.transprecision import get_policy as j_get_policy  # noqa: E402
from repro_torch.core.transprecision import get_policy as t_get_policy  # noqa: E402
from repro_torch.models import serve_model as tsm  # noqa: E402
from test_torch_serve import _f32  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_moe_serve import (  # noqa: E402,F401
    _J_DECODE, _J_PREFILL, ARCH, moe_pair, POLICY)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_prefill_decode_bf16_matches_reference_bf16():
    """bf16 rounds at other places in the two frameworks: logits agree to
    within 0.1 of their largest magnitude (the dense test's 0.1 absolute on
    a logit scale of ~1; this tied model's logits reach ~0.45)."""
    jc, tc, jp, tp = moe_pair("bfloat16")
    assert tp["blocks"][0]["moe"]["router"].dtype == torch.float32
    assert tp["blocks"][0]["moe"]["wi"].dtype == torch.bfloat16
    jpol = dataclasses.replace(j_get_policy(POLICY), kv_format="posit8")
    tpol = dataclasses.replace(t_get_policy(POLICY), kv_format="posit8")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, tc.vocab, (2, 10))
    jl, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                            jc, 32, jpol)
    tl, tcache = tsm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc, 32,
                             tpol)
    out = [(jl, tl)]
    for _ in range(2):
        tok = rng.integers(0, tc.vocab, (2, 1))
        jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(tok, jnp.int32), jc,
                               jpol)
        tl, tcache = tsm.decode_step(tp, tcache, torch.from_numpy(tok), tc,
                                     tpol)
        out.append((jl, tl))
    for jl, tl in out:
        assert tl.dtype == torch.bfloat16
        d = np.abs(_f32(tl) - _f32(jl))
        scale = np.abs(_f32(jl)).max()
        assert scale > 0.25                 # logits far from all-zero
        assert d.max() < 0.1 * scale, (d.max(), scale)


@pytest.mark.parametrize("extra", [["--energy"],
                                   ["--async", "--kv-layout", "paged",
                                    "--overcommit", "--fault-plan",
                                    "random:seed=3,n=6", "--health",
                                    "--energy"]])
def test_serve_launcher_moe(extra, capsys):
    from repro_torch.launch import serve as launch
    out = launch.main(["--arch", ARCH, "--device", "cpu", "--requests", "4",
                       "--max-new", "4", "--batch", "2", "--max-len", "64"]
                      + extra)
    eng = out["engine"]
    assert eng.cfg.family == "moe" and not eng.engine.bucketed
    if "--async" in extra:
        assert out["errors"] == {}
        assert all(len(s.out_tokens) == 4 for s in out["streams"])
        assert out["health"]["healthy"]
    else:
        assert all(r.done and r.error is None and len(r.out_tokens) == 4
                   for r in out["requests"])
    printed = capsys.readouterr().out
    assert "energy (modeled: TALU Table IV" in printed
    for stage in ("prefill", "insert", "generate"):
        assert stage in printed
