"""The donated ``generate`` over the vlm and audio smoke stacks, on the
CPU (the fixed-buffer step runs eagerly there), at float32 under
``paper_edge_p8`` with a posit8 KV format.

* qwen2-vl (ring): a donating ``ServingEngine``'s greedy streams equal a
  non-donating one's and the reference's ``ServingEngine``'s.
* whisper through the stages (the engine refuses an audio admission, as
  the reference does): the prefill of two clips inserted into a donating
  engine's state, then greedy ``generate`` ticks, give the reference's
  greedy stream and a non-donating engine's logits bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from test_torch_audio_serve import (_J_DECODE, _J_PREFILL, _inputs,  # noqa: E402
                                    _policies)
from test_torch_donate_families import MAX_LEN, check_streams  # noqa: E402
from test_torch_vlm import family_pair  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def test_vlm_streams():
    check_streams("qwen2-vl-2b", "ring")


def test_audio_through_the_stages():
    jc, tc, jp, tp = family_pair("whisper-large-v3")
    jpol, tpol = _policies("ring")
    toks, frames = _inputs(tc)
    jl, jcache = _J_PREFILL(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                 "frames": jnp.asarray(frames)}, jc,
                            MAX_LEN, jpol)
    logits, cache = serve_model.prefill(
        tp, {"tokens": torch.from_numpy(toks),
             "frames": torch.from_numpy(frames)}, tc, MAX_LEN, tpol)
    prefix = {"logits": logits, "cache": cache,
              "length": torch.full((2,), toks.shape[1], dtype=torch.int32)}
    first = logits[:, :tc.vocab].argmax(-1).to(torch.int32)[:, None]
    runs = []
    for donate in (True, False):
        eng = TransprecisionEngine(tc, lm.weights_free(tpol), 2, MAX_LEN,
                                   device="cpu", donate=donate)
        state = eng.init_decode_state()
        for slot in range(2):
            state = eng.insert(prefix, state, slot, row=slot)
        state["tok"] = first.clone()
        steps = []
        for _ in range(6):
            state, lg = eng.generate(tp, state)
            steps.append((lg, state["tok"][:, 0].tolist()))
        runs.append(steps)
    want = []
    jt = np.asarray(jl)[:, :tc.vocab].argmax(-1)[:, None]
    for _ in range(6):
        jl, jcache = _J_DECODE(jp, jcache, jnp.asarray(jt, jnp.int32), jc,
                               jpol)
        jt = np.asarray(jl)[:, :tc.vocab].argmax(-1)[:, None]
        want.append(jt[:, 0].tolist())
    for (dl, dt), (el, et) in zip(*runs):
        assert torch.equal(dl, el)
        assert dt == et
    assert [t for _, t in runs[0]] == want
