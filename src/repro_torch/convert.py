"""Weight bridge: a nested dict of numpy arrays -> the port's params (and
a whole train state: params, AdamW state, the gradient wire's residual).

The tree is the reference's params pytree after ``np.asarray`` on every
leaf (tuples stay tuples, so ``blocks`` keeps its (dict,) form and every
stacked leaf its leading layer axis).  Packed weights arrive flattened as
``{"data", "scale", "fmt": name}`` dicts and become ``QuantizedTensor``s;
unsigned 16/32-bit codes keep their bit patterns as int16/int32.

bf16 leaves cannot cross ``torch.from_numpy``: hand them over as float32
(exact) and pass ``dtype=torch.bfloat16``; every weight leaf is cast back
to it (exact) while the norm gains, the MoE router, the SSM's
``A_log``, ``D``, ``dt_bias`` and ``norm_scale`` and the RG-LRU's
``b_a``, ``b_x`` and ``Lambda`` stay float32, as the reference keeps them
(the hybrid's conv taps are weights).  A hybrid's ``tail`` (a tuple of
unstacked block dicts) and an audio model's ``enc_blocks`` cross as
``blocks`` does, with its cross-attention leaves.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.formats import get
from .core.quant import QuantizedTensor

# leaves the reference keeps float32 in a bf16 model: the norm gains (the
# cross-attention's and the encoder's too), the MoE router (rounding it
# would move the routing), the SSM's decay, skip, step bias and gated-norm
# gain, and the RG-LRU's gate biases and decay
_F32_LEAVES = ("ln", "ln2", "ln_x", "final_norm", "enc_norm", "q_norm",
               "k_norm", "router", "A_log", "D", "dt_bias", "norm_scale",
               "b_a", "b_x", "Lambda")
_BITS_VIEW = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                     # writable, contiguous copy
    if a.dtype in _BITS_VIEW:
        a = a.view(_BITS_VIEW[a.dtype])
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device="cuda", dtype=torch.float32):
    """Convert ``tree`` (see module docstring) to torch params on
    ``device``; float weight leaves become ``dtype``."""
    device = resolve_device(device)

    def conv(node, name):
        if isinstance(node, dict) and "fmt" in node:
            scale = node.get("scale")
            return QuantizedTensor(
                _tensor(node["data"], device),
                None if scale is None else _tensor(scale, device),
                get(node["fmt"]))
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(conv(v, name) for v in node)
        t = _tensor(node, device)
        if t.is_floating_point() and name not in _F32_LEAVES:
            t = t.to(dtype)
        return t

    return conv(tree, None)


def train_state_from_numpy(params_tree, device="cuda", dtype=torch.float32,
                           opt=None, ef_residual=None):
    """The reference's ``TrainState`` (each part as a numpy tree, see the
    module docstring) -> a port ``TrainState``.  ``opt`` is the AdamW state
    ``{"step", "mu", "nu", "master"}`` (float32 moments and master, an
    int32 step); None rebuilds it with ``adamw_init`` (step 0, zero
    moments, an f32 master copy of the params).  ``ef_residual`` is the
    gradient wire's float32 residual tree, or None."""
    from .optim import adamw_init
    from .train.step import TrainState
    params = params_from_numpy(params_tree, device, dtype)
    if opt is None:
        opt = adamw_init(params)
    else:
        opt = params_from_numpy(opt, device, torch.float32)
        opt["step"] = opt["step"].to(torch.int32)
    if ef_residual is not None:
        ef_residual = params_from_numpy(ef_residual, device, torch.float32)
    return TrainState(params, opt, ef_residual)
