"""Weight bridge: a nested dict of numpy arrays -> the port's params (and
a train state around them).

The tree is the reference's params pytree after ``np.asarray`` on every
leaf (tuples stay tuples, so ``blocks`` keeps its (dict,) form and every
stacked leaf its leading layer axis).  Packed weights arrive flattened as
``{"data", "scale", "fmt": name}`` dicts and become ``QuantizedTensor``s;
unsigned 16/32-bit codes keep their bit patterns as int16/int32.

bf16 leaves cannot cross ``torch.from_numpy``: hand them over as float32
(exact) and pass ``dtype=torch.bfloat16``; every weight leaf is cast back
to it (exact) while the norm gains stay float32, as the reference keeps
them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .core.formats import get
from .core.quant import QuantizedTensor

_F32_LEAVES = ("ln", "ln2", "final_norm", "q_norm", "k_norm")
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


def train_state_from_numpy(params_tree, device="cuda", dtype=torch.float32):
    """The reference's ``TrainState.params`` (as a numpy tree, see module
    docstring) -> a port ``TrainState`` whose AdamW state ``adamw_init``
    rebuilds from the converted params (step 0, zero moments, f32
    master)."""
    from .optim import adamw_init
    from .train.step import TrainState
    params = params_from_numpy(params_tree, device, dtype)
    return TrainState(params, adamw_init(params))
