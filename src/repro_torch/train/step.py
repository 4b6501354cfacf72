"""Train-step factory (port of ``repro.train.step``): loss -> grads ->
AdamW, in place.  The TC policy enters the forward through ``loss_fn``
(fake-quant with a straight-through gradient on every weight, per layer
slice, on every call).  The posit gradient wire (``policy.grad_wire``,
``optim/compression.py``) is a later slice of the port and raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core.transprecision import BF16, TCPolicy
from ..models import lm
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import tree_leaves


@dataclasses.dataclass
class TrainState:
    """Everything a restart needs: params and optimizer state (the
    error-feedback residual of the gradient wire is a later slice)."""
    params: Any
    opt: Any


def _check_policy(policy: TCPolicy) -> None:
    if policy.grad_wire:
        raise NotImplementedError(
            f"policy {policy.name!r} sets grad_wire={policy.grad_wire!r}: "
            "posit gradient compression (optim/compression.py) is a later "
            "slice of the port")


def init_train_state(cfg: lm.ModelCfg, opt_cfg: AdamWConfig,
                     policy: TCPolicy = BF16, *,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """Random params (``lm.init_params``) and a fresh AdamW state."""
    _check_policy(policy)
    params = lm.init_params(cfg, generator, resolve_device(device))
    return TrainState(params, adamw_init(params))


def make_train_step(cfg: lm.ModelCfg, opt_cfg: AdamWConfig,
                    policy: TCPolicy = BF16):
    """Returns step(state, batch) -> (state, metrics); the step updates
    ``state`` in place and returns it."""
    _check_policy(policy)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, parts = lm.loss_fn(state.params, batch, cfg, policy)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        grads = _unflatten(state.params, iter(grads))
        opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return state, metrics

    return step


def _unflatten(tree, leaves):
    """``tree``'s structure filled from the iterator ``leaves``, taken in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)
