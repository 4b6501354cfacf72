"""Train-step factory (port of ``repro.train.step``): loss -> grads ->
(optional posit wire compression) -> AdamW, in place.  The TC policy
enters the forward through ``loss_fn`` (fake-quant with a straight-through
gradient on every weight, per layer slice, on every call).  When
``policy.grad_wire`` is set, the gradients pass through the wire format
with error feedback (``optim/compression.py``: K2 then K1 per leaf on the
card) before the update, and the residual lives in the train state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .. import resolve_device
from ..core.transprecision import BF16, TCPolicy
from ..models import lm
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import tree_leaves, tree_map, tree_unflatten
from ..optim.compression import check_wire_format, error_feedback_update


@dataclasses.dataclass
class TrainState:
    """Everything a restart needs: params, optimizer state and the
    gradient wire's error-feedback residual (None without a wire)."""
    params: Any
    opt: Any
    ef_residual: Optional[Any] = None


def init_train_state(cfg: lm.ModelCfg, opt_cfg: AdamWConfig,
                     policy: TCPolicy = BF16, *,
                     generator: Optional[torch.Generator] = None,
                     device="cuda") -> TrainState:
    """Random params (``lm.init_params``), a fresh AdamW state and, when
    the policy sets ``grad_wire``, a float32 zero residual per param."""
    check_wire_format(policy.grad_wire)
    params = lm.init_params(cfg, generator, resolve_device(device))
    ef = None
    if policy.grad_wire:
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    return TrainState(params, adamw_init(params), ef)


def make_train_step(cfg: lm.ModelCfg, opt_cfg: AdamWConfig,
                    policy: TCPolicy = BF16):
    """Returns step(state, batch) -> (state, metrics); the step updates
    ``state`` in place and returns it.  Raises ``ValueError`` for a
    ``grad_wire`` the kernels cannot take (``check_wire_format``)."""
    check_wire_format(policy.grad_wire)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        loss, parts = lm.loss_fn(state.params, batch, cfg, policy)
        grads = torch.autograd.grad(loss, leaves)
        for p in leaves:
            p.requires_grad_(False)
        grads = tree_unflatten(state.params, grads)
        if policy.grad_wire:
            grads, state.ef_residual = error_feedback_update(
                grads, state.ef_residual, policy.grad_wire)
        opt_metrics = adamw_update(grads, state.opt, state.params, opt_cfg)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()},
                   **opt_metrics}
        return state, metrics

    return step



def state_specs(cfg: lm.ModelCfg, pspecs, policy: TCPolicy = BF16):
    """TrainState spec trees mirroring the param specs (FSDP-consistent):
    ``launch.mesh.opt_specs`` for the optimizer and, with a gradient wire,
    the param specs for its residual."""
    from ..launch.mesh import opt_specs
    return TrainState(pspecs, opt_specs(pspecs),
                      pspecs if policy.grad_wire else None)
