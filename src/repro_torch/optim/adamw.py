"""AdamW with f32 master weights, global-norm clipping and LR schedules
(port of ``repro.optim.adamw``; not ``torch.optim.AdamW``, whose weight
decay and eps placement differ).

The optimizer state is a dict ``{"step", "mu", "nu", "master"}`` whose
trees mirror the params leaf for leaf (same shapes).  ``master`` holds f32
copies of the params (bf16 or f32); updates are computed on it in f32 and
cast back.  ``adamw_update`` updates params and state in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"   # cosine | linear | constant
    min_lr_ratio: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (dicts, tuples, lists) and the
    matching leaves of ``rest``; returns a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in the reference's order (dict keys sorted, as jax's
    ``tree_leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree``'s structure filled from ``leaves``, taken in
    ``tree_leaves`` order (the inverse of ``tree_leaves``)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(fill(v) for v in node)
        return next(it)

    return fill(tree)


def make_schedule(cfg: AdamWConfig):
    """step (int or tensor) -> lr (f32 scalar tensor); warmup + decay."""

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
                1 + torch.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1 - t)
        else:
            decay = 1.0
        return cfg.lr * warm * decay

    return sched


def adamw_init(params):
    """Step 0, zero f32 moments and an f32 master copy of every leaf (a
    copy even for f32 params: the master must not alias its param)."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "master": tree_map(
                lambda p: p.detach().to(torch.float32, copy=True), params)}


def global_norm(tree):
    sq = [torch.sum(torch.square(leaf.to(torch.float32)))
          for leaf in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def _clip_scale(grads, max_norm):
    """(the factor that clips ``grads`` to ``max_norm``, their norm)."""
    gn = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def clip_by_global_norm(grads, max_norm):
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn


# elements of a leaf the update takes at a time: its f32 temporaries stay
# a few of these wide however large the leaf (a full-width embedding
# table has ~1e9 elements)
_CHUNK = 1 << 26


def _chunks(p, mst, g, m, v):
    """The update's operands in flat slices of at most ``_CHUNK``
    elements (every op of the update is elementwise, so slice by slice it
    gives the same values), or whole where a written tensor is not
    contiguous (its flat view would be a copy)."""
    if not all(t.is_contiguous() for t in (p, mst, m, v)):
        return ((p, mst, g, m, v),)
    return zip(*(t.reshape(-1).split(_CHUNK) for t in (p, mst, g, m, v)))


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None):
    """One AdamW step, all math in f32, IN PLACE: ``params`` and the
    ``state`` tensors are overwritten.  Returns the metrics (grad norm
    before clipping, lr).  Decoupled weight decay applies to leaves with
    ndim >= 2, so the stacked (P, d) norm gains decay too, as in the
    reference.  Each leaf's gradient is clipped as its update reads it
    (no clipped copy of the whole tree), ``_CHUNK`` elements at a time."""
    state["step"] += 1
    step = state["step"].to(torch.float32)
    if lr is None:
        lr = make_schedule(cfg)(step)
    scale, gn = _clip_scale(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step

    def upd(p, mst, g, m, v):
        decay = mst.ndim >= 2
        for p, mst, g, m, v in _chunks(p, mst, g, m, v):
            g = g.to(torch.float32) * scale        # clipped
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            step_v = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            wd = cfg.weight_decay * mst if decay else 0.0
            mst.copy_(mst - lr * (step_v + wd))
            p.copy_(mst.to(p.dtype))

    tree_map(upd, params, state["master"], grads, state["mu"], state["nu"])
    return {"grad_norm": gn, "lr": lr}
