"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic, keep-k, async, resumable, in the reference's on-disk layout.

Layout:  <dir>/step_<n>/arrays.npz + meta.json + COMMIT

* atomic  — writes go to ``step_<n>.tmp``, then ``os.replace`` after the
            COMMIT marker is written: a crash mid-write never leaves a
            checkpoint that ``latest_step`` would pick.
* keep-k  — committed steps beyond the newest ``keep`` are removed.
* async   — ``save(..., blocking=False)`` copies every leaf to host memory
            synchronously (the train step updates its state in place, so
            the snapshot must be taken before it returns), then writes the
            file on a thread; a write error surfaces on the next
            ``wait()`` or ``save()``.

Trees are flattened to ``path -> array`` with the reference's keys: the
children of a ``TrainState`` are 0 (params), 1 (optimizer state) and 2
(the error-feedback residual, absent when None), dict keys by name and
tuple or list items by index, joined by ``|`` (``0|blocks|0|wq``,
``1|master|embed``, ``1|step``).  So a checkpoint written by either
package restores in the other.  bf16 (and other dtypes numpy cannot hold)
is stored as float32 and cast back to the template's dtype on restore.
Restore copies into the template's tensors, on their device; every
template leaf must be a tensor.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_SEP = "|"
# dtypes without a numpy counterpart: stored as float32 (exact)
_WIDEN = {torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2}


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(i, getattr(node, f.name))
                for i, f in enumerate(dataclasses.fields(node))]
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """``path -> leaf`` in the reference's key format; None has no
    leaves."""
    if tree is None:
        return {}
    kids = _children(tree)
    if kids is None:
        return {_SEP.join(str(p) for p in prefix): tree}
    flat = {}
    for k, child in kids:
        flat.update(_flatten(child, prefix + (k,)))
    return flat


def _snapshot(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that numpy can store (never a view of a
    tensor the train step goes on to update)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype in _WIDEN:
            t = t.to(torch.float32)
        return t.numpy()
    return np.array(leaf)


def _restore(node, flat: Dict[str, np.ndarray], prefix=()):
    """``node`` with every tensor leaf overwritten in place from
    ``flat``."""
    if node is None:
        return None
    kids = _children(node)
    if kids is None:
        key = _SEP.join(str(p) for p in prefix)
        if not isinstance(node, torch.Tensor):
            raise TypeError(f"template leaf {key}: {type(node).__name__}, "
                            "expected a tensor")
        if key not in flat:
            raise ValueError(f"checkpoint missing key {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {key}: shape {arr.shape}, "
                             f"template {tuple(node.shape)}")
        with torch.no_grad():
            node.copy_(torch.as_tensor(arr).to(node.dtype))
        return node
    new = [(k, _restore(c, flat, prefix + (k,))) for k, c in kids]
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **{
            f.name: v for f, (_, v) in zip(dataclasses.fields(node), new)})
    if isinstance(node, dict):
        return dict(new)
    return type(node)(v for _, v in new)


def save_pytree(tree, path: str) -> None:
    """Atomic single-file save of a tree of tensors."""
    tmp = path + ".tmp"
    flat = {k: _snapshot(v) for k, v in _flatten(tree).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_pytree(template, path: str):
    """Load ``path`` into ``template``'s tensors (shapes must match); the
    reference's ``__treedef__`` entry, where present, is ignored."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if k != "__treedef__"}
    return _restore(template, flat)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ---- discovery ----
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                full = os.path.join(self.dir, name)
                if os.path.exists(os.path.join(full, "COMMIT")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ---- save ----
    def _write(self, flat_np: Dict[str, np.ndarray], step: int,
               meta: Dict[str, Any]):
        final = os.path.join(self.dir, f"step_{step}")
        tmp = final + ".tmp"
        try:
            os.makedirs(tmp, exist_ok=True)
            with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
                np.savez(f, **flat_np)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            with open(os.path.join(tmp, "COMMIT"), "w") as f:
                f.write(str(time.time()))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        except BaseException as e:          # surfaced on next wait()/save()
            self._error = e

    def save(self, tree, step: int, blocking: bool = True,
             meta: Optional[Dict[str, Any]] = None):
        """Snapshot to host, then write (optionally on a worker thread)."""
        self.wait()
        flat_np = {k: _snapshot(v) for k, v in _flatten(tree).items()}
        meta = dict(meta or {}, step=step, time=time.time())
        if blocking:
            self._write(flat_np, step, meta)
            self.check()
        else:
            self._thread = threading.Thread(
                target=self._write, args=(flat_np, step, meta), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint failed: {err!r}") from err

    # ---- restore ----
    def restore(self, template, step: Optional[int] = None):
        """Restore step ``step`` (default the latest committed) into
        ``template``'s tensors, in place; returns (tree, meta), or (None,
        None) when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _restore(template, flat)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        return tree, meta

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)
