"""Op-level cost of one engine stage, counted on meta tensors (the port's
counterpart of ``repro.launch.hlo_cost``'s ``analyze`` and
``entry_param_bytes_by_dtype``).

The reference re-lowers a stage from the abstract argument spec recorded
on its first call, compiles it and parses the HLO text for dot FLOPs and
entry-parameter bytes.  There is no HLO here, and the port's kernels are
``ctypes`` launches no counting mode could see.  Instead :func:`analyze`
runs the stage's function once on **meta tensors** built from the recorded
spec (``serve/engine_api.py`` ``_abstract_args``), under a
``TorchDispatchMode`` that counts every aten op and prices the products
by ``torch.utils.flop_counter``'s formula table (the one
``FlopCounterMode`` sums):

* meta tensors carry shapes and dtypes only: the trace reads no data,
  launches nothing and allocates no device memory, and it gives the same
  table whether the engine lives on the card or on the CPU;
* every kernel wrapper takes its plain version for a tensor that is not
  on CUDA, so the trace counts the plain K1 and K3-K6 the way the
  reference's CPU HLO counts its interpret-mode Pallas bodies (a trace for
  counting, the counterpart of ``fn.lower(*spec)``; the served stage still
  runs the kernels);
* a host sync (``.item()``, ``.tolist()``, boolean-mask indexing) needs
  data and raises :class:`TraceError`, as does a tensor made on a device.

Counts (the reference's keys):

* ``mac_flops`` — FLOPs of the products, from ``flop_registry``'s
  formulas (mm, bmm, addmm, baddbmm, convolutions, attention;
  ``einsum`` lowers to them): 2 per multiply-accumulate;
* ``flops`` — ``mac_flops`` plus one per output element of every other op
  that is not a view;
* ``bytes`` — each op's tensor inputs and outputs (unfused traffic;
  reported, never priced);
* ``flops_by_dtype`` / ``bytes_by_dtype`` under the reference's dtype
  labels (``f32``, ``bf16``, ``u8``, ``u16``, ``s32``, ...); a product's
  FLOPs go to its output's dtype.

Running the same function on CPU tensors gives the same counts.  This is
also the base for a meta-device dry run of a whole configuration: with
``kernels="custom_call"`` every kernel wrapper that routes through
:func:`custom_call` counts as the one launch it makes on the card, as the
reference's ``hlo_cost`` counts a custom call (its operands read once, the
rows it writes written once) and not as its plain version's ops.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Optional,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["TraceError", "analyze", "custom_call", "dtype_label",
           "entry_param_bytes_by_dtype"]

_LABELS = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
    torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint64: "u64",
    torch.uint32: "u32", torch.uint16: "u16", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
}

_aten = torch.ops.aten
# ops that need a tensor's data on the host: no meta trace can run them
_HOST_SYNC = {_aten._local_scalar_dense.default, _aten.nonzero.default,
              _aten.masked_select.default, _aten.unique_consecutive.default,
              _aten._unique2.default}
# indexing ops whose boolean-mask index is a data-dependent shape
_INDEXING = {_aten.index.Tensor, _aten.index_put.default,
             _aten.index_put_.default, _aten._index_put_impl_.default}
# allocation only: no element is computed
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default}


class TraceError(RuntimeError):
    """A stage cannot be counted on meta tensors (a host sync, or a tensor
    made on a device)."""


def dtype_label(dtype: torch.dtype) -> str:
    """The reference's HLO label of a dtype (``f32``, ``u8``, ...)."""
    return _LABELS.get(dtype, str(dtype).replace("torch.", ""))


def _off_host(device) -> bool:
    return device is not None and torch.device(device).type not in (
        "meta", "cpu")


def _add(d: Dict[str, float], key: str, v: float) -> None:
    d[key] = d.get(key, 0.0) + float(v)


class _OpCost(TorchDispatchMode):
    """Counts every aten op's outputs and tensor traffic; the products'
    FLOPs come from ``flop_registry`` (the formulas ``FlopCounterMode``
    sums)."""

    def __init__(self, kernels: str = "plain"):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes_by_dtype: Dict[str, float] = {}
        self.mac_by_dtype: Dict[str, float] = {}
        self.kernels = kernels
        self.in_kernel = False      # inside a custom_call: products only

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_SYNC or (func in _INDEXING and any(
                isinstance(i, torch.Tensor)
                and i.dtype in (torch.bool, torch.uint8) for i in args[1])):
            raise TraceError(
                f"{func} needs a tensor's data on the host (.item(), "
                ".tolist(), boolean-mask indexing): a stage counted on meta "
                "tensors must not sync")
        if _off_host(kwargs.get("device")):
            raise TraceError(f"{func} makes a tensor on "
                             f"{kwargs['device']}: a traced stage must make "
                             "its tensors on its inputs' device")
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        for t in outs:
            if _off_host(t.device):
                raise TraceError(f"{func} returned a tensor on {t.device}")
        if func.is_view or func in _FREE:
            return out
        if not self.in_kernel:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            for t in ins + outs:
                _add(self.bytes_by_dtype, dtype_label(t.dtype),
                     t.numel() * t.element_size())
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            mac = formula(*args, **kwargs, out_val=out)
            _add(self.mac_by_dtype, dtype_label(outs[0].dtype), mac)
            _add(self.flops_by_dtype, dtype_label(outs[0].dtype), mac)
        elif not self.in_kernel:
            for t in outs:
                _add(self.flops_by_dtype, dtype_label(t.dtype), t.numel())
        return out


# the counting modes of the analyze() calls in progress, innermost last
_ACTIVE: List[_OpCost] = []


def _extents(items) -> List[Tuple[torch.dtype, int]]:
    """(dtype, element count) of each tensor or pair in ``items``; other
    operands (Python scalars, None) move nothing."""
    return [(x.dtype, x.numel()) if isinstance(x, torch.Tensor) else x
            for x in items if isinstance(x, (torch.Tensor, tuple))]


def counting() -> bool:
    """True while :func:`analyze` counts a function: a product then runs
    as its plain ``torch.einsum``, so that a trace on CPU tensors counts
    what one on meta tensors does (``models.common._einsum``'s row
    padding is the CPU's rounding, not the function's work)."""
    return bool(_ACTIVE)


def custom_call(plain: Callable, *args, reads: Iterable = (),
                writes: Optional[Iterable] = None, **kwargs):
    """Run ``plain(*args, **kwargs)``, a kernel wrapper's plain version, and
    return its result.  Under ``analyze(..., kernels="custom_call")`` the
    call counts as its kernel's one launch: the plain version's products
    keep their FLOPs (``mac_flops`` is unchanged), its other ops count
    nothing, and the call adds the bytes of ``reads`` (read once) and of
    ``writes`` (written once; default: the tensors ``plain`` returns) and
    one FLOP per element written.  ``reads`` and ``writes`` hold tensors or
    ``(dtype, element count)`` pairs (anything else, a Python scalar or
    None, is skipped): an in-place kernel names the rows it writes, not the
    buffer they land in."""
    mode = _ACTIVE[-1] if _ACTIVE else None
    if mode is None or mode.kernels != "custom_call" or mode.in_kernel:
        return plain(*args, **kwargs)
    mode.in_kernel = True
    try:
        out = plain(*args, **kwargs)
    finally:
        mode.in_kernel = False
    writes = _extents(tree_flatten(out)[0] if writes is None else writes)
    for dtype, n in _extents(reads) + writes:
        _add(mode.bytes_by_dtype, dtype_label(dtype), n * dtype.itemsize)
    for dtype, n in writes:
        _add(mode.flops_by_dtype, dtype_label(dtype), n)
    return out


def analyze(fn: Callable, spec, grad: bool = False,
            kernels: str = "plain") -> Dict[str, Any]:
    """Run ``fn(*spec)`` once under the counting mode and return the
    reference's ``analyze`` keys (``collective_bytes`` 0: one device).
    ``grad`` keeps autograd on, for a function that differentiates (a
    train step: its backward ops are counted too).  ``kernels``: "plain"
    counts a kernel wrapper's plain version op by op (the reference's
    interpret-mode Pallas bodies); "custom_call" counts it as its one
    launch (:func:`custom_call`)."""
    if kernels not in ("plain", "custom_call"):
        raise ValueError(f"kernels={kernels!r}: 'plain' or 'custom_call'")
    cost = _OpCost(kernels)
    _ACTIVE.append(cost)
    try:
        with torch.set_grad_enabled(grad), cost:
            fn(*spec)
    finally:
        _ACTIVE.pop()
    return {
        "flops": float(sum(cost.flops_by_dtype.values())),
        "mac_flops": float(sum(cost.mac_by_dtype.values())),
        "bytes": float(sum(cost.bytes_by_dtype.values())),
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "bytes_by_dtype": dict(cost.bytes_by_dtype),
        "collective_bytes": 0.0,
        "collectives": {},
    }


def entry_param_bytes_by_dtype(spec) -> Dict[str, float]:
    """Bytes of the spec's tensor leaves, split by dtype: the stage's entry
    parameters.  Python scalars count nothing (the reference's static
    arguments)."""
    out: Dict[str, float] = {}
    for leaf in tree_flatten(spec)[0]:
        if isinstance(leaf, torch.Tensor):
            _add(out, dtype_label(leaf.dtype),
                 leaf.numel() * leaf.element_size())
    return out
