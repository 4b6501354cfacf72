"""Energy-per-token accounting for the serving engine stages (port of
``repro.obs.energy``).

The paper's headline claims are energy numbers, so the serving telemetry
reports joules per token next to tokens/s.  It is a **model**, not a
measurement of the card: the TALU's per-MAC PDP (paper Table IV) and a
DRAM constant, applied to counts of each stage's work.

1. **Static pJ-per-invocation table.**  Every engine stage (prefill /
   insert / generate / verify / rollback, plus the ``draft.`` speculative
   stages) records its first call's arguments as meta tensors in
   ``TransprecisionEngine.stage_specs``.  The accountant re-runs the stage
   on them under the op counter (:mod:`repro_torch.launch.op_cost`; the
   reference re-lowers and parses HLO) and prices:

   * **compute** — MACs (``mac_flops`` / 2) times a per-MAC PDP
     (:func:`pj_per_mac`: 38.9 / 43.44 / 46.15 pJ at 8 / 16 / 32 bits),
     weighted by the stage's *format mix*: the share of MAC work each
     weight role's format carries, estimated from the weight leaves'
     element counts in the spec.  Vector ops are not priced;
   * **memory** — the stage's entry bytes (weights + decode state +
     inputs, one fetch per call) times :data:`DRAM_PJ_PER_BYTE`, with the
     weights re-priced at their policy storage width
     (``core.transprecision.hbm_bytes_per_param``): the engine serves
     float weights, the modeled edge device stores them packed.  Posit KV
     codes are ``u8`` / ``u16`` inputs and count at their true width;
     int64 index inputs (tokens, rows, positions) count at 32 bits, the
     reference's integer width.
     The op counter's unfused bytes are reported (``hbm_bytes``), never
     priced.

   The weight formats come from the engine's ``weight_policy`` (the
   drivers hoist weight quantization and serve through a policy with the
   weight roles cleared).

2. **Live multipliers.**  The metrics registry counts every stage call
   (``stage.<name>.calls``); joules are the table times those counters,
   so a window's reading is a counter delta.

The table is deterministic (same config, policy and shapes, same counts)
and memoized process-wide, so a sweep counts each distinct stage once.
The constants are this package's own copy of ``benchmarks/hwmodel.py``'s
(a test pins them together).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten

from ..core.transprecision import _ROLE_BY_NAME, hbm_bytes_per_param
from ..launch.op_cost import analyze, dtype_label, entry_param_bytes_by_dtype

__all__ = ["DRAM_PJ_PER_BYTE", "StageEnergy", "EnergyAccountant",
           "format_energy", "pj_per_mac"]

DRAM_PJ_PER_BYTE = 20.0
_TALU_PDP_PJ = (38.9, 43.44, 46.15)     # paper Table IV, 8 / 16 / 32 bit


def pj_per_mac(bits: int) -> float:
    """The TALU's energy per MAC (PDP) at an operand width."""
    return _TALU_PDP_PJ[0 if bits <= 8 else 1 if bits <= 16 else 2]


# weight-leaf name -> policy role, with the embedding and readout leaves
# (they burn MACs in the logits product, at the embed_weights format)
_ENERGY_ROLE_BY_NAME = dict(_ROLE_BY_NAME,
                            embed="embed_weights", lm_head="embed_weights")


@dataclasses.dataclass
class StageEnergy:
    """Static per-invocation energy of one engine stage."""
    stage: str
    flops: float                # all counted FLOPs
    mac_flops: float            # the products' share: the priced MACs
    hbm_bytes: float            # unfused op traffic (reference)
    model_bytes: float          # DRAM-priced: entry bytes, packed weights
    bytes_by_dtype: Dict[str, float]
    param_bytes_by_dtype: Dict[str, float]
    mac_mix: Dict[str, Dict[str, float]]   # fmt -> {bits, frac}
    pj_compute: float
    pj_memory: float

    @property
    def pj_total(self) -> float:
        return self.pj_compute + self.pj_memory

    def as_dict(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "mac_flops": self.mac_flops,
            "hbm_bytes": self.hbm_bytes,
            "model_bytes": self.model_bytes,
            "bytes_by_dtype": {k: v for k, v in
                               sorted(self.bytes_by_dtype.items())},
            "mac_mix": {k: {"bits": int(v["bits"]),
                            "frac": round(v["frac"], 4)}
                        for k, v in sorted(self.mac_mix.items())},
            "pj_compute": self.pj_compute,
            "pj_memory": self.pj_memory,
            "pj_per_call": self.pj_total,
        }


def _index_width(by_dtype: Dict[str, float]) -> Dict[str, float]:
    """Entry bytes by dtype with the int64 index leaves counted as
    int32: torch indexes with int64, the reference (JAX's default
    integers) and the modeled device with 32-bit integers."""
    out = dict(by_dtype)
    s64 = out.pop("s64", 0.0)
    if s64:
        out["s32"] = out.get("s32", 0.0) + s64 / 2
    return out


def _weights(tree, name=None):
    """(role, tensor) of every weight leaf of ``tree``: a tensor of rank >=
    2 whose nearest dict key names a role."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _weights(v, k)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _weights(v, name)
    elif isinstance(tree, torch.Tensor) and tree.ndim >= 2:
        role = _ENERGY_ROLE_BY_NAME.get(name)
        if role is not None:
            yield role, tree


def _weight_info(spec, policy) -> Tuple[Dict[str, Dict[str, float]],
                                        float, float]:
    """(mac_mix, full_weight_bytes, packed_weight_bytes) from a stage's
    spec: weight leaves classified by name -> policy role -> format; MAC
    share per format estimated by element count."""
    by_fmt: Dict[str, Dict[str, float]] = {}
    w_full = w_packed = 0.0
    total_elems = 0.0
    for role, leaf in _weights(spec):
        elems = float(leaf.numel())
        itemsize = leaf.element_size()
        per_param = hbm_bytes_per_param(policy, role, default=itemsize)
        bits = per_param * 8
        label = policy.fmt_for(role) or dtype_label(leaf.dtype)
        rec = by_fmt.setdefault(label, {"bits": float(bits), "elems": 0.0})
        rec["elems"] += elems
        total_elems += elems
        w_full += elems * itemsize
        w_packed += elems * per_param
    mix = {label: {"bits": rec["bits"],
                   "frac": rec["elems"] / max(total_elems, 1.0)}
           for label, rec in by_fmt.items()}
    return mix, w_full, w_packed


# process-wide memo of the counting half (the meta trace), keyed by
# everything that determines the stage's work
_COST_CACHE: Dict[str, Dict[str, Any]] = {}


def _leaf_sig(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"{leaf.dtype}/{tuple(leaf.shape)}"
    return repr(leaf)


def _spec_key(cfg, policy, stage: str, spec) -> str:
    leaves, treedef = tree_flatten(spec)
    sig = ";".join(_leaf_sig(leaf) for leaf in leaves)
    return f"{cfg!r}|{policy!r}|{stage}|{treedef}|{sig}"


def _stage_cost(cfg, policy, stage: str, fn, spec) -> Dict[str, Any]:
    key = _spec_key(cfg, policy, stage, spec)
    cached = _COST_CACHE.get(key)
    if cached is None:
        cached = _COST_CACHE[key] = {
            "analysis": analyze(fn, spec),
            "param_bytes": _index_width(entry_param_bytes_by_dtype(spec))}
    return cached


class EnergyAccountant:
    """Joules accounting over a serving driver's engine stages.

    ``driver`` is a ``ServingEngine`` / ``SpeculativeEngine`` (stages found
    via ``.engine`` and ``.draft_engine``) or a bare
    ``TransprecisionEngine``.  The pJ table is built lazily on first use
    from whatever stages have run by then; per-window joules come from
    ``calls_snapshot()`` deltas.  Pricing runs no kernel and touches no
    device memory."""

    def __init__(self, driver, *,
                 dram_pj_per_byte: float = DRAM_PJ_PER_BYTE):
        self.driver = driver
        self.metrics = getattr(driver, "metrics", None)
        self.dram_pj_per_byte = float(dram_pj_per_byte)
        self._table: Dict[str, StageEnergy] = {}
        self._errors: Dict[str, str] = {}

    def _engines(self) -> List[Any]:
        if hasattr(self.driver, "stage_specs"):
            return [self.driver]
        out = [self.driver.engine]
        draft = getattr(self.driver, "draft_engine", None)
        if draft is not None:
            out.append(draft)
        return out

    # ---- static table ----
    def table(self) -> Dict[str, StageEnergy]:
        """pJ-per-invocation per stage name (lazily built, memoized)."""
        for eng in self._engines():
            for name, (fn, spec) in list(eng.stage_specs.items()):
                if name in self._table or name in self._errors:
                    continue
                try:
                    self._table[name] = self._price_stage(eng, name, fn,
                                                          spec)
                except Exception as e:   # never fail serving over a cost
                    self._errors[name] = f"{type(e).__name__}: {e}"
        return self._table

    def _price_stage(self, eng, name: str, fn, spec) -> StageEnergy:
        cost = _stage_cost(eng.cfg, eng.policy, name, fn, spec)
        ana = cost["analysis"]
        flops, hbm = float(ana["flops"]), float(ana["bytes"])
        macs = float(ana["mac_flops"]) / 2.0
        mix, w_full, w_packed = _weight_info(
            spec, getattr(eng, "weight_policy", eng.policy))
        if mix:
            pj_mac = sum(v["frac"] * pj_per_mac(int(v["bits"]))
                         for v in mix.values())
        else:                       # no MAC weights (insert/rollback):
            pj_mac = pj_per_mac(32)  # stray MACs priced at full width
        # DRAM-priced traffic: one fetch of every entry parameter per call,
        # the weights re-priced at the policy's packed storage width;
        # floored at the packed bytes so the adjustment never goes negative
        param_bytes = float(sum(cost["param_bytes"].values()))
        model_bytes = (max(param_bytes - w_full + w_packed, w_packed)
                       if w_full > 0 else param_bytes)
        return StageEnergy(
            stage=name, flops=flops, mac_flops=float(ana["mac_flops"]),
            hbm_bytes=hbm, model_bytes=model_bytes,
            bytes_by_dtype=dict(ana["bytes_by_dtype"]),
            param_bytes_by_dtype=dict(cost["param_bytes"]),
            mac_mix=mix,
            pj_compute=macs * pj_mac,
            pj_memory=model_bytes * self.dram_pj_per_byte)

    # ---- live multipliers ----
    def calls_snapshot(self) -> Dict[str, int]:
        """Current per-stage invocation counts from the registry."""
        if self.metrics is None:
            return {}
        counters = self.metrics.snapshot()["counters"]
        out = {}
        for cname, v in counters.items():
            if cname.startswith("stage.") and cname.endswith(".calls"):
                out[cname[len("stage."):-len(".calls")]] = int(v)
        return out

    @staticmethod
    def calls_delta(now: Dict[str, int],
                    before: Dict[str, int]) -> Dict[str, int]:
        return {k: v - before.get(k, 0) for k, v in now.items()
                if v - before.get(k, 0) > 0}

    def _tokens_now(self) -> int:
        if self.metrics is None:
            return 0
        return int(self.metrics.snapshot()["counters"]
                   .get("engine.tokens", 0))

    # ---- joules ----
    def breakdown(self, *, calls: Optional[Dict[str, int]] = None,
                  tokens: Optional[int] = None) -> Dict[str, Any]:
        """Joules attribution: cumulative by default, windowed when
        ``calls`` (a :meth:`calls_delta`) and ``tokens`` are given.
        Cumulative calls also publish ``energy.joules_total`` /
        ``energy.joules_per_token`` gauges to the registry."""
        cumulative = calls is None
        if calls is None:
            calls = self.calls_snapshot()
        if tokens is None:
            tokens = self._tokens_now()
        table = self.table()
        stages: Dict[str, Any] = {}
        joules = 0.0
        for name, e in sorted(table.items()):
            n = int(calls.get(name, 0))
            j = n * e.pj_total * 1e-12
            joules += j
            stages[name] = {**e.as_dict(), "calls": n, "joules": j}
        jpt = joules / tokens if tokens else None
        out = {"joules_total": joules,
               "tokens": int(tokens),
               "joules_per_token": jpt,
               "tok_per_joule": tokens / joules if joules > 0 else None,
               "model": {"mac_pdp": "TALU Table IV "
                                    "(repro_torch.obs.energy.pj_per_mac)",
                         "dram_pj_per_byte": self.dram_pj_per_byte},
               "stages": stages}
        if self._errors:
            out["errors"] = dict(self._errors)
        if cumulative and self.metrics is not None:
            self.metrics.gauge("energy.joules_total").set(joules)
            if jpt is not None:
                self.metrics.gauge("energy.joules_per_token").set(jpt)
        return out


def format_energy(bd: Dict[str, Any]) -> str:
    """Human-readable table of a :meth:`EnergyAccountant.breakdown`."""
    lines = []
    jpt = bd["joules_per_token"]
    tpj = bd["tok_per_joule"]
    head = (f"energy (modeled: TALU Table IV, "
            f"{bd['model']['dram_pj_per_byte']:g} pJ/B DRAM): "
            f"{bd['joules_total'] * 1e3:.3f} mJ over {bd['tokens']} tokens")
    if jpt is not None:
        head += f" -> {jpt * 1e6:.1f} uJ/token ({tpj:.0f} tok/J)"
    lines.append(head)
    lines.append(f"  {'stage':<16s} {'calls':>7s} {'uJ/call':>9s} "
                 f"{'compute%':>9s}  mac mix")
    for name, s in bd["stages"].items():
        tot = s["pj_per_call"]
        comp = 100.0 * s["pj_compute"] / tot if tot else 0.0
        mix = " ".join(f"{k}:{v['frac']:.2f}"
                       for k, v in s["mac_mix"].items()) or "-"
        lines.append(f"  {name:<16s} {s['calls']:>7d} "
                     f"{tot * 1e-6:>9.2f} {comp:>8.1f}%  {mix}")
    for name, err in bd.get("errors", {}).items():
        lines.append(f"  {name:<16s} (not priced: {err})")
    return "\n".join(lines)
