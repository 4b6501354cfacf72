"""Dry run of every (arch x shape x mesh) cell on the meta device: prove it
fits and extract the roofline terms (port of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
        --shape train_4k --mesh pod1 --out build/dryrun

The reference lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads its FLOPs and bytes from the compiled HLO and its
argument and temp bytes from ``memory_analysis``.  The port has no
compiler, so each number comes from another source, named in the report:

* **Model FLOPs** (``active_params``, ``model_flops``): the reference's
  rules over ``lm.init_params(cfg, device="meta")``.
* **Argument bytes per device** (``argument_bytes``): each leaf of the
  params (packed under ``Variant.packed``), the optimizer state (train),
  the batch and the cache, its shard's bytes under the spec trees of
  ``launch/mesh.py`` and ``train.step.state_specs`` (each dim divided,
  rounded up, by the mesh axes its spec names).  No compiler gives temp
  bytes: the report says so rather than writing 0, and ``fits_hbm``
  weighs the arguments alone.
* **The step's FLOPs and bytes** (``step_cost``): ``launch/op_cost``'s
  count of the train step, ``prefill`` or ``decode_step`` run once on meta
  tensors at the cell's global shape (bytes: each op's inputs and outputs,
  unfused; a kernel wrapper's call, K1-K7 under a posit KV format or
  packed weights, counts as its one launch: operands read once, the rows
  it writes written once, its products' FLOPs, as ``hlo_cost`` counts a
  custom call, and not as its plain version's ops).  A stack deeper than two periods is traced at one and two
  periods (and encoder layers) and extrapolated linearly, as the
  reference's ``hlo_cost`` multiplies a scan body by its trip count; the
  report says which.  Per-device figures are the global counts split
  evenly over the mesh, labelled so.
* **Collectives are not counted**: the port has no partitioner that
  inserts them.  The collective terms are null, and ``dominant`` is chosen
  between compute and memory.

The hardware constants are one NVIDIA H100 SXM card's.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, ShapeSpec, get_config, shape_applicable
from ..core.quant import QuantizedTensor
from ..core.transprecision import TCPolicy, get_policy, pack_params
from ..models import lm
from ..models.common import P, map_with_path
from ..models.lm import ModelCfg
from ..models.serve_model import decode_step, prefill
from ..optim import AdamWConfig
from ..train.step import init_train_state, make_train_step, state_specs
from . import mesh as mesh_lib
from .op_cost import analyze
from .specs import decode_specs, input_specs

# NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense rates)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s, NVIDIA H100 SXM
HBM_BW = 3.35e12             # bytes/s, NVIDIA H100 SXM HBM3
HBM_CAP = 80e9               # bytes, NVIDIA H100 80GB


# ---------------------------------------------------------------------------
# Model-FLOPs accounting (6ND / 2ND with MoE active-param scaling)
# ---------------------------------------------------------------------------

def active_params(cfg: ModelCfg) -> Dict[str, float]:
    """Total and active parameter counts: an MoE expert's ``wi``/``wo``
    counts ``moe_topk / moe_experts`` of its size."""
    total = active = 0.0

    def count(path: str, leaf) -> None:
        nonlocal total, active
        n = float(math.prod(leaf.shape))
        total += n
        if "moe" in path and path.split("/")[-1] in ("wi", "wo"):
            active += n * cfg.moe_topk / cfg.moe_experts
        else:
            active += n

    map_with_path(count, lm.init_params(cfg, None, device="meta"))
    return {"total": total, "active": active}


def model_flops(cfg: ModelCfg, kind: str, batch: int, seq: int,
                n_active: float) -> float:
    tokens = batch * (seq if kind in ("train", "prefill") else 1)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Variant:
    """Hillclimb knobs (defaults = baseline), the reference's that act on
    the port.  Its ``scan_layers`` (the port's stacks always run layer by
    layer) and ``distributed_decode`` (a combine of collectives, which
    this dry run does not count) have no counterpart."""
    policy: str = "bf16"
    seq_shard: bool = True          # sequence-parallel residual stream
    heads_shard: bool = True        # shard attention heads on "model"
    remat: Optional[str] = None     # override cfg.remat
    q_block: Optional[int] = None
    kv_block: Optional[int] = None
    attn_vjp: Optional[str] = None    # flash | naive
    packed: bool = False              # posit-packed weights (serving)

    def apply(self, cfg: ModelCfg) -> ModelCfg:
        kw = {}
        if self.remat is not None:
            kw["remat"] = self.remat
        if self.q_block:
            kw["q_block"] = self.q_block
        if self.kv_block:
            kw["kv_block"] = self.kv_block
        if self.attn_vjp:
            kw["attn_vjp"] = self.attn_vjp
        return dataclasses.replace(cfg, **kw) if kw else cfg


def _rules(mesh, spec: ShapeSpec, variant: Variant) -> Dict[str, Any]:
    if spec.kind == "train":
        return mesh_lib.train_rules(mesh, global_batch=spec.global_batch,
                                    seq_shard=variant.seq_shard,
                                    heads_shard=variant.heads_shard)
    return mesh_lib.serve_rules(mesh, global_batch=spec.global_batch)


def _shard_bytes(t: torch.Tensor, spec: P, sizes: Dict[str, int]) -> int:
    """Bytes of one device's shard of ``t`` under ``spec``."""
    shape = list(t.shape)
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else (entry,)
        k = math.prod(sizes[a] for a in names if a is not None)
        shape[d] = -(-shape[d] // k)
    return math.prod(shape) * t.element_size()


def tree_shard_bytes(tree, specs, mesh) -> int:
    """Sum of one device's shard bytes over a tree and its spec tree (a
    packed weight's codes and scale under its one spec)."""
    spec_at: Dict[str, P] = {}
    map_with_path(spec_at.__setitem__, specs)
    total = 0

    def one(path: str, leaf) -> None:
        nonlocal total
        parts = ((leaf.data, leaf.scale) if isinstance(leaf, QuantizedTensor)
                 else (leaf,))
        for t in parts:
            if isinstance(t, torch.Tensor):
                total += _shard_bytes(t, spec_at[path], mesh.shape)

    map_with_path(one, tree)
    return total


def _serve_params(cfg: ModelCfg, policy: TCPolicy, variant: Variant):
    params = lm.init_params(cfg, None, device="meta")
    if variant.packed:
        params = pack_params(params, policy)    # decode-on-load weights
    return params


def argument_bytes(cfg: ModelCfg, spec: ShapeSpec, mesh,
                   policy: TCPolicy, variant: Variant = Variant()
                   ) -> Dict[str, int]:
    """One device's argument bytes for the cell, by part (``params``,
    ``opt`` and ``ef_residual`` for train, ``batch``, ``cache``) and in
    all (``total``), reckoned from the spec trees over ``mesh`` (a
    ``launch.mesh.MeshShape``)."""
    rules = _rules(mesh, spec, variant)
    out: Dict[str, int] = {}
    if spec.kind == "train":
        state = init_train_state(cfg, AdamWConfig(), policy, device="meta")
        sspecs = state_specs(
            cfg, mesh_lib.param_specs(state.params, fsdp="data"), policy)
        out["params"] = tree_shard_bytes(state.params, sspecs.params, mesh)
        out["opt"] = tree_shard_bytes(state.opt, sspecs.opt, mesh)
        if state.ef_residual is not None:
            out["ef_residual"] = tree_shard_bytes(
                state.ef_residual, sspecs.ef_residual, mesh)
        batch = input_specs(cfg, spec)
        out["batch"] = tree_shard_bytes(
            batch, mesh_lib.batch_specs(cfg, rules), mesh)
        return _total(out)
    params = _serve_params(cfg, policy, variant)
    out["params"] = tree_shard_bytes(
        params, mesh_lib.param_specs(params, fsdp=None), mesh)
    if spec.kind == "prefill":
        batch = input_specs(cfg, spec)
        out["batch"] = tree_shard_bytes(
            batch, mesh_lib.batch_specs(cfg, rules, keys=set(batch)), mesh)
    else:
        cache, tok = decode_specs(cfg, spec, policy)
        out["cache"] = tree_shard_bytes(
            cache, mesh_lib.cache_specs(cache, cfg, rules), mesh)
        tok_spec = P(rules.get("batch"), *([None] * (tok.ndim - 1)))
        out["batch"] = tree_shard_bytes(tok, tok_spec, mesh)
    return _total(out)


def _total(parts: Dict[str, int]) -> Dict[str, int]:
    return {**parts, "total": sum(parts.values())}


def _depth_knobs(cfg: ModelCfg) -> Dict[str, tuple]:
    """field -> (unit, full count of units): the repeated parts of the
    stack, each traced at one and two units."""
    per = len(cfg.period)
    knobs = {"n_layers": (per, cfg.n_periods)}
    if cfg.enc_layers:
        knobs["enc_layers"] = (1, cfg.enc_layers)
    return knobs


def _cut(cfg: ModelCfg, units: Dict[str, int]) -> ModelCfg:
    kw = {f: unit * units[f] for f, (unit, _) in _depth_knobs(cfg).items()}
    kw["n_layers"] += cfg.n_tail
    return dataclasses.replace(cfg, **kw)


def _trace(cfg: ModelCfg, spec: ShapeSpec, policy: TCPolicy,
           variant: Variant) -> Dict[str, Any]:
    """op_cost of the cell's step at ``cfg``'s depth, on meta tensors."""
    if spec.kind == "train":
        state = init_train_state(cfg, AdamWConfig(), policy, device="meta")
        step = make_train_step(cfg, AdamWConfig(), policy)
        return analyze(step, (state, input_specs(cfg, spec)), grad=True,
                       kernels="custom_call")
    params = _serve_params(cfg, policy, variant)
    if spec.kind == "prefill":
        return analyze(lambda p, b: prefill(p, b, cfg, spec.seq_len, policy),
                       (params, input_specs(cfg, spec)),
                       kernels="custom_call")
    cache, tok = decode_specs(cfg, spec, policy)
    if cfg.family == "vlm":
        return analyze(lambda p, c, t: decode_step(p, c, None, cfg, policy,
                                                   embeds=t),
                       (params, cache, tok), kernels="custom_call")
    return analyze(lambda p, c, t: decode_step(p, c, t, cfg, policy),
                   (params, cache, tok), kernels="custom_call")


_SUMMED = ("flops", "mac_flops", "bytes")
_BY_DTYPE = ("flops_by_dtype", "bytes_by_dtype")


def step_cost(cfg: ModelCfg, spec: ShapeSpec, policy: TCPolicy,
              variant: Variant = Variant()) -> Dict[str, Any]:
    """Global FLOPs and bytes of the cell's step (``op_cost``'s keys, no
    collectives) and ``depth``: "full" where every unit of the stack was
    traced, else how it was extrapolated."""
    knobs = _depth_knobs(cfg)
    if all(full <= 2 for _, full in knobs.values()):
        cost = _trace(cfg, spec, policy, variant)
        cost["depth"] = "full"
        return cost
    ones = {f: 1 for f in knobs}
    base = _trace(_cut(cfg, ones), spec, policy, variant)
    cost = {k: base[k] for k in _SUMMED}
    cost.update({k: dict(base[k]) for k in _BY_DTYPE})
    for f, (unit, full) in knobs.items():
        two = _trace(_cut(cfg, {**ones, f: 2}), spec, policy, variant)
        for k in _SUMMED:
            cost[k] += (full - 1) * (two[k] - base[k])
        for k in _BY_DTYPE:
            for dt in set(two[k]) | set(base[k]):
                cost[k][dt] = cost[k].get(dt, 0.0) + (full - 1) * (
                    two[k].get(dt, 0.0) - base[k].get(dt, 0.0))
    units = ", ".join(f"{f} ({unit} layers a unit, {full} units)"
                      for f, (unit, full) in knobs.items())
    tail = f"; {cfg.n_tail} tail layers in every trace" if cfg.n_tail else ""
    cost["depth"] = ("extrapolated linearly from traces at one and two "
                     f"units of {units}{tail}")
    return cost


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.sizes)


def lower_cell(arch: str, shape: str, multi_pod: bool = False,
               variant: Variant = Variant(), *, mesh=None,
               policy: Optional[TCPolicy] = None) -> Dict[str, Any]:
    """Reckon one (arch x shape x mesh) cell; return the report dict.
    ``mesh`` (a ``MeshShape``) overrides the production mesh;
    ``policy`` overrides ``variant.policy``."""
    cfg = variant.apply(get_config(arch))
    spec = SHAPES[shape]
    policy = policy or get_policy(variant.policy)
    mesh = mesh or mesh_lib.make_production_mesh(multi_pod=multi_pod)
    n_chips = math.prod(mesh.sizes)
    t0 = time.time()
    args = argument_bytes(cfg, spec, mesh, policy, variant)
    t_reckon = time.time() - t0
    cost = step_cost(cfg, spec, policy, variant)
    t_trace = time.time() - t0 - t_reckon
    np_info = active_params(cfg)

    flops = cost["flops"] / n_chips
    bytes_acc = cost["bytes"] / n_chips
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    dominant = "compute" if t_compute >= t_memory else "memory"
    mf = model_flops(cfg, spec.kind, spec.global_batch, spec.seq_len,
                     np_info["active"])
    mf_per_dev = mf / n_chips
    t_max = max(t_compute, t_memory)
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name(mesh),
        "n_chips": n_chips, "kind": spec.kind,
        "variant": dataclasses.asdict(variant), "policy": policy.name,
        "params_total": np_info["total"], "params_active": np_info["active"],
        "op_cost": {"flops": cost["flops"], "mac_flops": cost["mac_flops"],
                    "bytes": cost["bytes"],
                    "flops_by_dtype": cost["flops_by_dtype"],
                    "bytes_by_dtype": cost["bytes_by_dtype"],
                    "collectives": None, "scope": "global",
                    "depth": cost["depth"],
                    "source": "launch/op_cost on meta tensors at the "
                              "cell's global shape; bytes unfused; each "
                              "kernel call counted as one launch"},
        "memory_analysis": {
            "argument_size_in_bytes": args["total"],
            "argument_bytes_by_part": {k: v for k, v in args.items()
                                       if k != "total"},
            "temp_size_in_bytes": None,
            "source": "reckoned per device from the spec trees; no "
                      "compiler gives temp bytes"},
        "collectives_single_instance": None,
        "hlo_ops": None,
        "roofline": {
            "per_device": "global counts split evenly over the mesh",
            "flops_per_device": flops,
            "hbm_bytes_per_device": bytes_acc,
            "collective_bytes_per_device": None,
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": None, "dominant": dominant,
            "model_flops_global": mf,
            "model_flops_per_device": mf_per_dev,
            "useful_flops_ratio": (mf_per_dev / flops) if flops else 0.0,
            "roofline_fraction": ((mf_per_dev / PEAK_FLOPS) / t_max
                                  if t_max > 0 else 0.0),
        },
        "fits_hbm": args["total"] <= HBM_CAP,
        "fits_hbm_counts": "arguments only (no temp bytes)",
        "timings": {"reckon_s": t_reckon, "trace_s": t_trace},
    }


def _mesh_of(args):
    if args.mesh == "host":
        return mesh_lib.make_host_mesh(args.world)
    return mesh_lib.make_production_mesh(multi_pod=args.mesh == "pod2")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2",
                                                       "host"])
    ap.add_argument("--world", type=int, default=1,
                    help="cards of the host mesh (--mesh host)")
    ap.add_argument("--policy", default="bf16")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--no-heads-shard", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--q-block", type=int, default=0)
    ap.add_argument("--kv-block", type=int, default=0)
    ap.add_argument("--attn-vjp", default=None, choices=["flash", "naive"])
    ap.add_argument("--packed", action="store_true",
                    help="posit-packed weights for serve cells")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    ok, why = shape_applicable(args.arch, args.shape)
    mesh_label = args.mesh + (str(args.world) if args.mesh == "host"
                              else "")
    name = f"{args.arch}_{args.shape}_{mesh_label}" + (
        f"_{args.tag}" if args.tag else "")
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, name + ".json")
    if not ok:
        with open(path, "w") as f:
            json.dump({"arch": args.arch, "shape": args.shape,
                       "mesh": mesh_label, "skipped": True, "reason": why},
                      f, indent=1)
        print(f"SKIP {name}: {why}")
        return None

    variant = Variant(
        policy=args.policy, seq_shard=not args.no_seq_shard,
        heads_shard=not args.no_heads_shard, remat=args.remat,
        q_block=args.q_block, kv_block=args.kv_block,
        attn_vjp=args.attn_vjp, packed=args.packed)
    report = lower_cell(args.arch, args.shape, variant=variant,
                        mesh=_mesh_of(args))
    report["tag"] = args.tag
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    r = report["roofline"]
    print(f"OK {name}: dominant={r['dominant']} "
          f"compute={r['t_compute_s']:.4f}s memory={r['t_memory_s']:.4f}s "
          f"frac={r['roofline_fraction']:.3f} "
          f"args={report['memory_analysis']['argument_size_in_bytes']} B "
          f"fits={report['fits_hbm']} "
          f"trace={report['timings']['trace_s']:.0f}s")
    return report


if __name__ == "__main__":
    main()
