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
  rounded up, by the mesh axes its spec names); under
  ``Variant.distributed_decode`` on a decode cell the params are whole on
  every rank, as that step's ranks hold them.  No compiler gives temp
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
* **Collectives** are counted under ``Variant.distributed_decode`` on a
  decode cell (``--distributed-decode``, the reference's knob): the step
  is then one rank's ``serve.distributed.make_distributed_decode_step``,
  traced on the meta device at the rank-local shapes (the batch cut over
  the data axes; the KV rows and the recurrent state's "model" dims cut
  over the "model" axis: 16 on ``pod1`` / ``pod2``, ``--world`` ranks on
  ``--mesh host``), and a stand-in behind ``serve.distributed``'s one
  collective door counts each collective that rank issues, with no
  process group: two all-reduces an attention layer, two all-gathers a
  Mamba-2 or RG-LRU layer.  The counts fill the reference's keys
  (``per_kind``: ``count``, ``result_bytes``, ``operand_bytes``), and
  ``t_collective_s`` is the result bytes over one direction of the
  card's NVLink, a reckoned figure; the FLOPs and bytes are then that
  rank's own.  Every other cell has no partitioner that inserts
  collectives: its collective terms are null, and ``dominant`` is chosen
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
from ..models.serve_model import decode_step, init_cache, prefill
from ..optim import AdamWConfig
from ..serve import distributed
from ..train.step import init_train_state, make_train_step, state_specs
from . import mesh as mesh_lib
from .op_cost import analyze
from .specs import decode_specs, input_specs

# NVIDIA H100 SXM (per card; NVIDIA's data sheet, dense rates)
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s, NVIDIA H100 SXM
HBM_BW = 3.35e12             # bytes/s, NVIDIA H100 SXM HBM3
HBM_CAP = 80e9               # bytes, NVIDIA H100 80GB
# bytes/s one way over NVLink 4, NVIDIA H100 SXM (NVIDIA's data sheet: 900
# GB/s bidirectional); the collective term is reckoned from it
NVLINK_BW = 450e9
# the reference's collective kinds (its ``parse_collectives``)
COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")


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
    the port.  Its ``scan_layers`` has no counterpart: the port's stacks
    run layer by layer in eager torch, with no compiled loop to roll."""
    policy: str = "bf16"
    seq_shard: bool = True          # sequence-parallel residual stream
    heads_shard: bool = True        # shard attention heads on "model"
    remat: Optional[str] = None     # override cfg.remat
    distributed_decode: bool = False  # one rank's distributed decode step
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
    ``launch.mesh.MeshShape``); under ``variant.distributed_decode`` on a
    decode cell the params are whole on every rank, as its ranks hold
    them."""
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
    pspecs = mesh_lib.param_specs(params, fsdp=None)
    if variant.distributed_decode and spec.kind == "decode":
        # the distributed decode's ranks hold every weight whole: the port
        # has no tensor-parallel weights
        pspecs = map_with_path(lambda _path, _spec: P(), pspecs)
    out["params"] = tree_shard_bytes(params, pspecs, mesh)
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


def _rank_trace(cfg: ModelCfg, spec: ShapeSpec, policy: TCPolicy,
                variant: Variant, mesh) -> Dict[str, Any]:
    """op_cost of one rank's ``make_distributed_decode_step`` on meta
    tensors at the rank-local shapes (the batch cut over the data axes
    where ``serve_rules`` shards it; the split dims of
    ``init_cache(..., kv_shard=)`` over the mesh's "model" axis), and the
    collectives that rank issues, by kind, the communication standing
    in."""
    rules = mesh_lib.serve_rules(mesh, global_batch=spec.global_batch)
    batch = spec.global_batch // math.prod(
        mesh.shape[a] for a in rules["batch"] or ())
    shard = distributed.KVShard(rank=0, world=mesh.shape["model"],
                                collective=True)
    cache = init_cache(cfg, batch, spec.seq_len, policy=policy,
                       device="meta", kv_shard=shard)
    _, tok = decode_specs(cfg, dataclasses.replace(spec, global_batch=batch),
                          policy)
    step = distributed.make_distributed_decode_step(cfg, policy)
    step.attn_impl.shard = shard        # a rank with no process group
    with distributed.stand_in_collectives() as seen:
        cost = analyze(step, (_serve_params(cfg, policy, variant), cache,
                              tok), kernels="custom_call")
    return {**cost, "collectives": {k: dict(v) for k, v in seen.items()}}


def _trace(cfg: ModelCfg, spec: ShapeSpec, policy: TCPolicy,
           variant: Variant, mesh=None) -> Dict[str, Any]:
    """op_cost of the cell's step at ``cfg``'s depth, on meta tensors;
    under ``variant.distributed_decode`` (a decode cell) one rank's step
    over ``mesh``, with its ``collectives``."""
    if spec.kind == "decode" and variant.distributed_decode:
        return _rank_trace(cfg, spec, policy, variant, mesh)
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
              variant: Variant = Variant(), mesh=None) -> Dict[str, Any]:
    """FLOPs and bytes of the cell's step (``op_cost``'s keys): global, or
    one rank's with its ``collectives`` by kind under
    ``variant.distributed_decode`` on a decode cell over ``mesh``; and
    ``depth``: "full" where every unit of the stack was traced, else how
    it was extrapolated (the collectives alike)."""
    knobs = _depth_knobs(cfg)
    if all(full <= 2 for _, full in knobs.values()):
        cost = _trace(cfg, spec, policy, variant, mesh)
        cost["depth"] = "full"
        return cost
    ones = {f: 1 for f in knobs}
    base = _trace(_cut(cfg, ones), spec, policy, variant, mesh)
    cost = {k: base[k] for k in _SUMMED}
    cost.update({k: dict(base[k]) for k in _BY_DTYPE})
    cost["collectives"] = {k: dict(v)
                           for k, v in base["collectives"].items()}
    for f, (unit, full) in knobs.items():
        two = _trace(_cut(cfg, {**ones, f: 2}), spec, policy, variant, mesh)
        for k in _SUMMED:
            cost[k] += (full - 1) * (two[k] - base[k])
        for k in _BY_DTYPE:
            for dt in set(two[k]) | set(base[k]):
                cost[k][dt] = cost[k].get(dt, 0.0) + (full - 1) * (
                    two[k].get(dt, 0.0) - base[k].get(dt, 0.0))
        for kind, rec in cost["collectives"].items():
            for key in rec:
                rec[key] += (full - 1) * (two["collectives"][kind][key]
                                          - base["collectives"][kind][key])
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
    cost = step_cost(cfg, spec, policy, variant, mesh)
    t_trace = time.time() - t0 - t_reckon
    np_info = active_params(cfg)

    # one rank's step under the distributed decode: per device already
    rank = variant.distributed_decode and spec.kind == "decode"
    flops = cost["flops"] / (1 if rank else n_chips)
    bytes_acc = cost["bytes"] / (1 if rank else n_chips)
    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_acc / HBM_BW
    coll = coll_bytes = t_coll = None
    terms = {"compute": t_compute, "memory": t_memory}
    if rank:
        per_kind = {k: cost["collectives"].get(
            k, {"count": 0, "result_bytes": 0, "operand_bytes": 0})
            for k in COLL_KINDS}
        coll = {"per_kind": per_kind,
                "result_bytes": sum(v["result_bytes"]
                                    for v in per_kind.values()),
                "operand_bytes": sum(v["operand_bytes"]
                                     for v in per_kind.values()),
                "source": "counted per decode step from one rank's trace "
                          "of the port's step, the collectives standing "
                          "in; " + cost["depth"]}
        coll_bytes = float(coll["result_bytes"])
        t_coll = terms["collective"] = coll_bytes / NVLINK_BW
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, spec.kind, spec.global_batch, spec.seq_len,
                     np_info["active"])
    mf_per_dev = mf / n_chips
    t_max = max(terms.values())
    return {
        "arch": arch, "shape": shape, "mesh": mesh_name(mesh),
        "n_chips": n_chips, "kind": spec.kind,
        "variant": dataclasses.asdict(variant), "policy": policy.name,
        "params_total": np_info["total"], "params_active": np_info["active"],
        "op_cost": {"flops": cost["flops"], "mac_flops": cost["mac_flops"],
                    "bytes": cost["bytes"],
                    "flops_by_dtype": cost["flops_by_dtype"],
                    "bytes_by_dtype": cost["bytes_by_dtype"],
                    "collectives": coll and coll["per_kind"],
                    "scope": "one rank" if rank else "global",
                    "depth": cost["depth"],
                    "source": "launch/op_cost on meta tensors at the "
                              + ("rank-local shapes of one rank's "
                                 "distributed decode step" if rank else
                                 "cell's global shape")
                              + "; bytes unfused; each kernel call "
                              "counted as one launch"},
        "memory_analysis": {
            "argument_size_in_bytes": args["total"],
            "argument_bytes_by_part": {k: v for k, v in args.items()
                                       if k != "total"},
            "temp_size_in_bytes": None,
            "source": "reckoned per device from the spec trees"
                      + ("; the params whole on every rank, as the "
                         "distributed decode holds them" if rank else "")
                      + "; no compiler gives temp bytes"},
        "collectives_single_instance": coll,
        "hlo_ops": None,
        "roofline": {
            "per_device": ("one rank's counts" if rank else
                           "global counts split evenly over the mesh"),
            "flops_per_device": flops,
            "hbm_bytes_per_device": bytes_acc,
            "collective_bytes_per_device": coll_bytes,
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll,
            "t_collective_source": (
                "reckoned: the result bytes over one direction of NVLink "
                f"({NVLINK_BW:.3g} B/s, H100 SXM)" if rank else None),
            "dominant": dominant,
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
    """The cell's mesh; on ``--mesh host`` the ranks are the "model" axis
    only for a decode cell under ``--distributed-decode``, where the
    variant acts."""
    if args.mesh == "host":
        return mesh_lib.make_host_mesh(
            args.world, model=args.distributed_decode
            and SHAPES[args.shape].kind == "decode")
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
    ap.add_argument("--distributed-decode", action="store_true",
                    help="decode cells: one rank's distributed decode "
                         "step, its collectives counted")
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
        distributed_decode=args.distributed_decode, q_block=args.q_block,
        kv_block=args.kv_block,
        attn_vjp=args.attn_vjp, packed=args.packed)
    report = lower_cell(args.arch, args.shape, variant=variant,
                        mesh=_mesh_of(args))
    report["tag"] = args.tag
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    r = report["roofline"]
    print(f"OK {name}: dominant={r['dominant']} "
          f"compute={r['t_compute_s']:.4f}s memory={r['t_memory_s']:.4f}s "
          + (f"collective={r['t_collective_s']:.6f}s "
             f"({r['collective_bytes_per_device']:.0f} B) "
             if r["t_collective_s"] is not None else "")
          + f"frac={r['roofline_fraction']:.3f} "
          f"args={report['memory_analysis']['argument_size_in_bytes']} B "
          f"fits={report['fits_hbm']} "
          f"trace={report['timings']['trace_s']:.0f}s")
    return report


if __name__ == "__main__":
    main()
