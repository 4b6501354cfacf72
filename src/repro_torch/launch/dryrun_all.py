"""Drive the full dry-run matrix: every assigned (arch x shape) cell on the
single-pod (16,16) and multi-pod (2,16,16) production meshes, and on a
host mesh of ``--world`` cards (port of ``repro.launch.dryrun_all``).

Each cell runs in its own subprocess (``-m repro_torch.launch.dryrun``),
which bounds its memory.  Existing result JSONs are skipped, so the sweep
is resumable: rerun after a fix and only failed cells run again.

  PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
      [--mesh pod1 pod2 host] [--world 1] [--archs ... paper-edge] \\
      [--out build/dryrun]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

from ..configs import ASSIGNED, SHAPES, cells

SRC = str(Path(__file__).resolve().parents[2])


def run_cell(arch, shape, mesh, out, world=1):
    label = mesh + (str(world) if mesh == "host" else "")
    path = os.path.join(out, f"{arch}_{shape}_{label}.json")
    if os.path.exists(path):
        return "cached", 0.0
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--world", str(world), "--out",
         out],
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": SRC})
    dt = time.time() - t0
    if proc.returncode != 0:
        tail = proc.stderr.strip().splitlines()[-12:]
        with open(path + ".err", "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": label,
                       "error": "\n".join(tail)}, f, indent=1)
        return "FAIL", dt
    return "ok", dt


def summary(out, archs, meshes, world=1):
    """A markdown table of the reports under ``out``: per arch and shape,
    each mesh's argument GB a device and whether it fits the card's HBM
    (arguments only; "skip" where the cell does not apply)."""
    labels = [m + (str(world) if m == "host" else "") for m in meshes]
    lines = [f"| Arch | {' | '.join(SHAPES)} |",
             "| --- |" + " --- |" * len(SHAPES)]
    for arch in archs:
        row = []
        for shape in SHAPES:
            cell = []
            for label in labels:
                path = os.path.join(out, f"{arch}_{shape}_{label}.json")
                if not os.path.exists(path):
                    cell.append("?")
                    continue
                with open(path) as f:
                    rep = json.load(f)
                if rep.get("skipped"):
                    cell.append("skip")
                    continue
                gb = rep["memory_analysis"]["argument_size_in_bytes"] / 1e9
                cell.append(f"{gb:.2f}" + ("" if rep["fits_hbm"] else " ✗"))
            row.append(" / ".join(cell))
        lines.append(f"| {arch} | {' | '.join(row)} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", nargs="+", default=["pod1", "pod2"],
                    choices=["pod1", "pod2", "host"])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--archs", nargs="*", default=None,
                    help="default: the assigned archs")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    results = {}
    t00 = time.time()
    for arch, shape, _, _ in cells(args.archs or ASSIGNED):
        for mesh in args.mesh:
            status, dt = run_cell(arch, shape, mesh, args.out, args.world)
            results[(arch, shape, mesh)] = status
            print(f"[{time.time() - t00:7.0f}s] {status:6s} "
                  f"{arch} {shape} {mesh} ({dt:.0f}s)", flush=True)
    fails = [k for k, v in results.items() if v == "FAIL"]
    print(f"\nargument GB a device ({' / '.join(args.mesh)}; ✗: past "
          f"the card's 80 GB)\n")
    print(summary(args.out, args.archs or ASSIGNED, args.mesh, args.world))
    print(f"\ndone: {len(results) - len(fails)}/{len(results)} ok")
    for k in fails:
        print("FAILED:", k)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
