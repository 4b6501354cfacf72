"""Quickstart of the port: the paper's contribution in three parts, as the
reference's ``examples/quickstart.py`` runs them.

1. Encode/decode posits with Algorithm 1 (parallel threshold compares).
2. Wrap a weight matrix in a posit ``QuantizedTensor`` and multiply
   through K7 (``kernels.ops.qt_matmul``: decode in shared memory, f32
   FMA on the card; the plain version on the CPU).
3. One transprecision training step where the TC policy puts every weight
   in P(8,2), the paper's edge configuration (smoke-size paper-edge).

    PYTHONPATH=src python -m repro_torch.quickstart              # the GPU
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import resolve_device
from .configs import get_config
from .core import posit
from .core.formats import POSIT8_2
from .core.quant import quantize
from .core.transprecision import PAPER_EDGE
from .data.pipeline import make_pipeline
from .kernels.ops import qt_matmul
from .optim import AdamWConfig
from .train.step import TrainState, init_train_state, make_train_step


def codec_roundtrip(device="cuda"):
    """Part 1: (x, codes, decoded) for four values in P(8,2)."""
    dev = resolve_device(device)
    x = torch.tensor([0.00024, 1.0, -2.5, 13.0], device=dev)
    codes = posit.encode_f32(x, POSIT8_2)
    return x, codes, posit.decode_to_f32(codes, POSIT8_2)


def posit_matmul_demo(device="cuda"):
    """Part 2: mean relative error of ``qt_matmul`` against the f32
    weights, packed bytes, f32 bytes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((128, 32)) * 0.05).astype(
        np.float32)).to(dev)
    wq = quantize(w, POSIT8_2, axis=0)      # per-output-channel pow2 scale
    out = qt_matmul(a, wq)
    exact = a @ w
    err = (out - exact).abs().mean() / exact.abs().mean()
    return float(err), wq.nbytes_packed, w.numel() * w.element_size()


def train_step_demo(device="cuda", state: TrainState = None):
    """Part 3: one PAPER_EDGE train step of smoke-size paper-edge on step
    0 of the synthetic pipeline (batch 4 x 64); a fresh state from seed 0
    unless ``state`` is given.  Returns the metrics."""
    dev = resolve_device(device)
    cfg = get_config("paper-edge", smoke=True)
    opt_cfg = AdamWConfig(total_steps=10)
    if state is None:
        state = init_train_state(
            cfg, opt_cfg, PAPER_EDGE,
            generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    step = make_train_step(cfg, opt_cfg, PAPER_EDGE)
    batch = make_pipeline(cfg, global_batch=4, seq_len=64, device=dev)(0)
    _, metrics = step(state, batch)
    return metrics


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    x, codes, back = codec_roundtrip(args.device)
    print("posit P(8,2) round-trip:")
    for xi, ci, bi in zip(x.tolist(), codes.tolist(), back.tolist()):
        print(f"  {xi:+9.5f} -> 0b{ci:08b} -> {bi:+9.5f}")

    err, packed, full = posit_matmul_demo(args.device)
    print(f"\nposit8 matmul kernel: mean rel err vs f32 weights = {err:.3f} "
          f"(storage {packed} B vs {full} B)")

    metrics = train_step_demo(args.device)
    print(f"\nTC train step under policy '{PAPER_EDGE.name}': "
          f"loss={float(metrics['loss']):.3f} "
          f"gnorm={float(metrics['grad_norm']):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
