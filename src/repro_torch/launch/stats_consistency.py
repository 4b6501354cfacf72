"""Check that the engines' legacy ``stats`` keys stay views of the metrics
registry (port of the reference's ``scripts/stats_consistency.py``).

The ``ServingEngine``'s and the ``Orchestrator``'s ``stats`` are
``obs.StatsView`` facades over one shared ``obs.MetricsRegistry``.  This
serves a few smoke requests through the threaded orchestrator, then
holds every legacy key, engine and orchestrator, to the registry
snapshot's value of the metric it names (``StatsView.metric_name``), so
a drift between the two surfaces fails a check, not a dashboard.

  PYTHONPATH=src python -m repro_torch.launch.stats_consistency \
      [--device cuda|cpu]

On the GPU by default (raises without one), the CPU with ``--device
cpu``.  Exit status 0 when every key matches, 1 on a drift.
"""
from __future__ import annotations

import argparse
import sys
from typing import List

import numpy as np
import torch

from ..configs import get_config
from ..models import lm
from ..obs import Tracer
from ..serve.engine import ServeConfig, ServingEngine
from ..serve.orchestrator import (Orchestrator, OrchestratorConfig,
                                  StreamingRequest)


def drift(views, snap) -> List[str]:
    """Each legacy key of ``views`` ((label, StatsView) pairs) whose value
    is not its metric's in the registry ``snap``."""
    flat = {**snap["counters"], **snap["gauges"]}
    bad = []
    for label, view in views:
        for key in view:
            name = view.metric_name(key)
            if name not in flat:
                bad.append(f"{label}.stats[{key!r}] -> {name} missing "
                           "from registry snapshot")
            elif flat[name] != view[key]:
                bad.append(f"{label}.stats[{key!r}] = {view[key]} but "
                           f"registry {name} = {flat[name]}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    scfg = ServeConfig(max_batch=2, max_len=64, kv_format="posit8")
    eng = ServingEngine(cfg, params, scfg, tracer=Tracer(enabled=True),
                        device=args.device)
    rng = np.random.default_rng(0)
    sreqs = [StreamingRequest(rng.integers(0, cfg.vocab, 6).tolist(),
                              max_new=4) for _ in range(3)]
    with Orchestrator(eng, OrchestratorConfig(detokenize=False)) as orch:
        for s in sreqs:
            assert orch.submit(s, timeout=60.0)
        for s in sreqs:
            assert s.wait(120.0), "stream did not finish"
        snap = eng.metrics.snapshot()
        bad = drift((("engine", eng.stats), ("orch", orch.stats)), snap)
    if bad:
        print("stats/registry drift:", *bad, sep="\n  ")
        return 1
    flat = {**snap["counters"], **snap["gauges"]}
    n_tok = sum(len(s.out_tokens) for s in sreqs)
    assert n_tok > 0 and flat["engine.tokens"] >= n_tok
    assert flat["orch.submitted"] == len(sreqs)
    assert flat["orch.finished"] == len(sreqs)
    print(f"stats consistency OK: {len(dict(eng.stats))} engine + "
          f"{len(dict(orch.stats))} orchestrator keys match the registry")
    return 0


if __name__ == "__main__":
    sys.exit(main())
