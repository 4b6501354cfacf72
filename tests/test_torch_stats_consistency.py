"""The port's counterpart of the reference's ``scripts/stats_consistency.py``
(``repro_torch.launch.stats_consistency``): a few smoke requests served
through the ``Orchestrator`` on the CPU, then every legacy ``stats`` key,
engine and orchestrator, held to the registry snapshot's value of the
metric it names.  Its drift check reports a key whose metric is missing
from the snapshot or holds another value, and the legacy keys are the
reference's."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serve.engine import ServingEngine as JServingEngine  # noqa: E402
from repro.serve.orchestrator import Orchestrator as JOrchestrator  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import stats_consistency  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import MetricsRegistry, StatsView  # noqa: E402
from repro_torch.serve import (Orchestrator, ServeConfig,  # noqa: E402
                               ServingEngine)
from _torch_threads import torch_threads  # noqa: E402,F401


def test_every_legacy_key_matches_the_registry(capsys):
    assert stats_consistency.main(["--device", "cpu"]) == 0
    assert "stats consistency OK" in capsys.readouterr().out


def test_drift_is_reported():
    reg = MetricsRegistry()
    view = StatsView(reg, prefix="engine.")
    view.bind_counters("tokens")
    view["tokens"] += 3
    assert stats_consistency.drift([("engine", view)], reg.snapshot()) == []
    other = MetricsRegistry()
    view.bind("stray", other.counter("elsewhere"))
    snap = reg.snapshot()
    bad = stats_consistency.drift([("engine", view)], snap)
    assert bad == ["engine.stats['stray'] -> elsewhere missing from "
                   "registry snapshot"]
    snap["counters"]["engine.tokens"] = 4
    view.bind("stray", reg.counter("engine.tokens"))
    assert len(stats_consistency.drift([("engine", view)], snap)) == 2


def test_legacy_keys_are_the_references():
    """The keys the engine and the orchestrator bind, and the metrics they
    name, are those of the reference's engine and orchestrator (built, not
    served: nothing compiles)."""
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=32),
                        device="cpu")
    jcfg = j_get_config("paper-edge", smoke=True)
    jeng = JServingEngine(jcfg, jlm.init_params(jax.random.PRNGKey(0), jcfg),
                          JServeConfig(max_batch=2, max_len=32))
    for view, jview in ((eng.stats, jeng.stats),
                        (Orchestrator(eng).stats, JOrchestrator(jeng).stats)):
        assert list(view) == list(jview)
        assert [view.metric_name(k) for k in view] == [
            jview.metric_name(k) for k in jview]
