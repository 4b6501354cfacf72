"""The last public names of the reference that the port lacked, each held
to the reference on the CPU with the same inputs:

* ``obs.metrics``: ``Gauge.inc``, ``Histogram.mean``,
  ``MetricsRegistry.__contains__`` / ``names`` / ``from_snapshot`` (the
  snapshot round trip exact, from the port's and from the reference's
  snapshots), ``StatsView.bind`` / ``metric_name``;
* ``obs.tracer``: ``Tracer.trace``, the decorator form of ``span``;
* ``kernels.kv_cache``: ``kv_append`` and ``kv_append_ref``, the T = 1
  cases of K3 and its plain version, bit-exact to the reference's
  ``kv_append_ref`` for posit8, posit16 and packed posit4;
* ``core.transprecision``: ``TCPolicy.storage_quantize`` and
  ``bits_for``;
* ``models.common.layer_norm``; ``configs.get_module``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.core import transprecision as jtp  # noqa: E402
from repro.kernels import kv_cache as jkv  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import StatsView as JStatsView  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import formats as tformats  # noqa: E402
from repro_torch.core import transprecision as ttp  # noqa: E402
from repro_torch.kernels import kv_cache as tkv  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.obs import MetricsRegistry, StatsView, Tracer  # noqa: E402
from test_torch_kv_cache import _np, _rows, _t  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def _fill(reg):
    """The same metrics on a registry of either package."""
    reg.counter("engine.tokens").inc(7)
    g = reg.gauge("engine.kv_cache_bytes")
    g.set(10)
    g.inc(5)
    g.inc(0.5)
    h = reg.histogram("stage.generate.device_s")
    for x in (0.0, 1e-8, 3e-4, 2.5e-3, 0.011, 7.0, 2e4):
        h.observe(x)
    reg.histogram("stage.prefill.dispatch_s", lo=1e-6, hi=10.0,
                  ratio=2.0 ** 0.25).observe(0.02)
    reg.histogram("empty")
    return reg


def test_metrics_names_equal_the_reference():
    reg, jreg = _fill(MetricsRegistry()), _fill(JRegistry())
    assert reg.gauge("engine.kv_cache_bytes").value == \
        jreg.gauge("engine.kv_cache_bytes").value == 15.5
    for name in ("stage.generate.device_s", "empty"):
        assert reg.histogram(name).mean == jreg.histogram(name).mean
    assert reg.histogram("empty").mean is None
    assert reg.names() == jreg.names()
    for name in ("engine.tokens", "empty", "nope"):
        assert (name in reg) == (name in jreg)
    assert reg.snapshot() == jreg.snapshot()


def test_snapshot_round_trip_is_exact():
    snap = _fill(MetricsRegistry()).snapshot()
    assert MetricsRegistry.from_snapshot(snap).snapshot() == snap
    jsnap = _fill(JRegistry()).snapshot()
    assert MetricsRegistry.from_snapshot(jsnap).snapshot() == jsnap
    assert MetricsRegistry.from_snapshot({}).snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_stats_view_bind_and_metric_name():
    views = []
    for reg_cls, view_cls in ((MetricsRegistry, StatsView),
                              (JRegistry, JStatsView)):
        reg = reg_cls()
        view = view_cls(reg, prefix="engine.")
        view.bind_counters("tokens")
        view.bind("queued", reg.gauge("orch.queue_depth"))
        view["queued"] = 3
        view["late"] = 2            # a late key defaults to a gauge
        views.append((view, reg))
    for (view, reg), (jview, jreg) in [views]:
        for key in ("tokens", "queued", "late"):
            assert view.metric_name(key) == jview.metric_name(key)
        assert reg.snapshot() == jreg.snapshot()
    assert views[0][0].metric_name("queued") == "orch.queue_depth"


def test_tracer_trace_records_what_span_records():
    got = []
    for tr in (Tracer(enabled=True), JTracer(enabled=True)):
        @tr.trace("stage", cat="engine")
        def stage(x):
            return x + 1

        @tr.trace()
        def unnamed():
            return None

        assert stage(1) == 2 and stage.__name__ == "stage"
        unnamed()
        with tr.span("stage", cat="engine"):
            pass
        tr.enabled = False
        assert stage(2) == 3            # disabled: a plain call
        got.append({k: v["count"] for k, v in tr.self_times().items()})
    assert got[0] == got[1]
    assert got[0]["stage"] == 2
    assert any(k.endswith("unnamed") for k in got[0])


@pytest.mark.parametrize("name,packed", [("posit16_2", False),
                                         ("posit8_2", False),
                                         ("posit4_1", True)])
@pytest.mark.parametrize("pos", [[0, 7], [13, 30], 5])
def test_kv_append_bit_exact(name, packed, pos):
    """The T = 1 append at ring row pos mod W (scalar or per slot, with
    wrapping), into a ring of random codes: codes and scales bit-exact to
    the reference's ``kv_append_ref``; ``kv_append`` on CPU tensors is its
    plain version."""
    rng = np.random.default_rng(4)
    fj, ft = jformats.get(name), tformats.get(name)
    b, w, h, hd = 2, 16, 2, 16
    dc = tkv.code_channels(hd, ft, packed)
    codes = rng.integers(0, 1 << min(ft.bits, 8), (b, w, h, dc)).astype(
        np.uint8 if ft.bits <= 8 else np.uint16)
    scales = np.exp2(rng.integers(-4, 4, (b, w, h))).astype(np.float32)
    k_new, v_new = _rows(rng, (b, 1, h, hd)), _rows(rng, (b, 1, h, hd))
    want = jkv.kv_append_ref(jnp.asarray(codes), jnp.asarray(scales),
                             jnp.asarray(codes), jnp.asarray(scales),
                             jnp.asarray(k_new), jnp.asarray(v_new),
                             jnp.asarray(pos, jnp.int32), fj, packed)
    for fn in (tkv.kv_append_ref, tkv.kv_append):
        bufs = (_t(codes), torch.from_numpy(scales.copy()), _t(codes),
                torch.from_numpy(scales.copy()))
        kw = {"packed": packed}
        out = fn(*bufs, torch.from_numpy(k_new), torch.from_numpy(v_new),
                 torch.as_tensor(pos, dtype=torch.int32), ft, **kw)
        for got, w_ in zip(out, want):
            a = _np(got) if got.dtype != torch.float32 else got.numpy()
            np.testing.assert_array_equal(a, np.asarray(w_))
        assert all(o is b_ for o, b_ in zip(out, bufs))    # in place


@pytest.mark.parametrize("policy", ["paper_edge_p8", "mixed_tc", "bf16"])
@pytest.mark.parametrize("role", ["attn_weights", "mlp_weights",
                                  "embed_weights", "kv_cache"])
def test_storage_quantize_and_bits_for(policy, role):
    jpol, tpol = jtp.get_policy(policy), ttp.get_policy(policy)
    assert tpol.bits_for(role) == jpol.bits_for(role)
    w = np.random.default_rng(5).normal(0, 0.02, (3, 8, 16)).astype(
        np.float32)
    got = tpol.storage_quantize(torch.from_numpy(w), role)
    want = jpol.storage_quantize(jnp.asarray(w), role)
    if jpol.fmt_for(role) is None:
        assert isinstance(got, torch.Tensor)
        np.testing.assert_array_equal(got.numpy(), w)
        return
    assert got.fmt.name == want.fmt.name
    np.testing.assert_array_equal(_np(got.data), np.asarray(want.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(6)
    x = (rng.normal(0, 3, (4, 5, 64)) + 1.5).astype(np.float32)
    scale = rng.normal(1, 0.1, 64).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = tcommon.layer_norm(tx, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    want = jcommon.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    assert got.dtype == tx.dtype
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_get_module():
    for arch in tconfigs.ASSIGNED + ("paper-edge",):
        mod, jmod = tconfigs.get_module(arch), jconfigs.get_module(arch)
        assert mod.__name__.rsplit(".", 1)[1] == \
            jmod.__name__.rsplit(".", 1)[1]
        assert mod.full() == tconfigs.get_config(arch)
        assert mod.smoke() == tconfigs.get_config(arch, smoke=True)
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_module("gpt-5")
    with pytest.raises(KeyError):
        jconfigs.get_module("gpt-5")
