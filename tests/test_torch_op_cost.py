"""The port's op counter (``repro_torch.launch.op_cost``), the meta-tensor
counterpart of the reference's HLO cost analysis: hand counts for small
functions, the by-dtype splits, the refusal of host syncs and of tensors
made on a device (recorded, never raised, by the energy accountant), the
K4 and K6 wrappers' counts (their plain versions on meta tensors) against
the analytic QK + PV count, and the same counts from meta and from CPU
tensors for the engine's stages."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.formats import POSIT8_2  # noqa: E402
from repro_torch.kernels import LAUNCHES  # noqa: E402
from repro_torch.kernels import kv_cache as kvk  # noqa: E402
from repro_torch.kernels import paged_kv as pkv  # noqa: E402
from repro_torch.launch.op_cost import (TraceError, analyze,  # noqa: E402
                                        dtype_label,
                                        entry_param_bytes_by_dtype)
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import EnergyAccountant  # noqa: E402
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine_api import _abstract_args  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["mm", "bmm", "einsum", "addmm"])
def test_products_against_hand_counts(case):
    f32 = 4
    if case == "mm":
        fn, args = torch.mm, (meta(4, 8), meta(8, 16))
        mac, moved = 2 * 4 * 8 * 16, (32 + 128 + 64) * f32
    elif case == "bmm":
        fn, args = torch.bmm, (meta(3, 4, 8), meta(3, 8, 5))
        mac, moved = 2 * 3 * 4 * 8 * 5, (96 + 120 + 60) * f32
    elif case == "einsum":
        fn = lambda a, b: torch.einsum("bsd,df->bsf", a, b)  # noqa: E731
        args = (meta(2, 3, 8), meta(8, 4))
        mac, moved = 2 * 2 * 3 * 8 * 4, (48 + 32 + 24) * f32
    else:
        fn, args = torch.addmm, (meta(16), meta(4, 8), meta(8, 16))
        mac, moved = 2 * 4 * 8 * 16, (16 + 32 + 128 + 64) * f32
    a = analyze(fn, args)
    assert a["mac_flops"] == mac
    assert a["flops"] == mac            # a product's FLOPs are its MACs x 2
    assert a["bytes"] == moved
    assert a["flops_by_dtype"] == {"f32": mac}
    assert a["bytes_by_dtype"] == {"f32": moved}
    assert a["collective_bytes"] == 0.0 and a["collectives"] == {}


def test_elementwise_chain_counts_one_flop_per_output():
    a = analyze(lambda x: ((x * 2.0) + 1.0).exp().reshape(-1), (meta(4, 8),))
    assert a["mac_flops"] == 0
    assert a["flops"] == 3 * 32          # mul, add, exp; the view is free
    assert a["bytes"] == 3 * 2 * 32 * 4  # each op reads and writes 128 B


def test_by_dtype_splits_sum_to_totals():
    def fn(x, codes, idx):
        y = x @ x.T                              # bf16 product
        return y.float().sum(), codes + 1, idx * 2

    a = analyze(fn, (meta(6, 4, dtype=torch.bfloat16),
                     meta(10, dtype=torch.uint8),
                     meta(3, dtype=torch.int32)))
    assert a["mac_flops"] == 2 * 6 * 4 * 6
    assert a["flops_by_dtype"]["bf16"] == 2 * 6 * 4 * 6
    assert a["flops_by_dtype"]["u8"] == 10
    assert a["flops_by_dtype"]["s32"] == 3
    assert sum(a["flops_by_dtype"].values()) == a["flops"]
    assert sum(a["bytes_by_dtype"].values()) == a["bytes"]
    assert 0 < a["mac_flops"] <= a["flops"]
    assert [dtype_label(d) for d in (torch.float32, torch.bfloat16,
                                     torch.uint8, torch.uint16,
                                     torch.int32, torch.bool)] \
        == ["f32", "bf16", "u8", "u16", "s32", "pred"]


def test_entry_param_bytes_count_tensors_not_scalars():
    spec = ({"w": meta(4, 8), "c": meta(5, dtype=torch.uint8)},
            [meta(3, dtype=torch.int32)], 7, 2.5, None)
    assert entry_param_bytes_by_dtype(spec) == {"f32": 128.0, "u8": 5.0,
                                                "s32": 12.0}
    # the engine's spec capture keeps shapes and dtypes, never data
    live = {"x": torch.ones(2, 3, dtype=torch.bfloat16),
            "i": (torch.arange(4, dtype=torch.int32),), "n": 3,
            "r": np.arange(5)}          # a host index vector (rollback)
    abstract = _abstract_args(live)
    assert abstract["x"].is_meta and abstract["x"].dtype == torch.bfloat16
    assert abstract["i"][0].is_meta and abstract["i"][0].dtype == torch.int32
    assert abstract["r"].is_meta and abstract["r"].shape == (5,)
    assert abstract["r"].dtype == torch.int64
    assert abstract["n"] == 3


class _Stages:
    """A bare stage holder for the accountant (no metrics)."""

    def __init__(self, specs):
        self.cfg = get_config("paper-edge", smoke=True)
        from repro_torch.core.transprecision import BF16
        self.policy = self.weight_policy = BF16
        self.stage_specs = specs


def test_host_sync_raises_and_the_accountant_records_it():
    def synced(x):
        return x * float(x.sum().item())

    with pytest.raises(TraceError, match=r"\.item\(\)"):
        analyze(synced, (meta(3),))
    with pytest.raises(TraceError, match="boolean-mask"):
        analyze(lambda x: x[x > 0], (meta(3),))
    acct = EnergyAccountant(_Stages({"bad": (synced, (meta(3),)),
                                     "good": (torch.mm, (meta(2, 2),
                                                         meta(2, 2)))}))
    bd = acct.breakdown(calls={"bad": 1, "good": 1}, tokens=1)
    assert set(bd["stages"]) == {"good"}
    assert "TraceError" in bd["errors"]["bad"]


def test_a_tensor_made_on_a_device_raises_before_allocating():
    # the aten call itself (``torch.ones(3, device="cuda")`` first
    # initialises CUDA, which a CPU-only build cannot)
    ones = torch.ops.aten.ones.default
    with pytest.raises(TraceError, match="inputs' device"):
        analyze(lambda x: x + ones([3], device=torch.device("cuda")),
                (meta(3),))
    with pytest.raises(TraceError, match="inputs' device"):
        analyze(lambda x: x + ones([3], device=torch.device("cuda")),
                (torch.zeros(3),))


def _qk_pv(b, nh, rows, hd):
    return 2 * 2 * b * nh * rows * hd      # QK and PV, 2 FLOPs per MAC


def test_plain_k4_and_k6_counts_equal_the_analytic_count():
    b, w, nh, nkv, hd, ps = 3, 48, 4, 2, 16, 8
    q = meta(b, 1, nh, hd)
    codes, scales = meta(b, w, nkv, hd, dtype=torch.uint8), meta(b, w, nkv)
    before = dict(LAUNCHES)
    k4 = analyze(lambda *a: kvk.decode_attention(*a, POSIT8_2),
                 (q, codes, scales, codes, scales, meta(b, dtype=torch.int32)))
    assert k4["mac_flops"] == _qk_pv(b, nh, w, hd)
    pmax, pages = 5, 1 + b * 5
    pool = meta(pages * ps, nkv, hd, dtype=torch.uint8)
    pscale = meta(pages * ps, nkv)
    k6 = analyze(
        lambda *a: pkv.paged_decode_attention(*a, POSIT8_2, page_size=ps),
        (q, pool, pscale, pool, pscale, meta(b, pmax, dtype=torch.int32),
         meta(b, dtype=torch.int32)))
    assert k6["mac_flops"] == _qk_pv(b, nh, pmax * ps, hd)
    assert dict(LAUNCHES) == before      # plain versions: nothing launched


@pytest.fixture(scope="module")
def served():
    cfg = dataclasses.replace(get_config("paper-edge", smoke=True),
                              dtype_name="float32")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    out = {}
    for layout in ("ring", "paged"):
        eng = ServingEngine(cfg, params, ServeConfig(
            max_batch=2, max_len=64, kv_format="posit8", kv_layout=layout),
            policy="paper_edge_p8", device="cpu")
        rng = np.random.default_rng(0)
        eng.serve([Request(uid=i, prompt=rng.integers(0, cfg.vocab, 9),
                           max_new=4) for i in range(3)])
        out[layout] = eng
    return out


def _live(spec, gen):
    """CPU tensors of a meta spec (random ints in [0, 8) for integer
    leaves: valid indices, lengths and positions)."""
    if isinstance(spec, torch.Tensor):
        if spec.dtype.is_floating_point:
            return torch.randn(spec.shape, generator=gen).to(spec.dtype)
        return torch.randint(0, 8, spec.shape, generator=gen).to(spec.dtype)
    if isinstance(spec, dict):
        return {k: _live(v, gen) for k, v in spec.items()}
    if isinstance(spec, (tuple, list)):
        return type(spec)(_live(v, gen) for v in spec)
    return spec


@pytest.mark.parametrize("layout", ["ring", "paged"])
@pytest.mark.parametrize("stage", ["prefill", "insert", "generate"])
def test_meta_and_cpu_traces_count_alike(served, layout, stage):
    fn, spec = served[layout].engine.stage_specs[stage]
    assert all(t.is_meta for t in _leaves(spec))
    live = _live(spec, torch.Generator().manual_seed(0))
    assert analyze(fn, spec) == analyze(fn, live)


def _leaves(tree):
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]
