"""The port's shape registry and meta-device dry run against the reference.

* ``configs.SHAPES``, ``cells()`` and ``shape_applicable`` equal the
  reference's; ``launch/dryrun.active_params`` and ``model_flops`` are exact
  for every registered arch and shape.
* ``launch/specs.input_specs`` / ``decode_specs`` equal the reference's leaf
  for leaf (shape and dtype) on every applicable full-size cell.
* ``dryrun.argument_bytes`` (one device's shard bytes, reckoned from the
  port's spec trees) equals the reference's trees' shard bytes under
  ``NamedSharding(AbstractMesh).shard_shape``, with no compile, at pod1
  and pod2.
* ``dryrun.step_cost``'s product FLOPs of smoke-size decode and prefill
  cells equal the reference's ``hlo_cost.analyze`` of the same function
  jitted on one device; the train step's ratio is pinned (see its test);
  the depth extrapolation equals a full trace.
* Under the dry run's ``kernels="custom_call"`` count, each kernel
  wrapper's call (K1-K7, and K4 through ``decode_attention_packed``)
  counts as its one launch: its operands' bytes read once and the rows it
  writes written once, its products' FLOPs as in the plain count; a posit8
  decode_32k cell's code bytes are K4's ring reads and K3's row writes.
* The CLI writes a report for a cell and the reference's ``skipped`` file
  for ``long_500k`` on a full-attention arch, and refuses the reference's
  knobs that have no counterpart in the port.

Importing ``repro.launch.dryrun`` writes
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` into
``os.environ``: the fixture starts JAX first (keeping its one CPU device)
and puts the variable back after the import.
"""
import argparse
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core.transprecision import BF16 as J_BF16  # noqa: E402
from repro.core.transprecision import SERVE_P8 as J_SERVE_P8  # noqa: E402
from repro.core.transprecision import pack_params as j_pack_params  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import serve_model as jserve  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.train import step as jstep  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core.transprecision import BF16, SERVE_P8  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.common import map_with_path  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported with JAX already started
    and ``XLA_FLAGS`` restored afterwards."""
    n = len(jax.devices())
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdry
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    assert len(jax.devices()) == n
    return jdry


def _applicable():
    return [(a, s) for a in ARCHS for s in SHAPES
            if jconfigs.shape_applicable(a, s)[0]]


def _jflat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jmesh._path_str(kp): (tuple(x.shape), np.dtype(x.dtype).name)
            for kp, x in leaves}


def _tflat(tree):
    out = {}
    map_with_path(lambda p, t: out.__setitem__(
        p, (tuple(t.shape), str(t.dtype).replace("torch.", ""))), tree)
    return out


def test_shapes_cells_and_applicability_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert list(tconfigs.cells()) == list(jconfigs.cells())
    assert tconfigs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    for arch in ARCHS:
        for shape in SHAPES:
            assert tconfigs.shape_applicable(arch, shape) == \
                jconfigs.shape_applicable(arch, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_exact(jdry, arch):
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    got, want = dryrun.active_params(cfg), jdry.active_params(jcfg)
    assert got == want
    for s in SHAPES.values():
        assert dryrun.model_flops(cfg, s.kind, s.global_batch, s.seq_len,
                                  got["active"]) == jdry.model_flops(
            jcfg, s.kind, s.global_batch, s.seq_len, want["active"])


@pytest.mark.parametrize("arch,shape", _applicable())
def test_specs_equal_reference(arch, shape):
    cfg, jcfg, spec = (tconfigs.get_config(arch),
                       jconfigs.get_config(arch), SHAPES[shape])
    if spec.kind == "decode":
        cache, tok = specs.decode_specs(cfg, spec)
        jcache, jtok = jspecs.decode_specs(jcfg, jconfigs.SHAPES[shape])
        assert all(t.device.type == "meta" for t in (tok, cache["pos"]))
        assert _tflat(cache) == _jflat(jcache)
        assert _tflat(tok) == _jflat(jtok)
    got = specs.input_specs(cfg, spec)
    assert _tflat(got) == _jflat(jspecs.input_specs(
        jcfg, jconfigs.SHAPES[shape]))


# ---- argument bytes: the port's reckoning vs the reference's trees ----

@functools.cache
def _j_state(arch):
    return jstep.init_train_state(jax.random.PRNGKey(0),
                                  jconfigs.get_config(arch), JAdamWConfig(),
                                  J_BF16, abstract=True)


def _j_shard_bytes(tree, spec_tree, mesh):
    """One device's bytes of ``tree`` under the spec tree (a prefix of
    it), from jax's own ``shard_shape``."""
    total = 0

    def one(spec, sub):
        nonlocal total
        sh = NamedSharding(mesh, spec)
        for leaf in jax.tree_util.tree_leaves(sub):
            total += int(np.prod(sh.shard_shape(leaf.shape))) * \
                np.dtype(leaf.dtype).itemsize

    jax.tree_util.tree_map(one, spec_tree, tree,
                           is_leaf=lambda x: isinstance(x, JP))
    return total


def _j_argument_bytes(arch, shape, multi_pod, packed=False):
    """The reference's lower_cell arguments (dryrun.py:200-257) and
    their shard bytes, with no compile."""
    cfg, spec = jconfigs.get_config(arch), jconfigs.SHAPES[shape]
    names = (("pod",) if multi_pod else ()) + ("data", "model")
    mesh = AbstractMesh(tuple(AXIS_SIZE[a] for a in names), names)
    sizes = type("M", (), {"axis_names": names,
                           "shape": {a: AXIS_SIZE[a] for a in names}})
    if spec.kind == "train":
        rules = jmesh.train_rules(sizes, global_batch=spec.global_batch,
                                  seq_shard=True, heads_shard=True)
    else:
        rules = jmesh.serve_rules(sizes, global_batch=spec.global_batch)
    state = _j_state(arch)
    params = state.params
    if packed:
        params = j_pack_params(params, J_SERVE_P8, abstract=True)
    pspecs = jmesh.param_specs(params, fsdp="data" if spec.kind == "train"
                               else None)
    if spec.kind == "train":
        st = jstep.state_specs(cfg, pspecs, J_BF16)
        n = _j_shard_bytes((state.params, state.opt), (st.params, st.opt),
                           mesh)
        batch = jspecs.input_specs(cfg, spec)
        return n + _j_shard_bytes(batch, jmesh.batch_specs(cfg, rules), mesh)
    n = _j_shard_bytes(params, pspecs, mesh)
    if spec.kind == "prefill":
        batch = jspecs.input_specs(cfg, spec)
        return n + _j_shard_bytes(batch, jmesh.batch_specs(
            cfg, rules, keys=set(batch)), mesh)
    cache, tok = jspecs.decode_specs(cfg, spec,
                                     J_SERVE_P8 if packed else None)
    tok_spec = JP(rules.get("batch"), *([None] * (len(tok.shape) - 1)))
    return n + _j_shard_bytes(cache, jmesh.cache_specs(cache, cfg, rules),
                              mesh) + _j_shard_bytes(tok, tok_spec, mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_reference_spec_trees(arch):
    for shape in SHAPES:
        if not jconfigs.shape_applicable(arch, shape)[0]:
            continue
        for multi_pod in (False, True):
            mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
            got = dryrun.argument_bytes(tconfigs.get_config(arch),
                                        SHAPES[shape], mesh, BF16)
            assert got["total"] == sum(v for k, v in got.items()
                                       if k != "total")
            assert got["total"] == _j_argument_bytes(arch, shape, multi_pod),\
                (shape, multi_pod)


def test_packed_argument_bytes_equal_reference():
    """posit-packed weights and a posit8 KV ring (serve_posit8): codes
    and scales under one spec."""
    got = dryrun.argument_bytes(
        tconfigs.get_config("llama3-8b"), SHAPES["decode_32k"],
        tmesh.make_production_mesh(), SERVE_P8, dryrun.Variant(packed=True))
    assert got["total"] == _j_argument_bytes("llama3-8b", "decode_32k",
                                             False, packed=True)


def test_one_card_bytes_are_the_trees_bytes():
    """At one card nothing is sharded: paper-edge's decode_32k arguments
    are its params, its 32,768-row cache for 128 slots and the tokens."""
    got = dryrun.argument_bytes(tconfigs.get_config("paper-edge"),
                                SHAPES["decode_32k"], tmesh.make_host_mesh(1),
                                BF16)
    cache, tok = specs.decode_specs(tconfigs.get_config("paper-edge"),
                                    SHAPES["decode_32k"])
    nbytes = []
    map_with_path(lambda p, t: nbytes.append(t.numel() * t.element_size()),
                  cache)
    assert got["cache"] == sum(nbytes) == 51_539_607_556
    assert got["batch"] == 128 * 4 and got["params"] == 249_375_744


# ---- the step's FLOPs against the reference's hlo_cost ----

SMOKE_DECODE = ShapeSpec("smoke_decode", "decode", 64, 2)
SMOKE_PREFILL = ShapeSpec("smoke_prefill", "prefill", 32, 2)
SMOKE_TRAIN = ShapeSpec("smoke_train", "train", 32, 2)


def _j_mac_flops(fn, *args):
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "mac_flops"]


@pytest.mark.parametrize("arch", ["paper-edge", "granite-moe-1b-a400m"])
def test_smoke_decode_and_prefill_flops_equal_hlo_cost(arch):
    cfg = tconfigs.get_config(arch, smoke=True)
    jcfg = jconfigs.get_config(arch, smoke=True)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg, abstract=True)
    dec = dryrun.step_cost(cfg, SMOKE_DECODE, BF16)
    jcache = jax.eval_shape(lambda: jserve.init_cache(jcfg, 2, 64))
    tok = jax.ShapeDtypeStruct((2, 1), np.int32)
    assert dec["depth"] == "full"
    assert dec["mac_flops"] == _j_mac_flops(
        lambda p, c, t: jserve.decode_step(p, c, t, jcfg, J_BF16), jparams,
        jcache, tok)
    pre = dryrun.step_cost(cfg, SMOKE_PREFILL, BF16)
    batch = {"tokens": jax.ShapeDtypeStruct((2, 32), np.int32)}
    assert pre["mac_flops"] == _j_mac_flops(
        lambda p, b: jserve.prefill(p, b, jcfg, 32, J_BF16), jparams, batch)
    assert 0 < pre["mac_flops"] <= pre["flops"]


def test_smoke_train_flops_ratio_to_hlo_cost():
    """The train step's product FLOPs are the reference's times 1.01136 at
    this size (remat "full"): with remat "none" they are equal.  Under
    remat, each layer's backward re-runs its forward and the flash
    backward then recomputes the scores QK^T from the same q and k; XLA's
    common-subexpression elimination merges the two score products, the
    port's eager autograd computes both.  The surplus is exactly one
    score product a layer."""
    cfg = tconfigs.get_config("paper-edge", smoke=True)
    jcfg = jconfigs.get_config("paper-edge", smoke=True)
    got = dryrun.step_cost(cfg, SMOKE_TRAIN, BF16)["mac_flops"]
    step = jstep.make_train_step(jcfg, JAdamWConfig(), J_BF16)
    state = jstep.init_train_state(jax.random.PRNGKey(0), jcfg,
                                   JAdamWConfig(), J_BF16, abstract=True)
    batch = {k: jax.ShapeDtypeStruct((2, 32), np.int32)
             for k in ("tokens", "labels")}
    want = _j_mac_flops(step, state, batch)
    b, s = SMOKE_TRAIN.global_batch, SMOKE_TRAIN.seq_len
    scores = 2 * b * cfg.n_heads * s * s * cfg.head_dim
    assert cfg.remat == "full"
    assert got - want == cfg.n_layers * scores
    assert got / want == pytest.approx(1.0113596, rel=1e-7)


@pytest.mark.parametrize("arch,n_layers,enc", [
    ("paper-edge", 5, 0), ("recurrentgemma-9b", 11, 0),
    ("whisper-large-v3", 3, 3)])
def test_depth_extrapolation_equals_full_trace(arch, n_layers, enc):
    """Traces at one and two periods (and encoder layers), extrapolated,
    give a full-depth trace's counts, tail layers included."""
    cfg = dataclasses.replace(tconfigs.get_config(arch, smoke=True),
                              n_layers=n_layers, **(
                                  {"enc_layers": enc} if enc else {}))
    for spec in (SMOKE_DECODE, SMOKE_PREFILL):
        got = dryrun.step_cost(cfg, spec, BF16)
        assert got["depth"].startswith("extrapolated")
        full = dryrun._trace(cfg, spec, BF16, dryrun.Variant())
        for k in ("flops", "mac_flops", "bytes"):
            assert got[k] == full[k], (spec.name, k)
        assert got["flops_by_dtype"] == full["flops_by_dtype"]


# ---- the CLI ----

def test_cli_report_and_skip_file(tmp_path):
    out = str(tmp_path)
    rep = dryrun.main(["--arch", "paper-edge", "--shape", "decode_32k",
                       "--mesh", "host", "--out", out])
    on_disk = json.load(open(tmp_path / "paper-edge_decode_32k_host1.json"))
    assert on_disk["memory_analysis"] == rep["memory_analysis"]
    mem = rep["memory_analysis"]
    assert mem["argument_size_in_bytes"] == 51_788_983_812
    whole_params = mem["argument_bytes_by_part"]["params"]
    assert mem["temp_size_in_bytes"] is None
    r = rep["roofline"]
    assert r["t_collective_s"] is None and r["dominant"] in (
        "compute", "memory")
    assert rep["n_chips"] == 1 and rep["fits_hbm"] is True
    assert rep["op_cost"]["collectives"] is None
    assert r["t_memory_s"] == rep["op_cost"]["bytes"] / dryrun.HBM_BW
    assert dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k",
                        "--out", out]) is None
    skip = json.load(open(tmp_path / "llama3-8b_long_500k_pod1.json"))
    assert skip == {"arch": "llama3-8b", "shape": "long_500k",
                    "mesh": "pod1", "skipped": True,
                    "reason": jconfigs.shape_applicable(
                        "llama3-8b", "long_500k")[1]}
    # dryrun_all's table reads the reports back
    from repro_torch.launch.dryrun_all import summary
    table = summary(out, ["paper-edge", "llama3-8b"], ["host", "pod1"])
    assert "| paper-edge | ? / ? | ? / ? | 51.79 / ? | ? / ? |" in table
    assert "| llama3-8b | ? / ? | ? / ? | ? / ? | ? / skip |" in table
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "paper-edge", "--shape", "decode_32k",
                     "--out", out, "--no-scan"])
    # the distributed decode's variant: one rank of two, its collectives
    rep = dryrun.main(["--arch", "paper-edge", "--shape", "decode_32k",
                       "--mesh", "host", "--world", "2",
                       "--distributed-decode", "--out", out, "--tag", "dd"])
    on_disk = json.load(open(tmp_path / "paper-edge_decode_32k_host2_dd.json"))
    assert on_disk["collectives_single_instance"] == \
        rep["collectives_single_instance"]
    assert rep["variant"]["distributed_decode"] is True
    assert rep["mesh"] == "1x2" and rep["op_cost"]["scope"] == "one rank"
    r = rep["roofline"]
    assert r["t_collective_s"] == (r["collective_bytes_per_device"]
                                   / dryrun.NVLINK_BW) > 0
    assert r["dominant"] == max(
        ("compute", "memory", "collective"),
        key=lambda k: r[f"t_{k}_s"])
    # its ranks hold every weight whole, and half the K/V rows each (the
    # cache's 4-byte ``pos`` whole on both)
    parts = rep["memory_analysis"]["argument_bytes_by_part"]
    assert parts["params"] == whole_params
    assert 2 * (parts["cache"] - 4) == mem["argument_bytes_by_part"][
        "cache"] - 4
    # the variant makes the ranks the "model" axis on decode cells only
    for shape, sizes in (("decode_32k", (1, 2)), ("prefill_32k", (2, 1)),
                         ("train_4k", (2, 1))):
        ns = argparse.Namespace(mesh="host", world=2, shape=shape,
                                distributed_decode=True)
        assert dryrun._mesh_of(ns).sizes == sizes, shape


# ---- the distributed decode's collectives ----

def _expected_collectives(cfg, b):
    """Per kind (count, result bytes) of one rank's distributed decode
    step at ``b`` slots: two all-reduces an attention layer, of b x nh f32
    (the max) and b x nh x (hd + 1) f32 (o and l); two all-gathers a
    Mamba-2 layer, of b x conv channels and b x d_inner values, and an
    RG-LRU layer, of b x width values twice, in the model's dtype."""
    from repro_torch.models.ssm import dims
    per = {"attn": ("all-reduce", 4 * b * cfg.n_heads
                    + 4 * b * cfg.n_heads * (cfg.head_dim + 1))}
    item = torch.empty((), dtype=cfg.dtype).element_size()
    if cfg.family == "ssm":
        d_in, _, ch = dims(cfg)
        per["ssm"] = ("all-gather", item * b * (ch + d_in))
    per["rec"] = ("all-gather", 2 * item * b * cfg.d_model)
    out = {}
    for t in cfg.block_types:
        kind, nbytes = per[t]
        count, total = out.get(kind, (0, 0))
        out[kind] = (count + 2, total + nbytes)
    return out


@pytest.mark.parametrize("arch", ["paper-edge", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_distributed_decode_collectives_per_layer(arch):
    """``--mesh host --world 2 --distributed-decode`` on decode_32k counts
    the collectives one rank's step issues (its trace, extrapolated over
    the periods as the FLOPs are): two all-reduces per attention layer
    carrying B x nh x 4 and B x nh x (hd + 1) x 4 bytes (B the rank's
    batch, the whole 128 here), two all-gathers per Mamba-2 layer of B x
    ch and B x d_inner elements, both kinds for the hybrid; every other
    kind 0, and the report's totals their sums."""
    cfg = tconfigs.get_config(arch)
    rep = dryrun.lower_cell(arch, "decode_32k",
                            variant=dryrun.Variant(distributed_decode=True),
                            mesh=tmesh.make_host_mesh(2, model=True))
    coll = rep["collectives_single_instance"]
    want = _expected_collectives(cfg, SHAPES["decode_32k"].global_batch)
    got = {k: (v["count"], v["result_bytes"])
           for k, v in coll["per_kind"].items() if v["count"]}
    assert got == want
    assert set(coll["per_kind"]) == set(dryrun.COLL_KINDS)
    for kind, v in coll["per_kind"].items():    # a gather's result: 2 parts
        assert v["operand_bytes"] * (2 if kind == "all-gather" else 1) == \
            v["result_bytes"]
    assert rep["op_cost"]["collectives"] == coll["per_kind"]
    assert rep["roofline"]["collective_bytes_per_device"] == sum(
        n for _, n in want.values()) == coll["result_bytes"]


def test_distributed_decode_hybrid_worked_check():
    """The formula's worked check: recurrentgemma at 14 layers (4
    attention layers), B 4, max_len 4096, posit8 KV, over two ranks: the
    combine all-reduces 264,192 B a step, 4 x 66,048 B, as phase 19c
    measured on the card (the engine's policy there: ``paper_edge_p8``'s
    posit8 KV, its weights hoisted)."""
    from repro_torch.core.transprecision import get_policy
    from repro_torch.models.lm import weights_free
    cfg = dataclasses.replace(tconfigs.get_config("recurrentgemma-9b"),
                              dtype_name="float32", n_layers=14)
    policy = weights_free(dataclasses.replace(get_policy("paper_edge_p8"),
                                              kv_format="posit8"))
    cost = dryrun.step_cost(cfg, ShapeSpec("19c", "decode", 4096, 4),
                            policy, dryrun.Variant(distributed_decode=True),
                            tmesh.make_host_mesh(2, model=True))
    ar = cost["collectives"]["all-reduce"]
    assert (ar["count"], ar["result_bytes"]) == (8, 264_192)
    assert _expected_collectives(cfg, 4) == {
        k: (v["count"], v["result_bytes"])
        for k, v in cost["collectives"].items() if v["count"]}


# ---- kernel calls counted as launches ----

def _kernel_cases():
    """name -> (call on CPU tensors, bytes read, (dtype, n) written)."""
    from repro_torch.core.formats import get as get_fmt
    from repro_torch.core.transprecision import KV_FORMATS
    from repro_torch.kernels import kv_cache as kvk
    from repro_torch.kernels import paged_kv as pkv
    from repro_torch.kernels.posit_decode import posit_decode
    from repro_torch.kernels.posit_encode import posit_encode
    from repro_torch.kernels.posit_matmul import posit_matmul
    from repro_torch.models.attention import decode_attention_packed
    p8 = get_fmt("posit8_2")
    g = torch.Generator().manual_seed(0)
    b, w, h, hd, t, nh, m, k, n = 2, 64, 2, 16, 3, 4, 5, 32, 24
    codes = torch.randint(0, 256, (b, w, h, hd), generator=g,
                          dtype=torch.uint8)
    scale = torch.ones(b, w, h)
    x = torch.randn(b, t, h, hd, generator=g)
    q = torch.randn(b, 1, nh, hd, generator=g)
    cl = torch.tensor([w, 7], dtype=torch.int32)
    pos = torch.tensor([w - 1, 3], dtype=torch.int32)
    pool = codes.reshape(b * w, h, hd)
    table = torch.arange(b * w // 16).reshape(b, -1)
    dst = torch.arange(b * t, dtype=torch.int32).reshape(b, t)
    xm = torch.randn(m, k, generator=g)
    wc = torch.randint(0, 256, (k, n), generator=g, dtype=torch.uint8)
    ring = codes.numel() * 2 + scale.numel() * 8
    # the appends' buffers, written in place by both counts
    ring_bufs = (codes.clone(), scale.clone(), codes.clone(), scale.clone())
    pool_bufs = tuple(t.reshape((b * w,) + t.shape[2:]) for t in ring_bufs)
    rows = [(torch.uint8, b * t * h * hd), (torch.float32, b * t * h)] * 2
    out_q = [(torch.float32, q.numel())]
    return {
        "K1": (lambda: posit_decode(wc, p8), wc.numel(),
               [(torch.float32, wc.numel())]),
        "K2": (lambda: posit_encode(xm, p8), 4 * xm.numel(),
               [(torch.uint8, xm.numel())]),
        "K3": (lambda: kvk.kv_append_rows(*ring_bufs, x, x, pos, p8),
               8 * x.numel() + 8, rows),
        "K4": (lambda: kvk.decode_attention(q, codes, scale, codes, scale,
                                            cl, p8),
               4 * q.numel() + ring + 8, out_q),
        "K4 packed attention": (lambda: decode_attention_packed(
            q, codes, codes, cl, k_scale=scale, v_scale=scale,
            spec=KV_FORMATS["posit8"]), 4 * q.numel() + ring + 8, out_q),
        "K5": (lambda: pkv.paged_kv_append_rows(*pool_bufs, x, x, dst, p8),
               8 * x.numel() + 4 * dst.numel(), rows),
        "K6": (lambda: pkv.paged_decode_attention(
            q, pool, scale.reshape(b * w, h), pool, scale.reshape(b * w, h),
            table, cl, p8, page_size=16),
            4 * q.numel() + ring + 8 * table.numel() + 8, out_q),
        "K7": (lambda: posit_matmul(xm, wc, p8), 4 * xm.numel() + wc.numel(),
               [(torch.float32, m * n)]),
    }


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4",
                                  "K4 packed attention", "K5", "K6", "K7"])
def test_kernel_call_counts_as_one_launch(name):
    from repro_torch.launch.op_cost import analyze
    call, read, written = _kernel_cases()[name]
    plain = analyze(call, ())
    launch = analyze(call, (), kernels="custom_call")
    assert launch["mac_flops"] == plain["mac_flops"]
    n_written = sum(n for _, n in written)
    assert launch["bytes"] == read + sum(
        n * dt.itemsize for dt, n in written)
    assert launch["flops"] == launch["mac_flops"] + n_written
    assert launch["bytes"] < plain["bytes"]


def test_posit_decode_cell_counts_k3_k4_launches():
    """paper-edge decode_32k under posit8 KV on one card: the u8 bytes are
    K4's reads of every layer's K and V rings and K3's writes of a row a
    slot (the plain decode-on-read of the ring would count ~40 TB)."""
    cfg = tconfigs.get_config("paper-edge")
    spec = SHAPES["decode_32k"]
    rep = dryrun.lower_cell(
        "paper-edge", "decode_32k", mesh=tmesh.make_host_mesh(1),
        policy=dataclasses.replace(BF16, kv_format="posit8"))
    per_slot = cfg.n_kv_heads * cfg.head_dim * 2 * cfg.n_layers
    assert rep["op_cost"]["bytes_by_dtype"]["u8"] == (
        spec.global_batch * per_slot * (spec.seq_len + 1))
    cache = rep["memory_analysis"]["argument_bytes_by_part"]["cache"]
    assert cache < rep["op_cost"]["bytes"] < 1.1 * cache
