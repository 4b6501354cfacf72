"""The port's sharding spec trees against the reference's, on every
registered arch at full size (shapes only: the meta device in the port,
``abstract=True`` / ``eval_shape`` in the reference).

``launch/mesh.py``'s ``param_specs`` (fsdp "data" and None, and packed
weights under ``SERVE_P8``), ``cache_specs`` at the decode_32k shape,
``batch_specs``, ``train_rules`` / ``serve_rules`` on a fake mesh,
``opt_specs``, ``train/step.py``'s ``state_specs`` and
``models/common.py``'s ``logical_to_spec`` equal the reference's entry for
entry; the reference's divisibility check (``tests/test_sharding.py``)
passes on the port's trees; a paged cache shards its pools' flat rows.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.transprecision import BF16 as J_BF16  # noqa: E402
from repro.core.transprecision import MIXED_TC as J_MIXED_TC  # noqa: E402
from repro.core.transprecision import SERVE_P8 as J_SERVE_P8  # noqa: E402
from repro.core.transprecision import pack_params as j_pack_params  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch.specs import decode_specs  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.transprecision import (BF16, MIXED_TC,  # noqa: E402
                                             SERVE_P8, pack_params)
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import common, lm, serve_model  # noqa: E402
from repro_torch.models.common import P  # noqa: E402
from repro_torch.train.step import TrainState, state_specs  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

AXIS_SIZE = {"pod": 2, "data": 16, "model": 16}
DECODE = SHAPES["decode_32k"]
# the decode_32k rules with production axis names (tests/test_sharding.py)
RULES = {"batch": ("data",), "kv_seq": "model", "ffn": "model",
         "vocab": "model", "expert": "model", "heads": None, "seq": None}
PACKED_ARCHS = ("llama3-8b", "granite-3-8b", "starcoder2-15b")


class FakeMesh:
    """Named axis sizes, as both packages' rules read a mesh."""

    def __init__(self, multi_pod: bool):
        self.axis_names = (("pod",) if multi_pod else ()) + ("data", "model")
        self.shape = {a: AXIS_SIZE[a] for a in self.axis_names}


def _j_flat(tree):
    """{path: spec entries} of a reference spec tree, with the
    reference's path strings."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jmesh._path_str(kp): tuple(s) for kp, s in leaves}


def _t_flat(tree):
    out = {}

    def put(path, spec):
        assert isinstance(spec, P), (path, spec)
        out[path] = tuple(spec)
    mesh.map_with_path(put, tree)
    return out


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference abstract params, port meta params) of ``arch`` at full
    size."""
    j = jlm.init_params(jax.random.PRNGKey(0), j_get_config(arch),
                        abstract=True)
    return j, lm.init_params(get_config(arch), None, device="meta")


def _axis_size(entry):
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([AXIS_SIZE[a] for a in entry]))
    return AXIS_SIZE[entry]


def _check_divisible(tree, specs, what):
    """The reference's check: every dim divides over the axes its spec
    maps it to (a packed weight by its codes' shape)."""
    shapes = {}
    mesh.map_with_path(lambda p, leaf: shapes.__setitem__(p, leaf.shape),
                       tree)
    flat = _t_flat(specs)
    assert set(flat) == set(shapes), what
    for path, spec in flat.items():
        shape = shapes[path]
        assert len(spec) <= len(shape), (what, path, spec, shape)
        for dim, entry in zip(shape, spec):
            assert dim % _axis_size(entry) == 0, (what, path, dim, spec)


@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, fsdp):
    j, t = _params(arch)
    want = _j_flat(jmesh.param_specs(j, fsdp=fsdp))
    got = _t_flat(mesh.param_specs(t, fsdp=fsdp))
    assert got == want
    if fsdp:
        _check_divisible(t, mesh.param_specs(t, fsdp=fsdp), arch)


@pytest.mark.parametrize("arch", PACKED_ARCHS)
def test_packed_param_specs_equal_reference(arch):
    """One spec per packed weight, from its codes' shape."""
    j, t = _params(arch)
    jp = j_pack_params(j, J_SERVE_P8, abstract=True)
    tp = pack_params(t, SERVE_P8)
    specs = mesh.param_specs(tp, fsdp=None)
    assert _t_flat(specs) == _j_flat(jmesh.param_specs(jp, fsdp=None))
    _check_divisible(tp, specs, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch):
    jcache, _ = decode_specs(j_get_config(arch), DECODE)
    tcache = serve_model.init_cache(get_config(arch), DECODE.global_batch,
                                    DECODE.seq_len, device="meta")
    specs = mesh.cache_specs(tcache, get_config(arch), RULES)
    assert _t_flat(specs) == _j_flat(
        jmesh.cache_specs(jcache, j_get_config(arch), RULES))
    _check_divisible(tcache, specs, arch)


def test_paged_cache_specs_shard_the_pool_rows():
    """The reference's rule has no paged case (its pool leaves have no
    batch axis); the port shards a pool's flat rows on the KV axis."""
    cfg = get_config("paper-edge")
    pol = dataclasses.replace(SERVE_P8, kv_format="posit8",
                              kv_layout="paged", kv_page_size=16)
    cache = serve_model.init_cache(cfg, 8, 1024, policy=pol, num_pages=258,
                                   device="meta")
    flat = _t_flat(mesh.cache_specs(cache, cfg, RULES))
    assert flat["blocks/0/k"] == (None, "model", None, None)
    assert flat["blocks/0/k_scale"] == (None, "model", None)
    assert flat["page_table"] == (None, None) and flat["pos"] == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_specs_equal_reference(arch):
    for rules in (RULES, {"batch": None}):
        got = mesh.batch_specs(get_config(arch), rules)
        want = jmesh.batch_specs(j_get_config(arch), rules)
        assert {k: tuple(v) for k, v in got.items()} == {
            k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_rules_and_meshes_equal_reference(multi_pod):
    fake = FakeMesh(multi_pod)
    ours = mesh.make_production_mesh(multi_pod=multi_pod)
    assert ours.axis_names == fake.axis_names
    assert ours.shape == fake.shape
    for gb in (256, 1):                         # train_4k; long_500k
        for kw in ({}, {"seq_shard": False, "heads_shard": True}):
            assert mesh.train_rules(ours, global_batch=gb, **kw) == \
                jmesh.train_rules(fake, global_batch=gb, **kw)
        assert mesh.serve_rules(ours, global_batch=gb) == \
            jmesh.serve_rules(fake, global_batch=gb)
    host = mesh.make_host_mesh(2)
    assert host.axis_names == ("data", "model") and host.shape == {
        "data": 2, "model": 1}


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_and_state_specs_equal_reference(arch):
    j, t = _params(arch)
    jps, tps = jmesh.param_specs(j), mesh.param_specs(t)
    assert _t_flat(mesh.opt_specs(tps)) == _j_flat(jmesh.opt_specs(jps))
    for jpol, tpol in ((J_BF16, BF16), (J_MIXED_TC, MIXED_TC)):
        got = state_specs(get_config(arch), tps, tpol)
        want = jstep.state_specs(j_get_config(arch), jps, jpol)
        assert isinstance(got, TrainState)
        assert _t_flat(got.params) == _j_flat(want.params)
        assert _t_flat(got.opt) == _j_flat(want.opt)
        assert (got.ef_residual is None) == (want.ef_residual is None)
        if got.ef_residual is not None:
            assert _t_flat(got.ef_residual) == _j_flat(want.ef_residual)


def test_logical_to_spec_equals_reference():
    names = ("batch", None, "kv_seq", "heads", "vocab")
    rules = jmesh.serve_rules(FakeMesh(True), global_batch=256)
    assert tuple(common.logical_to_spec(names)) == (None,) * 5
    with common.axis_rules(rules), jcommon.axis_rules(rules):
        assert tuple(common.logical_to_spec(names)) == tuple(
            jcommon.logical_to_spec(names))
    assert tuple(common.logical_to_spec(names)) == (None,) * 5
