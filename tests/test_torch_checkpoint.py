"""Checkpoints of the port (``repro_torch.checkpoint``) and their
exchange with the reference's ``repro.checkpoint``.

The state is a whole train state of smoke paper-edge at bf16 under a
gradient-wire policy: bf16 params, the f32 AdamW master and moments, the
int32 step and the f32 error-feedback residual.  Everything is held bit
for bit (bf16 crosses as float32, which is exact): the round trip, both
directions between the packages (``CheckpointManager`` and
``save_pytree`` / ``load_pytree``), the reference's keys, atomicity
(a ``.tmp`` or an uncommitted step is never picked), keep-k, and an async
write error surfacing on ``wait()`` and on the next ``save()``.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import load_pytree as jload  # noqa: E402
from repro.checkpoint import save_pytree as jsave  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.transprecision import MIXED_TC as JMIXED  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager, load_pytree,  # noqa: E402
                                    save_pytree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import MIXED_TC  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.step import init_train_state  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

CFG = get_config("paper-edge", smoke=True)


def _state(seed):
    """A port train state with every leaf distinct from a fresh one: the
    moments, the step and the residual filled from a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    st = init_train_state(CFG, AdamWConfig(), MIXED_TC, generator=gen,
                          device="cpu")
    for tree in (st.opt["mu"], st.opt["nu"], st.ef_residual):
        for leaf in _leaves(tree):
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    st.opt["step"].fill_(seed + 3)
    return st


def _leaves(tree):
    from repro_torch.checkpoint.manager import _flatten
    return list(_flatten(tree).values())


def _flat(tree):
    from repro_torch.checkpoint.manager import _flatten
    return _flatten(tree)


def _bits(t):
    """A tensor's bit pattern as numpy (bf16 viewed as int16)."""
    t = t.detach().cpu()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
        else t.numpy()


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(_bits(g[k]), _bits(w[k]), err_msg=k)


def _np(tree):
    """The reference's state as {key: float32 or int32 numpy}."""
    from repro.checkpoint.manager import _flatten as jflat
    return {k: np.asarray(v, np.float32) if v.dtype == jnp.bfloat16
            else np.asarray(v) for k, v in jflat(tree).items()}


def test_round_trip_is_bit_exact(tmp_path):
    st = _state(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(st, 7)
    assert mgr.latest_step() == 7
    assert sorted(os.listdir(tmp_path / "step_7")) == [
        "COMMIT", "arrays.npz", "meta.json"]
    other = _state(1)
    restored, meta = mgr.restore(other)
    assert meta["step"] == 7
    # restored in place: the template's own tensors hold the values
    for a, b in zip(_leaves(restored), _leaves(other)):
        assert a is b
    assert restored.params["embed"].dtype == torch.bfloat16
    _assert_trees_equal(restored, _state(0))


def test_keys_are_the_references(tmp_path):
    st = _state(0)
    CheckpointManager(str(tmp_path)).save(st, 1)
    with np.load(tmp_path / "step_1" / "arrays.npz") as z:
        keys = set(z.files)
        assert z["0|embed"].dtype == np.float32         # bf16 widened
        assert z["1|step"].dtype == np.int32
    jst = jinit(jax.random.PRNGKey(0), jget_config("paper-edge", smoke=True),
                JAdamW(), JMIXED)
    assert keys == set(_np(jst))
    assert {"0|blocks|0|wq", "1|master|embed", "1|step",
            "2|blocks|0|wi"} <= keys


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jst = jinit(jax.random.PRNGKey(3), jget_config("paper-edge", smoke=True),
                JAdamW(), JMIXED)
    jst.opt["step"] = jnp.int32(5)
    jst.ef_residual = jax.tree.map(lambda r: r + 0.25, jst.ef_residual)
    JManager(str(tmp_path)).save(jst, 5)
    restored, meta = CheckpointManager(str(tmp_path)).restore(_state(0))
    assert meta["step"] == 5
    want = _np(jst)
    got = _flat(restored)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].float().numpy()
                                      if got[k].is_floating_point()
                                      else got[k].numpy(), w, err_msg=k)
    assert restored.params["blocks"][0]["wq"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    st = _state(2)
    CheckpointManager(str(tmp_path)).save(st, 4)
    template = jax.tree.map(lambda leaf: np.zeros(leaf.shape, leaf.dtype),
                            jax.eval_shape(lambda: jinit(
                                jax.random.PRNGKey(0),
                                jget_config("paper-edge", smoke=True),
                                JAdamW(), JMIXED)))
    tree, meta = JManager(str(tmp_path)).restore(template)
    assert meta["step"] == 4
    got = _np(tree)
    want = _flat(st)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w.float().numpy()
                                      if w.is_floating_point()
                                      else w.numpy(), err_msg=k)
    assert tree.params["embed"].dtype == jnp.bfloat16


def test_save_and_load_pytree_cross(tmp_path):
    st = _state(4)
    save_pytree(st.params, str(tmp_path / "port.npz"))
    jtemplate = jax.tree.map(
        lambda t: np.zeros(t.shape, jnp.bfloat16 if t.dtype == torch.bfloat16
                           else np.float32), st.params)
    jtree = jload(jtemplate, str(tmp_path / "port.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(jtree),
                    jax.tree_util.tree_leaves(_np_params(st.params))):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    jsave(jax.tree.map(lambda a, t: jnp.asarray(
        a, jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32),
        _np_params(st.params), st.params), str(tmp_path / "ref.npz"))
    got = load_pytree(_state(5).params, str(tmp_path / "ref.npz"))
    _assert_trees_equal(got, st.params)


def _np_params(params):
    """Port params as a numpy tree (bf16 widened) in the same nesting."""
    return jax.tree.map(lambda t: t.float().numpy(), params)


def test_stale_tmp_and_uncommitted_steps_are_never_picked(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_state(0), 2)
    (tmp_path / "step_9.tmp").mkdir()                 # a crash mid-write
    (tmp_path / "step_9.tmp" / "COMMIT").write_text("x")
    (tmp_path / "step_8").mkdir()                     # no COMMIT marker
    assert mgr.steps() == [2] and mgr.latest_step() == 2
    restored, meta = mgr.restore(_state(1))
    assert meta["step"] == 2
    _assert_trees_equal(restored, _state(0))


def test_keep_k_and_async_saves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = _state(0)
    for s in range(1, 6):
        st.opt["step"].fill_(s)
        st.opt["mu"]["embed"].fill_(s)
        mgr.save(st, s, blocking=False)
        # the snapshot is taken before save() returns: updating the
        # state now does not reach the file being written
        st.opt["mu"]["embed"].fill_(-1.0)
        st.params["embed"].zero_()
    mgr.wait()
    assert mgr.steps() == [4, 5]
    restored, meta = mgr.restore(_state(1))
    assert meta["step"] == 5 and int(restored.opt["step"]) == 5
    assert bool((restored.opt["mu"]["embed"] == 5.0).all())
    assert torch.equal(restored.params["embed"], torch.zeros_like(
        restored.params["embed"]))
    assert torch.equal(restored.params["lm_head"],
                       _state(0).params["lm_head"])


def test_async_error_surfaces_on_wait_and_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_3.tmp").write_text("a file where the dir goes")
    mgr.save(_state(0), 3, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.wait()
    mgr.wait()                                       # reported once
    mgr.save(_state(0), 3, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint failed"):
        mgr.save(_state(0), 4)
    assert mgr.latest_step() is None


def test_restore_checks_shapes_and_keys(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.restore(_state(0)) == (None, None)
    mgr.save(_state(0).params, 1)
    with pytest.raises(ValueError, match="missing key"):
        mgr.restore(_state(0))
    bad = _state(0).params
    bad["embed"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(bad)
    # restore copies into tensors: a numpy template leaf is refused
    with pytest.raises(TypeError, match="expected a tensor"):
        mgr.restore({k: (v.float().numpy() if k == "embed" else v)
                     for k, v in _state(0).params.items()})
