"""The PyTorch port stands alone: it imports neither ``jax`` nor ``repro``,
its entry points (ring and paged serving, the matmul kernel, training and
the quickstart, speculative serving, the Trainer, the data shards, the
train and serve launchers, the orchestrator, the vlm and audio models'
prefill and caches, the distributed engine) default to the GPU and raise without one, and what is
left to later work raises ``NotImplementedError`` (the KV-sequence-sharded
decode of the SSM stack)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.transprecision import TCPolicy, get_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models import lm, serve_model  # noqa: E402
from repro_torch.models.lm import ModelCfg  # noqa: E402
from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serve.engine_api import TransprecisionEngine  # noqa: E402
from _torch_threads import torch_threads  # noqa: E402,F401

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")
# modules of the quickstart / training slice the import checks must reach
SLICE3 = ("repro_torch.kernels.posit_matmul", "repro_torch.kernels.ops",
          "repro_torch.quickstart", "repro_torch.optim.adamw",
          "repro_torch.data.pipeline", "repro_torch.train.step")
# ... and of speculative serving
SPECULATIVE = ("repro_torch.serve.speculative",)
# ... and of the rest of training
TRAINING = ("repro_torch.optim.compression",
            "repro_torch.checkpoint.manager", "repro_torch.train.trainer",
            "repro_torch.train.fault_tolerance", "repro_torch.launch.train")
# ... and of the orchestrator and its robustness
ROBUSTNESS = ("repro_torch.serve.faults", "repro_torch.serve.guard",
              "repro_torch.serve.orchestrator", "repro_torch.obs.report",
              "repro_torch.launch.serve")
# ... and of the modeled energy accounting
ENERGY = ("repro_torch.obs.energy", "repro_torch.launch.op_cost")
# ... and of the MoE family and the registered configs
MOE = ("repro_torch.models.moe", "repro_torch.configs.granite_moe_1b",
       "repro_torch.configs.phi35_moe", "repro_torch.configs.llama3_8b",
       "repro_torch.configs.granite_3_8b", "repro_torch.configs.qwen3_4b",
       "repro_torch.configs.starcoder2_15b")
# ... and of the hybrid family
HYBRID = ("repro_torch.models.rglru", "repro_torch.configs.recurrentgemma_9b")
# ... and of the vlm and audio families
VLM_AUDIO = ("repro_torch.configs.qwen2_vl_2b",
             "repro_torch.configs.whisper_large_v3")
# ... and of the distributed decode and the sharding spec trees
DISTRIBUTED = ("repro_torch.serve.distributed", "repro_torch.launch.mesh")
# ... and of the exact posit arithmetic, the TALU simulator and the dry run
ARITH_DRYRUN = ("repro_torch.core.posit_ref", "repro_torch.core.qfunc",
                "repro_torch.core.talu", "repro_torch.launch.specs",
                "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_all")
REACHED = (SLICE3 + SPECULATIVE + TRAINING + ROBUSTNESS + ENERGY + MOE
           + HYBRID + VLM_AUDIO + DISTRIBUTED + ARITH_DRYRUN)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_repro_imports_in_source():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    names = {".".join(("repro_torch",) + f.relative_to(PKG).with_suffix(
        "").parts) for f in files}
    assert set(REACHED) <= names, set(REACHED) - names
    for f in files:
        for mod in _imported(ast.parse(f.read_text())):
            assert mod.split(".")[0] not in FORBIDDEN, (f, mod)


def test_whole_port_imports_without_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        f"missing = set({REACHED!r}) - set(sys.modules)\n"
        "assert not missing, missing\n"
        "print('ok', len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TransprecisionEngine(cfg, get_policy("bf16"), 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_model.init_cache(cfg, 2, 32)
    from repro_torch.serve.distributed import KVShard, make_distributed_engine
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        make_distributed_engine(cfg, get_policy("bf16"), 2, 32)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_model.init_cache(cfg, 2, 32, kv_shard=KVShard())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        lm.init_params(cfg)
    from repro_torch.convert import params_from_numpy
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        params_from_numpy({"w": np.zeros(2, np.float32)})


def test_kernel_build_raises_without_nvcc():
    """No silent plain-version fallback: without the CUDA toolkit the
    kernel libraries cannot load, and that raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the kernels build there")
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.lib("kv_cache")


def test_later_slices_raise_not_implemented():
    """Every family of the reference is ported (the vlm and audio ones
    were the last slice): their configs build and an unknown family
    raises ``ValueError``; remat "dots" runs for the audio decoder block
    (a later slice); the distributed decode of the SSM stack, which holds
    no KV sequence, builds (its recurrent state splits over ranks)."""
    cfg = get_config("paper-edge", smoke=True)
    assert ModelCfg(family="vlm", mrope=True).family == "vlm"
    assert get_config("qwen2-vl-2b").mrope
    assert get_config("whisper-large-v3", smoke=True).enc_layers == 2
    with pytest.raises(ValueError, match="unknown family"):
        ModelCfg(family="diffusion")
    audio = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                                remat="dots")
    audio_params = lm.init_params(audio, torch.Generator().manual_seed(0),
                                  device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long),
             "labels": torch.zeros((1, 4), dtype=torch.long),
             "frames": torch.zeros((1, audio.enc_seq, audio.d_model))}
    assert torch.isfinite(lm.loss_fn(audio_params, batch, audio)[0])
    from repro_torch.serve import KVShard, make_distributed_decode_step
    assert make_distributed_decode_step(
        get_config("mamba2-2.7b", smoke=True), "bf16").shard == KVShard()
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    # the numeric guard, fault injection and retry are ported (they were
    # a later slice): the engine takes them
    from repro_torch.serve import FaultPlan, RetryPolicy
    eng = ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=32),
                        device="cpu", guard=True, faults=FaultPlan(),
                        retry=RetryPolicy())
    assert eng.guard is not None and eng.engine.retry is eng.retry
    assert eng.engine.faults is eng.faults is not None
    # the energy accounting and every family are ported (they were a
    # later slice): the launcher serves the vlm arch
    from repro_torch.launch import serve as launch_serve
    out = launch_serve.main(["--device", "cpu", "--arch", "qwen2-vl-2b",
                             "--requests", "2", "--max-new", "2",
                             "--batch", "2", "--max-len", "32"])
    assert all(r.done and r.error is None for r in out["requests"])


def test_vlm_and_audio_entry_points_default_to_gpu():
    """The vlm and audio models' entry points (init, caches, the
    pipeline's embeddings) run on the card unless the caller asks for
    the CPU, and raise without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch.data.pipeline import make_pipeline
    for arch in ("qwen2-vl-2b", "whisper-large-v3"):
        cfg = get_config(arch, smoke=True)
        for call in (lambda: lm.init_params(cfg),
                     lambda: serve_model.init_cache(cfg, 2, 32),
                     lambda: make_pipeline(cfg, global_batch=2,
                                           seq_len=8)(0)):
            with pytest.raises(RuntimeError, match="no CUDA GPU"):
                call()
        cache = serve_model.init_cache(cfg, 2, 32, device="cpu")
        assert cache["pos"].device.type == "cpu"
        assert ("memory" in cache) == (cfg.family == "audio")


def test_paged_entry_points_default_to_gpu():
    """The paged layout's entry points run on the card unless the caller
    asks for the CPU, and raise without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    scfg = ServeConfig(max_batch=2, max_len=32, kv_format="posit8",
                       kv_layout="paged", page_size=4)
    paged = TCPolicy(name="p", kv_format="posit8", kv_layout="paged")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine(cfg, params, scfg)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        TransprecisionEngine(cfg, paged, 2, 32, num_pages=5)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        serve_model.init_cache(cfg, 2, 32, policy=paged)
    eng = ServingEngine(cfg, params, scfg, device="cpu")
    assert eng.paged and eng.cache["page_table"].device.type == "cpu"


def test_training_and_quickstart_entry_points_default_to_gpu():
    """The slice-3 entry points (train state, data pipeline, weight
    bridge, quickstart parts) run on the card unless the caller asks for
    the CPU, and raise without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch import quickstart
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.step import init_train_state
    cfg = get_config("paper-edge", smoke=True)
    for call in (lambda: init_train_state(cfg, AdamWConfig()),
                 lambda: make_pipeline(cfg, global_batch=2, seq_len=8)(0),
                 lambda: train_state_from_numpy(
                     {"w": np.zeros((2, 2), np.float32)}),
                 quickstart.codec_roundtrip, quickstart.posit_matmul_demo,
                 quickstart.train_step_demo, lambda: quickstart.main([])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_speculative_engine_defaults_to_gpu():
    """The speculative engine runs on the card unless the caller asks for
    the CPU, and raises without a GPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch.serve.speculative import SpeculativeEngine
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for layout in ("ring", "paged"):
        scfg = ServeConfig(max_batch=2, max_len=32, kv_format="posit8",
                           kv_layout=layout, page_size=4)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            SpeculativeEngine(cfg, params, scfg)
        eng = SpeculativeEngine(cfg, params, scfg, device="cpu")
        assert eng.draft_cache["blocks"][0]["k"].device.type == "cpu"


def test_trainer_checkpoint_shards_and_launcher_default_to_gpu():
    """The rest of training runs on the card unless the caller asks for
    the CPU, and raises without a GPU: the Trainer, a host's data shard
    and the train launcher.  (A checkpoint restore has no device of its
    own: it copies into the template's tensors.)"""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.train import Trainer, TrainerConfig
    cfg = get_config("paper-edge", smoke=True)
    for call in (lambda: Trainer(cfg, TrainerConfig(steps=1)),
                 lambda: make_pipeline(cfg, global_batch=2,
                                       seq_len=8).host_batch(0, 1, 2),
                 lambda: launch_train.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            call()


def test_serve_launcher_and_orchestrator_default_to_gpu():
    """The serve launcher runs on the card unless ``--device cpu`` is
    given, and raises without a GPU; a guarded engine the orchestrator
    drives does too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import FaultPlan
    cfg = get_config("paper-edge", smoke=True)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    for argv in ([], ["--async", "--fault-plan", "random:seed=3,n=6"],
                 ["--speculative", "--async"]):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            launch_serve.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ServingEngine(cfg, params, ServeConfig(max_batch=2, max_len=32),
                      guard=True, faults=FaultPlan.random(3))


def test_mamba2_state_defaults_to_gpu():
    """``ssm.init_mamba2_state`` runs on the card unless the caller asks
    for the CPU (its serving caller passes the cache's device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the default device is valid")
    from repro_torch.models.ssm import init_mamba2_state
    cfg = get_config("mamba2-2.7b", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        init_mamba2_state(cfg, 2)
    conv, state = init_mamba2_state(cfg, (3, 2), device="cpu")
    assert conv.device.type == state.device.type == "cpu"
    assert conv.shape[:2] == state.shape[:2] == (3, 2)
    cache = serve_model.init_cache(cfg, 2, 32, device="meta")
    assert cache["blocks"][0]["state"].device.type == "meta"


def test_dry_run_sets_no_xla_flags():
    """The port's dry run is imported and run without touching
    ``XLA_FLAGS`` (the reference's sets it at import)."""
    code = ("import os\n"
            "import repro_torch.launch.dryrun_all, repro_torch.launch.dryrun\n"
            "print(os.environ.get('XLA_FLAGS', 'unset'))\n")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(PKG.parent)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "unset"
