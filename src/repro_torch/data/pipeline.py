"""Deterministic synthetic LM batches (port of ``repro.data.pipeline``).

Batch content is a pure function of (seed, step): the numpy builder is the
reference's, so both packages draw identical tokens and labels for the same
(seed, step).  The stream is affine orbits ``x[t+1] = (a * x[t] + b) %
vocab`` with sampled (a, b), so a model can learn it and the loss falls.
The sharding is elastic: ``host_batch(step, host, n_hosts)`` is host
``host``'s contiguous slice of the same global batch for any world size,
so resizing the fleet neither drops nor repeats data (``ElasticPlan``).
A vlm model's batch carries the stub frontend's patch embeddings
(``embeds``, (B, S, d) f32 from ``default_rng(seed + 7 + step)``) in
place of ``tokens``; an audio model's adds frame embeddings (``frames``,
(B, enc_seq, d) f32 from ``default_rng(seed + 13 + step)``), as the
reference draws them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models.lm import ModelCfg


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    vocab: int = 256


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cuda",
                 model_cfg: Optional[ModelCfg] = None):
        self.cfg = cfg
        self.device = device
        self.model_cfg = model_cfg

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(np.uint64(c.seed * 1_000_003 + step))
        a = 1 + 2 * rng.integers(0, 16, (c.global_batch, 1))   # odd
        b = rng.integers(0, c.vocab, (c.global_batch, 1))
        x0 = rng.integers(0, c.vocab, (c.global_batch, 1))
        toks = np.empty((c.global_batch, c.seq_len), np.int64)
        cur = x0[:, 0]
        for i in range(c.seq_len):
            toks[:, i] = cur
            cur = (a[:, 0] * cur + b[:, 0]) % c.vocab
        labels = np.concatenate([toks[:, 1:], cur[:, None]], axis=1)
        batch = {"tokens": toks.astype(np.int32),
                 "labels": labels.astype(np.int32)}
        mc = self.model_cfg
        if mc is not None and mc.family == "vlm":
            emb_rng = np.random.default_rng(np.uint64(c.seed + 7 + step))
            batch["embeds"] = emb_rng.standard_normal(
                (c.global_batch, c.seq_len, mc.d_model)).astype(np.float32)
            del batch["tokens"]
        if mc is not None and mc.family == "audio":
            emb_rng = np.random.default_rng(np.uint64(c.seed + 13 + step))
            batch["frames"] = emb_rng.standard_normal(
                (c.global_batch, mc.enc_seq, mc.d_model)).astype(np.float32)
        return batch

    def host_batch(self, step: int, host: int, n_hosts: int
                   ) -> Dict[str, torch.Tensor]:
        """Host ``host``'s slice (of ``n_hosts`` equal ones) of the step's
        global batch, as tensors on the pipeline's device (integer fields
        int64, embeddings float32)."""
        bsz = self.cfg.global_batch
        if bsz % n_hosts:
            raise ValueError(f"global_batch {bsz} must divide over "
                             f"{n_hosts} hosts")
        per = bsz // n_hosts
        return self._to_device({k: v[host * per:(host + 1) * per]
                                for k, v in self.global_batch(step).items()})

    def __call__(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch as tensors on the pipeline's device (integer
        fields int64, embeddings float32)."""
        return self._to_device(self.global_batch(step))

    def _to_device(self, batch) -> Dict[str, torch.Tensor]:
        dev = resolve_device(self.device)
        return {k: torch.from_numpy(
            v if v.dtype == np.float32 else v.astype(np.int64)).to(dev)
            for k, v in batch.items()}


def make_pipeline(model_cfg: ModelCfg, *, global_batch: int, seq_len: int,
                  seed: int = 0, device="cuda") -> SyntheticLM:
    return SyntheticLM(
        DataConfig(seed=seed, global_batch=global_batch, seq_len=seq_len,
                   vocab=model_cfg.vocab), device, model_cfg)
