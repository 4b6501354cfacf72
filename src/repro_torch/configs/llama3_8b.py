"""llama3-8b [dense] — GQA, 128k vocab, arXiv:2407.21783.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, rope 500k.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=128256, mlp="swiglu",
        rope_theta=500000.0,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="llama3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=128, mlp="swiglu", rope_theta=500000.0,
    )
