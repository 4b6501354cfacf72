"""starcoder2-15b [dense] — GQA + RoPE, arXiv:2402.19173.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152; non-gated GELU MLP.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="starcoder2-15b", family="dense",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4,
        d_ff=24576, vocab=49152, mlp="gelu",
        rope_theta=100000.0,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="starcoder2-smoke", family="dense",
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        d_ff=192, vocab=128, mlp="gelu",
    )
