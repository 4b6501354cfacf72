"""granite-3-8b [dense] — GQA, hf:ibm-granite/granite-3.0 family.

40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155; tied embeddings.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="granite-3-8b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=12800, vocab=49155, mlp="swiglu",
        rope_theta=10000.0, tie_embed=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=131, mlp="swiglu", tie_embed=True,
    )
