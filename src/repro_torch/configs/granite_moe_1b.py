"""granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base.

24L d_model=1024 16H (GQA kv=8) d_ff=512, MoE 32 experts top-8,
vocab=49155; tied embeddings.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="granite-moe-1b", family="moe",
        n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
        d_ff=512, vocab=49155, mlp="swiglu",
        moe_experts=32, moe_topk=8, capacity_factor=1.25,
        tie_embed=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="granite-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=32, vocab=128, mlp="swiglu",
        moe_experts=8, moe_topk=4, capacity_factor=1.25, tie_embed=True,
    )
