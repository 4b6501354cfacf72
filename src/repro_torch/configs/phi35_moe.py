"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct.

32L d_model=4096 32H (GQA kv=8) d_ff=6400, MoE 16 experts top-2,
vocab=32064.  41.87 B params: about 83.7 GB in bf16, more than one
80 GB card holds, so it serves at smoke size only.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="phi3.5-moe-42b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, mlp="swiglu",
        moe_experts=16, moe_topk=2, capacity_factor=1.25,
        rope_theta=10000.0,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="phi35-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=96, vocab=128, mlp="swiglu",
        moe_experts=4, moe_topk=2, capacity_factor=1.25,
    )
