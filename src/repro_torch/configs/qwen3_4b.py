"""qwen3-4b [dense] — qk_norm + GQA, hf:Qwen/Qwen3 family.

36L d_model=2560 32H (GQA kv=8, head_dim=128) d_ff=9728 vocab=151936.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_head=128,
        d_ff=9728, vocab=151936, mlp="swiglu",
        rope_theta=1000000.0, qk_norm=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=128, vocab=160, mlp="swiglu", qk_norm=True,
    )
