"""qwen2-vl-2b [vlm] — M-RoPE + dynamic resolution, arXiv:2409.12191.

28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936.
The vision frontend is a stub, as in the reference: a prompt of patches
arrives as precomputed patch embeddings (B, S, d_model); the backbone
(the M-RoPE section split included) is real.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="qwen2-vl-2b", family="vlm",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_head=128,
        d_ff=8960, vocab=151936, mlp="swiglu",
        rope_theta=1000000.0, mrope=True, tie_embed=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="qwen2vl-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=32,
        d_ff=128, vocab=128, mlp="swiglu", mrope=True, tie_embed=True,
    )
