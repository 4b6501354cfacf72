"""mamba2-2.7b [ssm] — SSD (state-space duality), arXiv:2405.21060.

64L d_model=2560, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*2560 = 5120, headdim 64 -> 80 SSD heads, 1 B/C group.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, d_ff=0, vocab=50280,
        n_heads=1, n_kv_heads=1,           # unused (attn-free)
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        ssm_groups=1, conv_kernel=4,
        tie_embed=True,                    # mamba2 ties lm_head to embedding
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, d_ff=0, vocab=128,
        n_heads=1, n_kv_heads=1,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_chunk=32,
        ssm_groups=1, conv_kernel=4, tie_embed=True,
    )
