"""recurrentgemma-9b [hybrid] — RG-LRU + local attention 1:2, arXiv:2402.19427.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000; pattern is
(rec, rec, local-attn) with a 2048-token sliding window (Griffin).
38 = 12 periods x 3 + 2 tail recurrent blocks.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
        d_ff=12288, vocab=256000, mlp="gelu",
        pattern=("rec", "rec", "attn"), window=2048,
        conv_kernel=4, tie_embed=True,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="rgemma-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab=128, mlp="gelu",
        pattern=("rec", "rec", "attn"), window=16,
        conv_kernel=4, tie_embed=True,
    )
