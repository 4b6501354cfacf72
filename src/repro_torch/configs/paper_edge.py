"""paper-edge — the paper's own deployment point: a small edge LM served
with the P(8,2) transprecision policy (§IV-D)."""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    # ~125M params: 12 layers, d_model 768, 12/4 heads of 64, vocab 32000
    return ModelCfg(
        name="paper-edge-100m", family="dense",
        n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
        d_ff=2048, vocab=32000, mlp="swiglu",
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="paper-edge-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=256, mlp="swiglu",
    )
