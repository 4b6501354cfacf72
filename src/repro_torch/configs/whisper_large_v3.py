"""whisper-large-v3 [audio] — encoder-decoder, arXiv:2212.04356.

32L (decoder) d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866;
a 32-layer encoder over 1500 mel frames.  The conv frontend is a stub, as
in the reference: a clip arrives as precomputed frame embeddings (B,
1500, d_model).  Decoding reads the decoder's self-K/V and the fixed
1500-frame cross-attention memory.
"""
from ..models.lm import ModelCfg


def full() -> ModelCfg:
    return ModelCfg(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab=51866, mlp="gelu",
        enc_layers=32, enc_seq=1500,
    )


def smoke() -> ModelCfg:
    return ModelCfg(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, mlp="gelu",
        enc_layers=2, enc_seq=24,
    )
