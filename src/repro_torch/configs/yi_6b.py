"""yi-6b [dense] — arXiv:2403.04652.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="yi-6b",
    family=ModelFamily.DENSE,
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    segments=((("attn",), 32),),
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="yi-smoke",
        family=ModelFamily.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        segments=((("attn",), 2),),
        tie_embeddings=False,
        max_decode_len=64,
    )
