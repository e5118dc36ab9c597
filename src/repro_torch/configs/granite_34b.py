"""granite-34b [dense] — arXiv:2405.04324 (Granite Code).

88L d_model=6144 48H (GQA kv=1 → MQA) d_ff=24576 vocab=49152.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="granite-34b",
    family=ModelFamily.DENSE,
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab=49152,
    segments=((("attn",), 88),),
    tie_embeddings=True,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="granite-smoke",
        family=ModelFamily.DENSE,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        segments=((("attn",), 3),),
        tie_embeddings=True,
        max_decode_len=64,
    )
