"""qwen3-32b [dense] — hf:Qwen/Qwen3 family.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936 — qk-norm.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="qwen3-32b",
    family=ModelFamily.DENSE,
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_ff=25600,
    vocab=151936,
    segments=((("attn",), 64),),
    qk_norm=True,
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-smoke",
        family=ModelFamily.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        segments=((("attn",), 2),),
        qk_norm=True,
        tie_embeddings=False,
        max_decode_len=64,
    )
