"""h2o-danube-3-4b [dense] — arXiv:2401.16818 family.

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — llama+mistral
mix with sliding-window attention (window 4096) → runs ``long_500k``.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="h2o-danube-3-4b",
    family=ModelFamily.DENSE,
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab=32000,
    segments=((("attn",), 24),),
    window=4096,
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="h2o-danube-smoke",
        family=ModelFamily.DENSE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        segments=((("attn",), 2),),
        window=16,
        tie_embeddings=False,
        max_decode_len=64,
    )
