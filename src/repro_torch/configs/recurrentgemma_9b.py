"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin).

38 blocks d_model=4096 16H (GQA kv=1 → MQA local attention) d_ff=12288
(GeGLU) vocab=256000 — RG-LRU + local attention in a 2:1 pattern
(rec, rec, attn)×12 + (rec, rec); local window 2048.  Linear recurrence
→ runs ``long_500k``.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family=ModelFamily.HYBRID,
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    segments=((("rec", "rec", "attn_geglu"), 12), (("rec", "rec"), 1)),
    window=2048,
    tie_embeddings=True,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-smoke",
        family=ModelFamily.HYBRID,
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab=256,
        segments=((("rec", "rec", "attn_geglu"), 1), (("rec", "rec"), 1)),
        window=16,
        tie_embeddings=True,
        max_decode_len=64,
    )
