"""musicgen-medium [audio] — arXiv:2306.05284.

48L d_model=1536 24H (kv=24, MHA) d_ff=6144 vocab=2048 — decoder-only
over 4 parallel EnCodec codebooks (summed embeddings, 4 readout heads).
The EnCodec/text-conditioning frontend is a STUB — token streams arrive
precomputed via ``input_specs``.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="musicgen-medium",
    family=ModelFamily.AUDIO,
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    segments=((("attn",), 48),),
    n_codebooks=4,
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="musicgen-smoke",
        family=ModelFamily.AUDIO,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=64,
        segments=((("attn",), 2),),
        n_codebooks=4,
        tie_embeddings=False,
        max_decode_len=64,
    )
