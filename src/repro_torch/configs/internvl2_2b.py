"""internvl2-2b [vlm] — arXiv:2404.16821.

LM backbone (InternLM2-1.8B): 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The InternViT frontend is a STUB: ``input_specs`` provides
precomputed patch embeddings (256 patches) prepended to the text stream.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="internvl2-2b",
    family=ModelFamily.VLM,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    segments=((("attn",), 24),),
    num_patches=256,
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="internvl2-smoke",
        family=ModelFamily.VLM,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        segments=((("attn",), 2),),
        num_patches=8,
        tie_embeddings=False,
        max_decode_len=64,
    )
