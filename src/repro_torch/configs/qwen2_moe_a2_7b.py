"""qwen2-moe-a2.7b [moe] — hf:Qwen/Qwen1.5-MoE-A2.7B.

24L d_model=2048 16H (kv=16, MHA) d_ff=1408 (per expert), vocab=151936,
MoE 4 shared + 60 routed top-4.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="qwen2-moe-a2.7b",
    family=ModelFamily.MOE,
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=151936,
    segments=((("moe_attn",), 24),),
    num_experts=60,
    top_k=4,
    num_shared_experts=4,
    moe_d_ff=1408,
    tie_embeddings=False,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen2-moe-smoke",
        family=ModelFamily.MOE,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        vocab=256,
        segments=((("moe_attn",), 2),),
        num_experts=6,
        top_k=2,
        num_shared_experts=2,
        moe_d_ff=32,
        tie_embeddings=False,
        max_decode_len=64,
    )
