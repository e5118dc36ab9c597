"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L d_model=7168 128H (GQA kv=128 → MHA-shaped, realized as MLA)
d_ff=2048 (per routed expert), vocab=129280, MoE 1 shared + 256 routed
top-8, MTP head.  First 3 layers dense (inter 18432 per the paper).
"""
import torch

from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="deepseek-v3-671b",
    family=ModelFamily.MOE,
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=2048,           # routed expert width (assigned spec)
    dense_d_ff=18432,    # dense-layer FFN width (paper)
    vocab=129280,
    segments=((("mla_dense",), 3), (("mla_moe",), 58)),
    num_experts=256,
    top_k=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    mtp=True,
    tie_embeddings=False,
    remat="full",
    # bf16 weights, as the JAX config has them (671 B parameters)
    param_dtype=torch.bfloat16,
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v3-smoke",
        family=ModelFamily.MOE,
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=32,
        dense_d_ff=128,
        vocab=256,
        segments=((("mla_dense",), 1), (("mla_moe",), 2)),
        num_experts=8,
        top_k=2,
        num_shared_experts=1,
        moe_d_ff=32,
        mtp=True,
        tie_embeddings=False,
        max_decode_len=64,
    )
