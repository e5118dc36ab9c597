"""xlstm-350m [ssm] — arXiv:2405.04517.

24 blocks d_model=1024 4H d_ff=0 (no separate FFN) vocab=50304 —
alternating mLSTM (matrix memory, chunked-parallel) and sLSTM blocks.
Recurrent → runs ``long_500k``.  Parameters stay float32
(``param_dtype``'s default), as the JAX config leaves them.
"""
from repro_torch.models.lm import LMConfig, ModelFamily

CONFIG = LMConfig(
    name="xlstm-350m",
    family=ModelFamily.SSM,
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    segments=((("mlstm", "slstm"), 12),),
    tie_embeddings=True,
    remat="full",
)


def smoke_config() -> LMConfig:
    return LMConfig(
        name="xlstm-smoke",
        family=ModelFamily.SSM,
        n_layers=2,
        d_model=64,
        n_heads=2,
        n_kv_heads=2,
        d_ff=0,
        vocab=256,
        segments=((("mlstm", "slstm"), 1),),
        tie_embeddings=True,
        max_decode_len=64,
    )
