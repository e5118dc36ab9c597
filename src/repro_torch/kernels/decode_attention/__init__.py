from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]
