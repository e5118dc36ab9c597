"""The LM stack of the port: decoders whose blocks are attention.

``common`` (norms, projections, RoPE, MLPs), ``attention`` (GQA
attention with the flash and decode kernels behind ``use_flash_kernel``),
``moe`` (the mixture-of-experts FFN), ``lm`` (``LMConfig`` and the ``LM``
module: dense and MoE blocks, codebooks, a patch prefix) and ``weights``
(the JAX package's params carried across).
"""
from repro_torch.models.lm import LM, LMConfig, ModelFamily
from repro_torch.models.weights import params_from_numpy, params_to_numpy

__all__ = ["LM", "LMConfig", "ModelFamily", "params_from_numpy", "params_to_numpy"]
