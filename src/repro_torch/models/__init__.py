"""The LM stack of the port: dense attention-only decoders.

``common`` (norms, projections, RoPE, MLPs), ``attention`` (GQA
attention with the flash and decode kernels behind ``use_flash_kernel``),
``lm`` (``LMConfig`` and the ``LM`` module) and ``weights`` (the JAX
package's params carried across).
"""
from repro_torch.models.lm import LM, LMConfig, ModelFamily
from repro_torch.models.weights import params_from_numpy, params_to_numpy

__all__ = ["LM", "LMConfig", "ModelFamily", "params_from_numpy", "params_to_numpy"]
