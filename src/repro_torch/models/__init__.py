"""The LM stack of the port: decoders of every block kind of the JAX
package.

``common`` (norms, projections, RoPE, MLPs), ``attention`` (GQA
attention with the flash and decode kernels behind ``use_flash_kernel``),
``mla`` (DeepSeek's multi-head latent attention and its absorbed
decode), ``moe`` (the mixture-of-experts FFN), ``rglru`` (the RG-LRU
recurrent block), ``xlstm`` (the mLSTM and sLSTM blocks), ``lm``
(``LMConfig`` and the ``LM`` module: attention, MLA, MoE, RG-LRU and
xLSTM blocks, codebooks, a patch prefix, the MTP head) and ``weights``
(the JAX package's params carried across).
"""
from repro_torch.models.lm import LM, LMConfig, ModelFamily
from repro_torch.models.weights import params_from_numpy, params_to_numpy

__all__ = ["LM", "LMConfig", "ModelFamily", "params_from_numpy", "params_to_numpy"]
