"""Carry the JAX package's LM params into the port.

The JAX ``LM.init`` returns a tree of nested dicts whose per-layer leaves
are stacked on a leading layer axis (``seg0/b0/attn/wq/w`` is
``(count, d_model, n_heads * d_head)``).  :func:`params_from_numpy` takes
that tree with every leaf already a numpy array (the caller applies
``np.asarray`` to each leaf, so this module never imports jax), unstacks
the layers in order and returns the port's :class:`LM` on ``device``
holding those weights, so both packages compute with the same numbers.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.lm import LM, LMConfig, layer_plan
from repro_torch.utils.device import DeviceLike, resolve_device


def _tensor(x: np.ndarray, device: torch.device) -> torch.Tensor:
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig, device: DeviceLike = None) -> LM:
    """The port's LM for ``cfg`` with the weights of the JAX ``tree``
    (numpy leaves).  ``device=None`` means the card."""
    dev = resolve_device(device)
    model = LM(cfg)
    model._adopt("embed", _map(tree["embed"], lambda x: _tensor(x, dev)))
    for n, (si, i, r, _) in enumerate(layer_plan(cfg)):
        model._adopt(f"blocks.{n}",
                     _map(tree[f"seg{si}"][f"b{i}"], lambda x, r=r: _tensor(x[r], dev)))
    model._adopt("final_norm", _map(tree["final_norm"], lambda x: _tensor(x, dev)))
    if "lm_head" in tree:
        model._adopt("lm_head", _map(tree["lm_head"], lambda x: _tensor(x, dev)))
    return model
