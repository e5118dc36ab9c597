"""Carry params between the JAX package's tree and the port's serving LM.

The JAX ``LM.init`` returns a tree of nested dicts whose per-layer leaves
are stacked on a leading layer axis (``seg0/b0/attn/wq/w`` is
``(count, d_model, n_heads * d_head)``); the port trains on the same tree
(``LM.init_params``) and checkpoints it.  :func:`params_from_numpy` takes
such a tree, its leaves numpy arrays (the caller applies ``np.asarray``
to JAX's, so this module never imports jax) or tensors (a tree the port
trained or restored), unstacks the layers in order and returns the
port's :class:`LM` on ``device`` holding those weights, so both packages
compute with the same numbers.  :func:`params_to_numpy` is its inverse.
Every top-level entry the JAX init makes is carried: ``embed`` (one
table, or ``cb{i}`` a codebook), ``seg{i}`` (attention, SwiGLU or GeGLU,
the MoE's ``router``, ``experts/{gate,up,down}`` and ``shared``, the
RG-LRU's ``mix/{w_in,w_gate,w_a,w_x,w_out}/w``, ``mix/conv`` and
``mix/lam``, the mLSTM's ``mix/{up,wq,wk,wv,wi,wf,down}/w`` and
``mix/norm``, the sLSTM's ``mix/{wx,wr,up_gate,up,down}/w`` and
``mix/norm``, and MLA's ``attn/{wq_a,wq_b,wkv_a,wkv_b,wo}/w`` with
``attn/q_norm`` and ``attn/kv_norm``), ``final_norm``, ``lm_head``,
``heads`` (``cb{i}`` a codebook) and ``mtp`` (DeepSeek's MTP head:
``proj``, ``block``, ``norm``; one block, not stacked on a layer axis).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.lm import LM, LMConfig, layer_plan
from repro_torch.utils.device import DeviceLike, resolve_device

#: the top-level entries after the segments, carried as they are (no
#: layer axis)
UNSTACKED = ("final_norm", "lm_head", "heads", "mtp")


def _tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):  # a copy: the serving LM shares nothing
        return x.detach().to(device=device, copy=True)
    x = np.array(x)  # a writable, contiguous copy
    if x.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: reinterpret the bits
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


def _map(tree: Dict[str, Any], fn) -> Dict[str, Any]:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def params_from_numpy(tree: Dict[str, Any], cfg: LMConfig, device: DeviceLike = None) -> LM:
    """The port's LM for ``cfg`` with the weights of the JAX-layout
    ``tree`` (numpy or tensor leaves, copied).  ``device=None`` means the
    card."""
    dev = resolve_device(device)
    model = LM(cfg)
    model._adopt("embed", _map(tree["embed"], lambda x: _tensor(x, dev)))
    for n, (si, i, r, _) in enumerate(layer_plan(cfg)):
        model._adopt(f"blocks.{n}",
                     _map(tree[f"seg{si}"][f"b{i}"], lambda x, r=r: _tensor(x[r], dev)))
    for name in UNSTACKED:
        if name in tree:
            model._adopt(name, _map(tree[name], lambda x: _tensor(x, dev)))
    return model


def params_to_numpy(model: LM) -> Dict[str, Any]:
    """The JAX-layout tree of ``model``'s weights, numpy leaves on the
    host, the layers stacked again per segment.  Weights the serving LM
    holds cast to bfloat16 come back widened to float32 (exactly; numpy
    has no bfloat16 without ``ml_dtypes``), so
    ``params_from_numpy(params_to_numpy(m), m.cfg)`` serves ``m``'s
    numbers."""

    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()

    def plain(module) -> Dict[str, Any]:
        return {k: plain(v) if isinstance(v, torch.nn.Module) else host(v)
                for k, v in module.items()}

    tree: Dict[str, Any] = {"embed": plain(model.embed)}
    for (si, i, _, _), block in zip(layer_plan(model.cfg), model.blocks):
        tree.setdefault(f"seg{si}", {}).setdefault(f"b{i}", []).append(plain(block))
    for seg in (v for k, v in tree.items() if k.startswith("seg")):
        for name, layers in seg.items():
            seg[name] = _stack_layers(layers)
    for name in UNSTACKED:
        if hasattr(model, name):
            tree[name] = plain(getattr(model, name))
    return tree


def _stack_layers(layers):
    """Layer trees (in repetition order) as one tree of stacked leaves."""
    first = layers[0]
    return {k: _stack_layers([l[k] for l in layers]) if isinstance(v, dict)
            else np.stack([l[k] for l in layers]) for k, v in first.items()}
