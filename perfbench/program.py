"""The system under test: the port's ``LM`` (``repro_torch.models.lm``),
built by a model module (``perfbench/models/<model>.py``) from a
configuration file, its weights handed over as the port's state dict
names them.

The port's own registry (``repro_torch.configs``) is held to the file:
a cell whose widths differ from the port's configuration of the same
model is refused (``ConfigMismatch``), so a change to the program cannot
quietly change what a cell measures.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import LM, LMConfig

#: the LMConfig fields that set a cell's work, checked against the port's
#: configuration of the same model
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
          "window", "segments", "tie_embeddings", "num_experts", "n_codebooks", "num_patches")


class ConfigMismatch(ValueError):
    """The port's configuration and the cell's file disagree on a width."""


def check_widths(cfg: LMConfig, port: LMConfig) -> None:
    diffs = [f"{k}: file {getattr(cfg, k)!r}, port {getattr(port, k)!r}"
             for k in WIDTHS if getattr(cfg, k) != getattr(port, k)]
    if diffs:
        raise ConfigMismatch(f"{cfg.name}: the port's configuration differs from the cell's "
                             f"file in " + "; ".join(diffs))


def guarded(cfg: LMConfig, port_arch: str) -> LMConfig:
    """``cfg``, refused where the port's own configuration ``port_arch``
    differs from it in a width."""
    check_widths(cfg, get_config(port_arch))
    return cfg


def load(cfg: LMConfig, state: Dict[str, torch.Tensor]) -> LM:
    """``LM(cfg)`` holding ``state`` (no copy: ``assign=True``, as
    ``ServeEngine`` loads a model); every name, shape and dtype of the
    port's state dict must be filled exactly."""
    model = LM(cfg)
    want = model.state_dict()
    if set(want) != set(state):
        raise KeyError(f"state dict names differ: missing {sorted(set(want) - set(state))[:4]}, "
                       f"extra {sorted(set(state) - set(want))[:4]}")
    for k, t in want.items():
        if t.shape != state[k].shape or t.dtype != state[k].dtype:
            raise ValueError(f"{k}: the port wants {tuple(t.shape)} {t.dtype}, the benchmark "
                             f"made {tuple(state[k].shape)} {state[k].dtype}")
    model.load_state_dict(state, assign=True, strict=True)
    return model
