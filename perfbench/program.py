"""The system under test: the port's ``LM`` (``repro_torch.models.lm``),
built from a configuration file, its weights handed over as the port's
state dict names them.

The port's own registry (``repro_torch.configs``) is held to the file:
a cell whose widths differ from the port's configuration of the same
model is refused (``ConfigMismatch``), so a change to the program cannot
quietly change what a cell measures.  The scalars that move no work
(``rope_theta``, ``rms_norm_eps``) come from the file, as published.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.models.lm import LM, LMConfig, ModelFamily

#: the LMConfig fields that set a cell's work, checked against the port's
#: configuration of the same model
WIDTHS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab",
          "window", "segments", "tie_embeddings", "num_experts", "n_codebooks", "num_patches")


class ConfigMismatch(ValueError):
    """The port's configuration and the cell's file disagree on a width."""


def lm_config(config: dict) -> LMConfig:
    """The LMConfig the cell runs: the file's widths and scalars, bf16
    compute, the hand-written kernels on."""
    if config["torch_dtype"] != "bfloat16":
        raise ValueError(f"{config['name']}: the scoring cells serve bf16, "
                         f"got {config['torch_dtype']}")
    n = config["num_hidden_layers"]
    return LMConfig(
        name=config["name"],
        family=ModelFamily.DENSE,
        n_layers=n,
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        segments=(((config["block"],), n),),
        d_head=config["head_dim"],
        window=config.get("sliding_window"),
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        tie_embeddings=bool(config["tie_word_embeddings"]),
        param_dtype=torch.float32,
        compute_dtype=torch.bfloat16,
        use_flash_kernel=True,
    )


def check_widths(cfg: LMConfig, port: LMConfig) -> None:
    diffs = [f"{k}: file {getattr(cfg, k)!r}, port {getattr(port, k)!r}"
             for k in WIDTHS if getattr(cfg, k) != getattr(port, k)]
    if diffs:
        raise ConfigMismatch(f"{cfg.name}: the port's configuration differs from the cell's "
                             f"file in " + "; ".join(diffs))


def port_config(config: dict) -> LMConfig:
    """The cell's LMConfig, refused where the port's own differs in a width."""
    cfg = lm_config(config)
    check_widths(cfg, get_config(config["port_arch"]))
    return cfg


def state_dict(weights: dict, n_layers: int) -> Dict[str, torch.Tensor]:
    """The benchmark's weights under the names ``LM.state_dict()`` uses."""
    sd = {"embed.table": weights["embed"]}
    for i, w in enumerate(weights["layers"]):
        sd[f"blocks.{i}.norm1.scale"] = w["norm1"]
        for k in ("wq", "wk", "wv", "wo"):
            sd[f"blocks.{i}.attn.{k}.w"] = w[k]
        sd[f"blocks.{i}.norm2.scale"] = w["norm2"]
        for k in ("gate", "up", "down"):
            sd[f"blocks.{i}.mlp.{k}.w"] = w[k]
    sd["final_norm.scale"] = weights["final_norm"]
    sd["lm_head.w"] = weights["head"]
    return sd


def build(cfg: LMConfig, weights: dict) -> LM:
    """``LM(cfg)`` holding ``weights`` (no copy: ``assign=True``, as
    ``ServeEngine`` loads a model); every name, shape and dtype of the
    port's state dict must be filled exactly."""
    model = LM(cfg)
    want = model.state_dict()
    got = state_dict(weights, cfg.n_layers)
    if set(want) != set(got):
        raise KeyError(f"state dict names differ: missing {sorted(set(want) - set(got))[:4]}, "
                       f"extra {sorted(set(got) - set(want))[:4]}")
    for k, t in want.items():
        if t.shape != got[k].shape or t.dtype != got[k].dtype:
            raise ValueError(f"{k}: the port wants {tuple(t.shape)} {t.dtype}, the benchmark "
                             f"made {tuple(got[k].shape)} {got[k].dtype}")
    model.load_state_dict(got, assign=True, strict=True)
    return model

