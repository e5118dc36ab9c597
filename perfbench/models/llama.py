"""The dense decoder of the Llama kind (Yi-6B and H2O-Danube3, both
``LlamaForCausalLM``): the port's ``attn`` block, pre-norm attention with
rotary positions and grouped-query heads, then a SwiGLU MLP, in every
layer; a final norm and an untied head.

Its reference is ``perfbench/reference/lm.py`` and its work is counted by
``perfbench/roofline.py``.  The weights are laid out as that reference
reads them: ``embed`` (V, d), ``layers`` (a dict a layer: ``norm1``,
``wq``, ``wk``, ``wv``, ``wo``, ``norm2``, ``gate``, ``up``, ``down``;
matrices stored (d_in, d_out)), ``final_norm`` and ``head`` (d, V).  The
scalars that move no work (``rope_theta``, ``rms_norm_eps``) come from the
file, as published.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from perfbench import program, roofline
from perfbench.reference import lm as reference
from perfbench.weights import generator, matrices, norm_scales
from repro_torch.models.lm import LM, LMConfig, ModelFamily

def ref_shape(config: dict) -> reference.RefShape:
    """The reference's view of a configuration."""
    return reference.RefShape(
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_head=config["head_dim"],
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        rope_theta=float(config["rope_theta"]),
        norm_eps=float(config["rms_norm_eps"]),
        window=config.get("sliding_window"),
    )


def work_shape(config: dict) -> roofline.Shape:
    """The roofline's view of a configuration."""
    return roofline.Shape(
        n_layers=config["num_hidden_layers"],
        d_model=config["hidden_size"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_head=config["head_dim"],
        d_ff=config["intermediate_size"],
        vocab=config["vocab_size"],
        window=config.get("sliding_window"),
    )


def matrix_plan(shape: reference.RefShape, n_layers: int) -> List[tuple]:
    """(key, layer or None, (d_in, d_out), scale) of every matrix, in the
    order the buffer holds them."""
    d, hd = shape.d_model, shape.d_head
    plan = [("embed", None, (shape.vocab, d), d ** -0.5)]
    for i in range(n_layers):
        plan += [
            ("wq", i, (d, shape.n_heads * hd), d ** -0.5),
            ("wk", i, (d, shape.n_kv_heads * hd), d ** -0.5),
            ("wv", i, (d, shape.n_kv_heads * hd), d ** -0.5),
            ("wo", i, (shape.n_heads * hd, d), (shape.n_heads * hd) ** -0.5),
            ("gate", i, (d, shape.d_ff), d ** -0.5),
            ("up", i, (d, shape.d_ff), d ** -0.5),
            ("down", i, (shape.d_ff, d), shape.d_ff ** -0.5),
        ]
    plan.append(("head", None, (d, shape.vocab), d ** -0.5))
    return plan


def make_weights(config: dict, seed: int, device) -> Dict[str, object]:
    """The model's weights from ``seed``: matrices in bf16, norm scales in
    float32, all on ``device``."""
    shape, n = ref_shape(config), config["num_hidden_layers"]
    gen = generator(seed, device)
    plan = matrix_plan(shape, n)
    views = matrices(gen, [(dims, scale) for _, _, dims, scale in plan], device)
    norms = norm_scales(gen, (2 * n + 1, shape.d_model), device)
    weights: Dict[str, object] = {
        "layers": [{"norm1": norms[2 * i], "norm2": norms[2 * i + 1]} for i in range(n)],
        "final_norm": norms[-1],
    }
    for (key, i, _, _), view in zip(plan, views):
        if i is None:
            weights[key] = view
        else:
            weights["layers"][i][key] = view
    return weights


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


def port_config(config: dict) -> LMConfig:
    """The cell's LMConfig, refused where the port's own differs in a width."""
    return program.guarded(lm_config(config), config["port_arch"])


def state_dict(weights: dict) -> Dict[str, torch.Tensor]:
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
    """The port's ``LM`` holding ``weights``, without a copy."""
    return program.load(cfg, state_dict(weights))


#: the reference's log-probabilities (R, S - 1) of ``rows`` (R, S)
score_rows = reference.score_rows
#: the control: every product's operands in float8 e4m3, below the bf16 served
control = reference.Float8


def batch_flops(config: dict, rows: int, seq_len: int) -> int:
    return roofline.batch_flops(work_shape(config), rows, seq_len)


def flash_launch_bound_s(config: dict, rows: int, seq_len: int) -> float:
    return roofline.flash_launch_bound_s(work_shape(config), rows, seq_len)
