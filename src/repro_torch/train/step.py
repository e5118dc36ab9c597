"""The train step: loss → grads → clip → (compress) → optimizer.

Built as a closure over (model, step config), as the JAX package's
``make_train_step`` is.  The params and optimizer state are the JAX
package's trees of plain tensors (float32 masters); a step differentiates
``LM.loss`` with respect to them and updates them in place (the JAX step
donates its buffers to the same end), returning the same trees and the
step's metrics as 0-d tensors.

``compute_cast`` casts every float32 leaf of rank >= 2 at the top of the
step, as the JAX step does.  The rule reads a leaf's rank, and the port
holds the JAX layout, so a block's stacked norm scale (count, d) computes
in that dtype while ``final_norm`` (d,) stays float32.

Microbatching (``accum_steps > 1``; batch leaves shaped (accum, micro,
...)) is a loop that sums the gradients in float32 and divides by
``accum_steps``, as the JAX step's ``lax.scan`` does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distribution.compression import compress_decompress, init_compression
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import OPTIMIZERS, AdamWConfig
from repro_torch.train.schedule import warmup_cosine
from repro_torch.utils.tree import flatten_with_paths, tree_leaves, tree_map, unflatten_like

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0
    #: microbatches per step (1 = no accumulation)
    accum_steps: int = 1
    #: int8 error-feedback gradient compression (data-parallel traffic)
    compress_grads: bool = False
    #: cast float32 master params of rank >= 2 to this dtype at the top of
    #: the step (the cast is linear: gradients flow back to the masters
    #: exactly).  None disables.
    compute_cast: Any = torch.bfloat16
    adam: AdamWConfig = AdamWConfig()


def global_norm(tree: Any) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    return torch.sqrt(sum(leaves))


def clip_by_global_norm(tree: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype), tree), norm


def make_train_state(model: LM, params: Any, cfg: TrainStepConfig) -> Dict[str, Any]:
    init_fn, _ = OPTIMIZERS[cfg.optimizer]
    device = tree_leaves(params)[0].device
    state: Dict[str, Any] = {
        "opt": init_fn(params, cfg.adam),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.compress_grads:
        state["ef"] = init_compression(params)
    return state


def make_train_step(
    model: LM, cfg: TrainStepConfig
) -> Callable[[Any, Dict[str, Any], Batch], Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]]:
    _, update_fn = OPTIMIZERS[cfg.optimizer]

    def cast(p: torch.Tensor) -> torch.Tensor:
        if cfg.compute_cast is not None and p.dtype == torch.float32 and p.ndim >= 2:
            return p.to(cfg.compute_cast)
        return p

    def loss_and_grads(params, batch):
        flat = flatten_with_paths(params)
        with torch.enable_grad():
            masters = {k: p.detach().requires_grad_(True) for k, p in flat.items()}
            used = unflatten_like(params, {k: cast(p) for k, p in masters.items()})
            loss, metrics = model.loss(used, batch)
            grads = torch.autograd.grad(loss, list(masters.values()),
                                        allow_unused=True, materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, unflatten_like(params, dict(zip(masters, grads)))

    def train_step(params, state, batch):
        """batch leaves: (accum, micro_batch, ...) when accum_steps > 1,
        else (batch, ...).  Updates params and state in place."""
        if cfg.accum_steps > 1:
            g_sum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            for a in range(cfg.accum_steps):
                loss, metrics, grads = loss_and_grads(params, {k: v[a] for k, v in batch.items()})
                tree_map(lambda acc, g: acc.add_(g.to(torch.float32)), g_sum, grads)
                loss_sum = loss_sum + loss
                del grads
            grads = tree_map(lambda g: g / cfg.accum_steps, g_sum)
            loss = loss_sum / cfg.accum_steps
        else:
            loss, metrics, grads = loss_and_grads(params, batch)

        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
        if cfg.compress_grads:
            grads, state["ef"] = compress_decompress(grads, state["ef"])
        lr = warmup_cosine(state["step"], peak_lr=cfg.peak_lr,
                           warmup_steps=cfg.warmup_steps, total_steps=cfg.total_steps)
        params, state["opt"] = update_fn(params, grads, state["opt"], cfg.adam, lr)
        state["step"].add_(1)
        out_metrics = {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": lr,
            **{k: v for k, v in metrics.items() if k != "loss"},
        }
        return params, state, out_metrics

    return train_step
