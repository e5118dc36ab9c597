"""The restartable training loop — training as a lakehouse pipeline.

Fault-tolerance contract (as the JAX package's ``train/loop.py``):

* state = (params, opt) checkpoints into the catalog (async, atomic);
* data sampling is stateless in (seed, step);
* → killing the process at ANY step and calling ``TrainLoop.run`` again
  resumes from the last committed checkpoint and produces the same
  parameters as an uninterrupted run, bit for bit: batches are
  step-keyed and every operation of the step is deterministic on the CPU
  (on the card, run under ``torch.use_deterministic_algorithms(True)``).

Audit-before-write: the loop trains on a working branch; eval
"expectations" (loss finite, ≤ threshold) gate the merge of the final
checkpoint into the target branch — the paper's transform-audit-write
applied to model artifacts.

The loop runs on ``device`` (None: the card; it raises without one).  A
run with no checkpoint draws its params from
``torch.Generator(device).manual_seed(init_key)``; a resumed run restores
into the shapes of ``LM.init_params(None)`` (meta tensors) and draws
nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.catalog.nessie import Catalog
from repro_torch.data.tokens import TokenDataset
from repro_torch.models.lm import LM
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.step import TrainStepConfig, make_train_state, make_train_step
from repro_torch.utils.device import DeviceLike, resolve_device
from repro_torch.utils.logging import get_logger

log = get_logger("train.loop")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    log_every: int = 10
    async_checkpoint: bool = True
    #: audit gates for the final merge
    max_final_loss: float = float("inf")
    step: TrainStepConfig = dataclasses.field(default_factory=TrainStepConfig)


class TrainLoop:
    def __init__(
        self,
        model: LM,
        dataset: TokenDataset,
        catalog: Catalog,
        *,
        branch: str,
        config: TrainLoopConfig,
        ckpt_prefix: Optional[str] = None,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        self.model = model
        self.dataset = dataset
        self.catalog = catalog
        self.branch = branch
        self.config = config
        self.ckpt = CheckpointManager(
            catalog, prefix=ckpt_prefix or f"models/{model.cfg.name}"
        )
        self._train_step = make_train_step(model, config.step)

    def _start(self, init_key: int):
        """(params, state, first step): the branch's latest checkpoint, or
        a fresh init."""
        step_cfg = self.config.step
        if self.ckpt.latest_step(branch=self.branch) is not None:
            params_like = self.model.init_params(None)
            like = (params_like, make_train_state(self.model, params_like, step_cfg))
            (params, state), start = self.ckpt.restore(like, branch=self.branch,
                                                       device=self.device)
            log.info("resumed from checkpoint at step %d", start)
            return params, state, start
        params = self.model.init_params(torch.Generator(device=self.device).manual_seed(init_key))
        return params, make_train_state(self.model, params, step_cfg), 0

    def run(self, *, init_key: int = 0) -> Dict[str, Any]:
        cfg = self.config
        if not self.catalog.has_branch(self.branch):
            self.catalog.create_branch(self.branch)
        params, state, start_step = self._start(init_key)

        losses: List[float] = []
        pending: List[Any] = []
        t0 = time.perf_counter()
        for step in range(start_step, cfg.total_steps):
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in self.dataset.batch_at(step).items()}
            params, state, metrics = self._train_step(params, state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % cfg.log_every == 0:
                log.info(
                    "step %d loss %.4f lr %.2e gnorm %.2f",
                    step, loss, float(metrics["lr"]), float(metrics["grad_norm"]),
                )
            if (step + 1) % cfg.checkpoint_every == 0:
                if cfg.async_checkpoint:
                    pending.append(
                        self.ckpt.save_async(
                            (params, state), branch=self.branch, step=step + 1
                        )
                    )
                else:
                    self.ckpt.save((params, state), branch=self.branch, step=step + 1)
        for t in pending:
            t.join()

        # ---- audit: final expectations gate the terminal checkpoint
        final_loss = float(np.mean(losses[-5:])) if losses else float("inf")
        audit_ok = bool(np.isfinite(final_loss) and final_loss <= cfg.max_final_loss)
        if losses:  # may be empty when fully resumed at total_steps
            self.ckpt.save(
                (params, state),
                branch=self.branch,
                step=cfg.total_steps,
                extra_meta={"final_loss": final_loss, "audit_ok": audit_ok},
            )
        wall = time.perf_counter() - t0
        return {
            "params": params,
            "state": state,
            "losses": losses,
            "final_loss": final_loss,
            "audit_ok": audit_ok,
            "steps_run": len(losses),
            "wall_s": wall,
        }

    def promote(self, target_branch: str) -> None:
        """Merge the audited checkpoint into the target branch (write)."""
        self.catalog.merge(
            self.branch, target_branch,
            message=f"promote {self.ckpt.prefix}", author="trainer",
        )
