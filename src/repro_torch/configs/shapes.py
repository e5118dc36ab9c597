"""Workload shapes, allocation-free input specs, and smoke-test batches.

The port of the JAX package's ``configs/shapes.py``.  The four assigned
shapes (per arch):

  train_4k      seq=4096    global_batch=256   → a train step
  prefill_32k   seq=32768   global_batch=32    → a prefill
  decode_32k    seq=32768   global_batch=128   → a serve step
                                                  (1 token, 32k KV cache)
  long_500k     seq=524288  global_batch=1     → a serve step, 500k state;
                                                  ONLY sub-quadratic archs

``input_specs`` returns tensors on the ``meta`` device where the JAX
package returns ``ShapeDtypeStruct``s: the same shapes and dtypes, no
memory.  ``make_batch`` materialises small real batches for smoke tests,
drawing from the numpy generator with the same calls in the same order
as the JAX package, so both packages get the same batch from one seed
(its bfloat16 patch embeddings too: both round float32 to nearest-even).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.lm import LMConfig, ModelFamily
from repro_torch.utils.device import DeviceLike, resolve_device

#: archs with sub-quadratic sequence mixing — the only ones that run
#: ``long_500k`` (pure full-attention archs skip it)
SUB_QUADRATIC = {"h2o-danube-3-4b", "xlstm-350m", "recurrentgemma-9b"}


@dataclasses.dataclass(frozen=True)
class WorkloadShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, WorkloadShape] = {
    "train_4k": WorkloadShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": WorkloadShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": WorkloadShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": WorkloadShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: LMConfig, shape: WorkloadShape) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the skip reason."""
    if shape.name == "long_500k" and cfg.name not in SUB_QUADRATIC:
        return (
            "full-attention arch: 500k dense KV decode is the workload this "
            "shape excludes (DESIGN.md §4)"
        )
    return None


def cells(configs: Dict[str, LMConfig]) -> List:
    """All live (arch, shape) cells + skip records."""
    live, skipped = [], []
    for arch, cfg in configs.items():
        for shape in SHAPES.values():
            reason = shape_applicable(cfg, shape)
            if reason is None:
                live.append((arch, shape.name))
            else:
                skipped.append((arch, shape.name, reason))
    return live, skipped


# ------------------------------------------------------------- input specs
def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _token_spec(cfg: LMConfig, batch: int, seq: int) -> torch.Tensor:
    if cfg.n_codebooks > 1:
        return _spec((batch, seq, cfg.n_codebooks), torch.int32)
    return _spec((batch, seq), torch.int32)


def input_specs(cfg: LMConfig, shape: WorkloadShape) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.family == ModelFamily.VLM:
            # text shortened so patches + text == seq budget
            return {
                "tokens": _token_spec(cfg, b, s - cfg.num_patches),
                "patch_embeds": _spec((b, cfg.num_patches, cfg.d_model), torch.bfloat16),
            }
        return {"tokens": _token_spec(cfg, b, s)}
    # decode: one new token against a seq-length cache
    return {
        "tokens": _token_spec(cfg, b, 1),
        "lengths": _spec((b,), torch.int32),
    }


# ------------------------------------------------------- smoke-test batches
def make_batch(
    cfg: LMConfig, *, batch: int, seq: int, rng: np.random.Generator,
    device: DeviceLike = None,
) -> Dict[str, torch.Tensor]:
    """``tokens`` (batch, seq[, K]) int32 and, for a VLM, ``patch_embeds``
    (batch, num_patches, d_model) bfloat16, on ``device`` (None: the
    card)."""
    dev = resolve_device(device)
    if cfg.n_codebooks > 1:
        tokens = rng.integers(0, cfg.vocab, (batch, seq, cfg.n_codebooks))
    else:
        tokens = rng.integers(0, cfg.vocab, (batch, seq))
    out = {"tokens": torch.from_numpy(tokens.astype(np.int32)).to(dev)}
    if cfg.family == ModelFamily.VLM:
        patches = rng.standard_normal((batch, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out["patch_embeds"] = torch.from_numpy(patches).to(dev).to(torch.bfloat16)
    return out
