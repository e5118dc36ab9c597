"""Architecture registry: ``--arch <id>`` resolves here.

One module per ported architecture, with the exact published config as
the JAX package's ``repro/configs`` has it: ``CONFIG`` (full size) and
``smoke_config()`` (reduced, same family); ``shapes`` holds the
workload shapes and the batches made for them.  The port serves the
seven architectures whose blocks are attention (four dense, the MoE, the
vision-language and the audio one); the other three are named so that
asking for one says which slice of the port brings it.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.lm import LMConfig

ARCH_IDS: List[str] = [
    "deepseek_v3_671b",
    "qwen2_moe_a2_7b",
    "h2o_danube_3_4b",
    "granite_34b",
    "yi_6b",
    "qwen3_32b",
    "internvl2_2b",
    "xlstm_350m",
    "musicgen_medium",
    "recurrentgemma_9b",
]

#: the architectures this port serves (attention blocks: dense, MoE,
#: patches before the text, parallel codebooks)
PORTED = ("h2o_danube_3_4b", "granite_34b", "yi_6b", "qwen3_32b",
          "qwen2_moe_a2_7b", "internvl2_2b", "musicgen_medium")

#: accepted spellings (CLI uses dashes)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def resolve(arch: str) -> str:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"{arch} needs blocks the port does not have yet (MLA and the MTP "
            f"head, xLSTM, RG-LRU); they come with the slice 'the rest of the "
            f"ML stack', ROADMAP.md §1. Ported: {list(PORTED)}"
        )
    return arch


def get_config(arch: str) -> LMConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.smoke_config()
