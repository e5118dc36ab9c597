"""Architecture registry: ``--arch <id>`` resolves here.

One module per ported architecture, with the exact published config as
the JAX package's ``repro/configs`` has it: ``CONFIG`` (full size) and
``smoke_config()`` (reduced, same family); ``shapes`` holds the
workload shapes and the batches made for them.  The port serves all
ten: four dense attention LMs, the MoE, the vision-language and the
audio one, the hybrid recurrentgemma-9b (RG-LRU and local attention),
xlstm-350m (mLSTM and sLSTM blocks) and deepseek-v3-671b (MLA, dense and
MoE FFNs, the MTP head).  Only an unknown name is refused.
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
#: patches before the text, parallel codebooks; RG-LRU blocks; xLSTM
#: blocks; MLA blocks with the MTP head)
PORTED = ("h2o_danube_3_4b", "granite_34b", "yi_6b", "qwen3_32b",
          "qwen2_moe_a2_7b", "internvl2_2b", "musicgen_medium", "recurrentgemma_9b",
          "xlstm_350m", "deepseek_v3_671b")

#: accepted spellings (CLI uses dashes)
ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}


def resolve(arch: str) -> str:
    arch = arch.replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    return arch


def get_config(arch: str) -> LMConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.CONFIG


def get_smoke_config(arch: str) -> LMConfig:
    mod = importlib.import_module(f"repro_torch.configs.{resolve(arch)}")
    return mod.smoke_config()
