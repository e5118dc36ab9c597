"""Serverless runtime (paper 4.5) — functions, warm starts, elasticity, faults.

The paper's differentiating investment: an orchestration + memory-management
layer where *vertical elasticity* and data locality matter more than
horizontal scale-out.  On one host with a CUDA card:

* container freeze/thaw (their 300 ms trick)  →  warm-start accounting
  keyed by function fingerprint × abstract input shapes (eager PyTorch
  compiles nothing ahead; see ``warm.py``);
* per-function memory sizing                  →  cost-model-driven memory
  tiers;
* function isolation + shared artifacts       →  stateless pure functions
  passing device tensors inside a run (object store only at run
  boundaries);
* reliability (async mode)                    →  retries, heartbeat timeouts,
  straggler speculation, failure injection for tests.
"""
from repro_torch.runtime.function import FunctionSpec
from repro_torch.runtime.warm import WarmFunctionCache, StartupStats
from repro_torch.runtime.resources import ResourceRequest, CostModel, MEMORY_TIERS_GB
from repro_torch.runtime.executor import (
    ServerlessExecutor,
    ExecutorConfig,
    TaskFailure,
    FaultInjector,
)

__all__ = [
    "FunctionSpec",
    "WarmFunctionCache",
    "StartupStats",
    "ResourceRequest",
    "CostModel",
    "MEMORY_TIERS_GB",
    "ServerlessExecutor",
    "ExecutorConfig",
    "TaskFailure",
    "FaultInjector",
]
