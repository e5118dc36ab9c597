"""repro_torch — the lakehouse on PyTorch and CUDA, slice by slice.

A port of the ``repro`` package (JAX on a TPU) to PyTorch on an NVIDIA
Hopper card.  The module tree and names mirror ``repro``'s, so the
counterpart of ``repro/engine/exec.py`` is ``repro_torch/engine/exec.py``.
The package imports ``torch`` and numpy, never ``jax``, and nothing from
``repro``: it keeps its own copy of every module it needs.  The on-disk
lake format and content hashes are the same, so either package reads a
lake the other wrote.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with the default device and no CUDA device they raise instead of falling
back to the CPU.

The public SDK is the JAX package's: one client, three decorators, typed
handles.  Its names resolve lazily (PEP 562), so ``import repro_torch``
stays cheap::

    import repro_torch

    client = repro_torch.Client("/path/to/lake")   # device defaults to cuda
    repro_torch.sql("zone_riders", "SELECT ... GROUP BY ...")

    @repro_torch.expectation()
    def riders_seen(ctx, zone_riders):
        return zone_riders.sum("n") > 0            # a 0-d bool tensor

    with client.branch("feat_1") as branch:        # merge on success
        handle = branch.run("pipeline.py")
        assert handle.state == repro_torch.RunState.SUCCESS

``python -m repro_torch.cli --lake ... {query,run,trace,gc,...}`` is the
same surface on the command line.  Underneath, the engine room stays
importable; the interactive query path::

    from repro_torch.core import Runner
    runner = Runner(catalog, fmt)             # device defaults to cuda
    runner.query("SELECT ... GROUP BY ...")   # dict of numpy arrays

Slice 5 runs pipelines (transform → audit → write over an ephemeral
branch, fused stages, the differential cache) through a serverless
executor whose worker threads run the stages on the card::

    from repro_torch.runtime import ServerlessExecutor
    with ServerlessExecutor() as ex:
        Runner(catalog, fmt, ex).run(pipeline, branch="feat")

Slice 2 serves the dense attention LMs (Yi-6B, H2O-Danube3-4B, Qwen3-32B,
Granite-34B) through the flash and decode attention kernels::

    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    model = LM(get_config("yi-6b")).init(torch.Generator("cuda").manual_seed(0))
    engine = ServeEngine(model, None, ServeConfig(max_batch=4, max_len=4096))
    engine.generate([Request(prompt=tokens, max_new_tokens=16)])
"""
from typing import Any

__version__ = "0.3.0"

#: public name -> (module, attribute) — resolved on first access
_EXPORTS = {
    "Client": ("repro_torch.api", "Client"),
    "BranchHandle": ("repro_torch.api", "BranchHandle"),
    "AsyncRunHandle": ("repro_torch.api", "AsyncRunHandle"),
    "RunHandle": ("repro_torch.api", "RunHandle"),
    "RunState": ("repro_torch.api", "RunState"),
    "RunFailed": ("repro_torch.api", "RunFailed"),
    "Project": ("repro_torch.api", "Project"),
    "project": ("repro_torch.api", "project"),
    "model": ("repro_torch.api", "model"),
    "expectation": ("repro_torch.api", "expectation"),
    "sql": ("repro_torch.api", "sql"),
    "requirements": ("repro_torch.api", "requirements"),
    "discover": ("repro_torch.api", "discover"),
    "Pipeline": ("repro_torch.core", "Pipeline"),
    "Schema": ("repro_torch.table", "Schema"),
    "LintReport": ("repro_torch.analysis", "LintReport"),
    "Finding": ("repro_torch.analysis", "Finding"),
    "Severity": ("repro_torch.analysis", "Severity"),
    "LintFailed": ("repro_torch.analysis", "LintFailed"),
    "lint_pipeline": ("repro_torch.analysis", "lint_pipeline"),
}

__all__ = ["__version__", *sorted(_EXPORTS)]


def __getattr__(name: str) -> Any:
    if name in _EXPORTS:
        import importlib

        module, attr = _EXPORTS[name]
        value = getattr(importlib.import_module(module), attr)
        globals()[name] = value  # cache: resolve once
        return value
    if name == "Runner":
        # thin deprecation shim: the engine stays importable, the facade
        # is the supported construction path
        import warnings

        warnings.warn(
            "repro_torch.Runner is deprecated — construct the platform "
            "through repro_torch.Client (the engine remains at "
            "repro_torch.core.Runner)",
            DeprecationWarning,
            stacklevel=2,
        )
        from repro_torch.core import Runner

        return Runner
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__() -> list:
    return sorted(set(globals()) | set(_EXPORTS) | {"Runner"})
