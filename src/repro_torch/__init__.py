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
back to the CPU.  Slice 1 covers the interactive query path::

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

__version__ = "0.3.0"
