"""repro_torch — the lakehouse's query path on PyTorch and CUDA.

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
"""

__version__ = "0.3.0"
