"""Hand-written CUDA kernels for the port's compute hot spots.

Each kernel is a ``<name>/`` subpackage with:

* ``csrc/*.cu`` — the CUDA C++ source for Hopper (``sm_90a``), with a
  plain C entry point; built at first use by :mod:`.build` into
  ``build/kernels/`` and bound with ``ctypes``;
* ``ops.py``    — the public wrapper: checks device, dtype, shape and
  contiguity, allocates outputs and scratch with ``torch.empty``, and
  launches the kernel on the current stream for CUDA tensors.  CPU
  tensors take the plain version.  ``ops.LAUNCHES`` counts the launches;
* ``ref.py``    — the plain PyTorch version with the kernel's semantics,
  which the CPU path and the tests use.

1. ``fused_filter_agg`` — predicate + grouped (sum, count) in one pass
   over the rows, without materializing the filtered intermediate.  It
   replaces ``repro/kernels/fused_filter_agg/kernel.py:
   fused_filter_agg_kernel``.  ``engine/route.py`` decides when a query
   takes it (see its module docstring).
"""
