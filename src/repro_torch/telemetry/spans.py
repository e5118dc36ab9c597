"""Spans of the model path, on the profiler's clock.

``span(name)`` marks a piece of the model's work for a running
``torch.profiler``: while one records it is
``torch.profiler.record_function(name)``, whose range lies on the clock
that the device's events share, so a trace can put each kernel down to the
span that launched it.  Otherwise it is one shared null context, and costs
a read of the profiler's own flag.  A span launches no kernel, synchronises
nothing and allocates nothing on the device.

The names, from ``LM.forward`` down (``models/lm.py``,
``models/attention.py``): ``lm.embed``, ``lm.norm``, ``lm.attention`` with
``lm.attention.qkv``, ``lm.attention.rope``, ``lm.attention.kernel`` and
``lm.attention.out`` inside it, ``lm.mlp`` and ``lm.head``.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as autograd_profiler
from torch.profiler import record_function

#: what ``span`` returns while no profiler records
OFF = contextlib.nullcontext()


def span(name: str):
    """A context that marks ``name`` for a running profiler, else ``OFF``."""
    if autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return OFF
