"""forward_mfu (%): the model FLOPs of the traced batches over what the
card's bf16 peak gives in the traced window.  A batch's FLOPs are counted
from its shapes (``perfbench/roofline.py``): 2 * N a token over every
matrix, the head's included, and 4 * H * D a visible (query, key) pair."""


def read(window):
    if not window.kernels:
        return None
    flops = window.batches * window.work.batch_flops
    return 100.0 * flops / (window.window_s * window.work.peak_flops)
