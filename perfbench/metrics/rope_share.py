"""rope_share (%): the device time of the operations launched inside the
span ``lm.attention.rope`` (both ``apply_rope`` calls of a layer, in
float32) over the device time of every operation ``perfbench/spans.py``
matched to its launch."""
from perfbench import spans


def read(window):
    return spans.share(window, "lm.attention.rope")
