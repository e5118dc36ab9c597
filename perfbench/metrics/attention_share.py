"""attention_share (%): the device time of the operations launched inside
the span ``lm.attention`` (``attend_train`` whole: the q, k, v and o
projections, RoPE, the flash wrapper and its kernel) over the device time
of every operation ``perfbench/spans.py`` matched to its launch."""
from perfbench import spans


def read(window):
    return spans.share(window, "lm.attention")
