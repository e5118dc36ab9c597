"""norm_share (%): the device time of the operations launched inside the
span ``lm.norm`` (every ``rmsnorm`` of ``LM.forward``: two a block and the
final one, in float32) over the device time of every operation
``perfbench/spans.py`` matched to its launch."""
from perfbench import spans


def read(window):
    return spans.share(window, "lm.norm")
