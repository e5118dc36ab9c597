"""mlp_share (%): the device time of the operations launched inside the
span ``lm.mlp`` (the SwiGLU: gate, up and down GEMMs and SiLU times up)
over the device time of every operation ``perfbench/spans.py`` matched to
its launch."""
from perfbench import spans


def read(window):
    return spans.share(window, "lm.mlp")
