"""flash_roofline (%): the least time the card could take for the flash
launches in the traced window (each one layer's attention over the batch:
4 * H * D a visible pair at the bf16 peak, or its bytes at HBM's rate,
whichever is longer) over the device time of the kernels named
``flash_*``."""


def read(window):
    flash = [k for k in window.kernels if "flash_" in k.name]
    if not flash:
        return None
    return 100.0 * len(flash) * window.work.flash_launch_bound_s / sum(k.seconds for k in flash)
