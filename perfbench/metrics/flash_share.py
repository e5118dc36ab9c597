"""flash_share (%): the device time of the kernels named ``flash_*`` over
the device time of every kernel in the traced window."""


def read(window):
    flash = sum(k.seconds for k in window.kernels if "flash_" in k.name)
    if not flash:
        return None
    return 100.0 * flash / sum(k.seconds for k in window.kernels)
