"""device_idle (%): the share of the traced window in which no operation
ran on the device (kernels, copies and fills, their intervals merged)."""


def read(window):
    if not window.device_ops:
        return None
    return 100.0 * (1.0 - window.busy_s / window.window_s)
