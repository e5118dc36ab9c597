"""launches_per_batch (launches): the kernels that began in the traced
window over the batches in it: the host's dispatch work a batch."""


def read(window):
    if not window.kernels:
        return None
    return len(window.kernels) / window.batches
