"""The port's benchmark: batch scoring through ``LM.forward`` (``run.py``)."""
