"""Distribution layer of the port: gradient compression.

The JAX package's mesh axes and sharding rules (``distribution/
sharding.py``) are not ported yet (``ROADMAP.md`` §1, item 4f); the port
trains on one device.
"""
from repro_torch.distribution.compression import (
    CompressionState,
    compress_decompress,
    init_compression,
)

__all__ = ["CompressionState", "init_compression", "compress_decompress"]
