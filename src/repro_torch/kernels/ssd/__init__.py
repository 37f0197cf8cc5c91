"""The Mamba2 SSD intra-chunk step: the Hopper counterpart of
``src/repro/kernels/ssd/``.

* ``csrc/ssd_chunk.cu`` — the CUDA kernel (``sm_90a``);
* :mod:`.ops` — the wrapper (checks, launch, launch counter);
* :mod:`.ref` — the plain PyTorch version (oracle, CPU path).
"""

from .ops import launch_count, reset_launches, ssd_chunk
from .ref import ssd_chunk_ref

__all__ = ["launch_count", "reset_launches", "ssd_chunk", "ssd_chunk_ref"]
