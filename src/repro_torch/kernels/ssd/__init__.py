"""The Mamba2 SSD intra-chunk step: the Hopper counterpart of
``src/repro/kernels/ssd/``.

* ``csrc/ssd_chunk.cu`` — the CUDA kernel (``sm_90a``);
* ``csrc/ssd_chunk_bwd.cu`` — its backward (fp32);
* :mod:`.ops` — the wrappers (checks, launch, launch counters) and
  ``SsdChunk``, the step under autograd;
* :mod:`.ref` — the plain PyTorch versions (oracles, CPU path).
"""

from .ops import (SsdChunk, launch_count, reset_launches, ssd_chunk,
                  ssd_chunk_bwd)
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

__all__ = ["SsdChunk", "launch_count", "reset_launches", "ssd_chunk",
           "ssd_chunk_bwd", "ssd_chunk_bwd_ref", "ssd_chunk_ref"]
