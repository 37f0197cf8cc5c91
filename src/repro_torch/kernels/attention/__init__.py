"""Flash-prefill and flash-decode attention: the Hopper counterparts of
``src/repro/kernels/attention/``.

* ``csrc/flash_prefill.cu``, ``csrc/decode_attn.cu`` — the CUDA kernels
  (``sm_90a``);
* :mod:`.ops` — the wrappers (checks, launch, launch counters);
* :mod:`.ref` — the plain PyTorch versions (oracles, CPU path).
"""

from .ops import decode_attention, flash_prefill, launch_count, reset_launches
from .ref import decode_attention_ref, flash_prefill_ref

__all__ = ["decode_attention", "decode_attention_ref", "flash_prefill",
           "flash_prefill_ref", "launch_count", "reset_launches"]
