"""Flash-prefill and flash-decode attention: the Hopper counterparts of
``src/repro/kernels/attention/``.

* ``csrc/flash_prefill.cu``, ``csrc/flash_prefill_bwd.cu``,
  ``csrc/decode_attn.cu`` — the CUDA kernels (``sm_90a``);
* :mod:`.ops` — the wrappers (checks, launch, launch counters) and
  ``FlashPrefill``, the prefill with its backward;
* :mod:`.ref` — the plain PyTorch versions (oracles, CPU path).
"""

from .ops import (FlashPrefill, decode_attention, flash_prefill,
                  flash_prefill_bwd, launch_count, reset_launches)
from .ref import decode_attention_ref, flash_prefill_bwd_ref, flash_prefill_ref

__all__ = ["FlashPrefill", "decode_attention", "decode_attention_ref",
           "flash_prefill", "flash_prefill_bwd", "flash_prefill_bwd_ref",
           "flash_prefill_ref", "launch_count", "reset_launches"]
