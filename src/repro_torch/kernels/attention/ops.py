"""Public wrappers of the Hopper attention kernels (``csrc/*.cu``).

Counterpart of ``src/repro/kernels/attention/``.  For tensors on the
GPU a wrapper launches its kernel or raises; for tensors on the CPU it
runs the plain version (:mod:`.ref`).  There is no fallback: a dtype,
layout or head dim the kernel does not take is an error.

:func:`launch_count` counts each kernel's launches since the last
:func:`reset_launches`, so a run can show that it went through them.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from .._build import DTYPE_CODES, Launchers
from .ref import decode_attention_ref, flash_prefill_ref

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"flash_prefill": CSRC / "flash_prefill.cu",
           "decode_attention": CSRC / "decode_attn.cu"}
#: largest query-group size G (query heads per kv head) a block holds
MAX_GROUP = 64
#: ctypes signatures of the ``extern "C"`` launchers, one for one
ARGTYPES = {
    # dtype; q, k, v, o; b, s, kh, g, d, window; stream
    "flash_prefill": ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
    # dtype; q, k, v, valid_len, o; b, w, kh, g, d, splits; stream
    "decode_attention": ([ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p]),
}
#: decode: the blocks a launch may reach (one on each of an H100's 132
#: SMs: the S blocks of a cluster must find room in one GPC together, and
#: grids past one a SM waited for it), the most splits of a (batch, kv
#: head) (the blocks of one cluster, the portable limit), and the cache
#: entries a split keeps at least
DECODE_BLOCKS = 132
MAX_SPLITS = 8
MIN_SPLIT_ENTRIES = 32

_KERNELS = Launchers(SOURCES, ARGTYPES)
#: launches of kernel ``name`` (a key of :data:`SOURCES`) since process
#: start or :func:`reset_launches`
launch_count = _KERNELS.launch_count
reset_launches = _KERNELS.reset


@functools.lru_cache(maxsize=1024)
def decode_splits(b: int, k: int, w: int) -> int:
    """Splits S of the cache per (batch, kv head) for B = ``b``, K = ``k``
    and a cache of ``w`` entries: doubled from 1 while the B K 2S blocks
    stay within :data:`DECODE_BLOCKS` and every split keeps at least
    :data:`MIN_SPLIT_ENTRIES` entries, up to :data:`MAX_SPLITS`.
    From shapes only: ``valid_len`` stays on the device.  Split r walks
    the entries below ``valid_len`` of ``_build.split_ranges(w, S)[r]``.
    """
    s = 1
    while s < MAX_SPLITS and 2 * b * k * s <= DECODE_BLOCKS \
            and w // (2 * s) >= MIN_SPLIT_ENTRIES:
        s *= 2
    return s


def _check_cuda(name: str, q: torch.Tensor, *others: torch.Tensor) -> None:
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported (kernel "
                         f"takes {sorted(map(str, DTYPE_CODES))})")
    for t in (q, *others):
        if t.device != q.device:
            raise ValueError(f"{name}: tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    d, g = q.shape[-1], q.shape[-2]
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{name}: head dim {d} not supported (a multiple "
                         f"of 8 up to 128)")
    if g > MAX_GROUP:
        raise ValueError(f"{name}: {g} query heads per kv head, kernel "
                         f"takes at most {MAX_GROUP}")


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sliding_window: int = 0) -> torch.Tensor:
    """Causal GQA attention.  q: (B, S, K, G, D); k/v: (B, S, K, D).

    Returns (B, S, K, G, D) in q's dtype (fp32 or bf16 on the GPU; fp32
    scores, softmax and accumulation either way).
    """
    if q.dim() != 5 or k.dim() != 4 or k.shape != v.shape \
            or tuple(k.shape) != (*q.shape[:3], q.shape[4]):
        raise ValueError(f"flash_prefill: want q (B,S,K,G,D), k/v "
                         f"(B,S,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    sliding_window = int(sliding_window)
    if sliding_window < 0:
        raise ValueError(f"flash_prefill: sliding_window {sliding_window}")
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    _check_cuda("flash_prefill", q, k, v)
    B, S, K, G, D = q.shape
    if B * K > 65535:
        raise ValueError(f"flash_prefill: B * K = {B * K} > 65535")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_prefill: bf16 q, k and v must be 16-byte "
                         "aligned (the kernel loads them by TMA and in "
                         "16-byte vectors)")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    _KERNELS.launch("flash_prefill", q, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), B, S, K, G, D,
                    sliding_window)
    return o


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """One query token per (batch, kv head) against a cache.

    q: (B, K, G, D); k/v: (B, W, K, D); ``valid_len``: a one-element
    int32 tensor on q's device (on the GPU the kernel reads it there:
    the host never waits for it).  Entries at or past ``valid_len`` are
    masked.  Returns (B, K, G, D) in q's dtype.
    """
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or (k.shape[0], k.shape[2], k.shape[3]) != \
            (q.shape[0], q.shape[1], q.shape[3]):
        raise ValueError(f"decode_attention: want q (B,K,G,D), k/v "
                         f"(B,W,K,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not isinstance(valid_len, torch.Tensor) or valid_len.numel() != 1 \
            or valid_len.dtype != torch.int32:
        raise ValueError("decode_attention: valid_len must be a "
                         "one-element int32 tensor")
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, valid_len.reshape(()))
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    _check_cuda("decode_attention", q, k, v)
    if valid_len.device != q.device:
        raise ValueError(f"decode_attention: valid_len on "
                         f"{valid_len.device}, q on {q.device}")
    if k.shape[1] == 0:
        raise ValueError("decode_attention: empty cache")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k and v must be 16-byte "
                         "aligned (the kernel loads them in 16-byte "
                         "vectors)")
    B, K, G, D = q.shape
    W = k.shape[1]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    _KERNELS.launch("decode_attention", q, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), valid_len.data_ptr(), o.data_ptr(), B, W,
                    K, G, D, decode_splits(B, K, W))
    return o
