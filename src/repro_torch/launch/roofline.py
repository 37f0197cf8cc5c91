"""Roofline terms of a census at the H100's peaks: the counterpart of the
JAX package's ``launch/roofline.py``.

Three terms per (arch x shape x mesh), in seconds, per device:

    compute    = FLOPs / peak FLOP/s of the step's dtype
    memory     = bytes moved / HBM bandwidth
    collective = collective bytes / link bandwidth

The peaks are the H100 SXM's published ones (NVIDIA's data sheet, dense,
at 700 W): 989e12 FLOP/s in bf16 on the tensor cores, 67e12 in fp32
outside them (TF32 is off in the port, so fp32 products run there), and
3.35e12 B/s of HBM3.  ``chip_smoke.py`` bounds each kernel by the same
constants.  The census (``launch/hlo_analysis.py``) gives the FLOPs,
bytes and collective bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FLOPS = {"float32": 67e12,        # fp32 FMA, outside the tensor cores
              "bfloat16": 989e12}      # bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
#: one link rate for every collective: NVLink 4, 450 GB/s per direction
#: (NVIDIA's H100 SXM data sheet, 900 GB/s both ways).  A 16 x 16 mesh
#: spans 32 nodes of eight cards, so most of its hops cross the network
#: between nodes, which is slower; the term is a lower bound there.
LINK_BYTES_PER_S = 450e9


@dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict = field(default_factory=dict)
    dtype: str = "bfloat16"

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS[self.dtype]

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / HBM_BYTES_PER_S

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / LINK_BYTES_PER_S

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """The least time of the step on one device: the largest term."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "dtype": self.dtype,
        }


def of_census(census, dtype: str = "bfloat16") -> Roofline:
    """The :class:`Roofline` of an ``HloCensus`` for a step in ``dtype``."""
    return Roofline(census.flops, census.hbm_bytes, census.total_coll_bytes,
                    {"bytes": dict(census.coll_bytes),
                     "counts": dict(census.coll_counts)}, dtype)
