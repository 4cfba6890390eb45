"""The chip table the analytical backend prices against.

One :class:`ChipSpec` holds the four numbers :class:`~.xlatool.XLATool`
and :mod:`.autotune` need: dense peak FLOP/s, device-memory bandwidth,
inter-chip link bandwidth each way, and device memory per chip.  The
default is an NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data
sheet.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["ChipSpec", "H100_SXM"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float     # dense bf16 FLOP/s on the tensor cores
    hbm_bw: float         # device-memory bytes/s
    link_bw: float        # inter-chip bytes/s each way (NVLink)
    hbm_bytes: int        # device memory per chip


# 989 TFLOP/s bf16 dense, 3.35 TB/s, NVLink 900 GB/s all to all (450 GB/s
# each way), 80 GB
H100_SXM = ChipSpec(name="NVIDIA H100 SXM", peak_flops=989e12,
                    hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80 * 10 ** 9)
