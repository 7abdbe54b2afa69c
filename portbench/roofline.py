"""Published peaks of one NVIDIA H100 SXM and the work of the port's
kernels, counted from their shapes.

Frozen copies of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``PEAK_FLOPS``,
``roofline_ms`` and the count in ``time_ring_mac``. The peaks are NVIDIA's
data sheet figures (dense, at the full 700 W power limit): HBM3 at 3.35
TB/s, 67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in
bfloat16 on them (bf16 products, f32 sums). A card set below 700 W runs
slower; a roofline share is stated against these peaks with the card's
power limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def roofline_s(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take: the larger of `nbytes` over the
    HBM rate and `flops` over the peak of operands of `dtype`. Returns
    (seconds, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


def ring_mac_work(f: int, vi: int, pp: int, kod: int, dtype: str
                  ) -> tuple[int, int]:
    """(bytes, FLOPs) of one ring_mac call, m[f, vi, kod] = sum over the
    two planes and Pp slots of fdl[f, vi, c, s] * window[f, c, s, kod]:
    the line [F, VI, 2, Pp] and the bank's window [F, 2, Pp, KOD] (the
    Pp rows of the doubled bank that the call reads) read once in
    `dtype`, m written once in float32; one multiply and one add per
    term."""
    elem = ELEMENT_BYTES[dtype]
    nbytes = (f * vi * 2 * pp + f * 2 * pp * kod) * elem + f * vi * kod * 4
    flops = 2 * f * vi * 2 * pp * kod
    return nbytes, flops
