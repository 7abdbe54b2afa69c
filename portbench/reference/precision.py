"""Rounding of float64 values to the formats below float32, for the
controls that the comparison must reject.

Each function rounds to nearest, ties to even, on the significand; the
exponent range of TF32 and bfloat16 is float32's and never binds here.
fp8 e4m3 (NVIDIA's FP8 format: 3 explicit significand bits, normals down
to 2**-6, subnormals in steps of 2**-9, largest 448) is applied with one
scale per tensor that maps its largest magnitude onto 448, as an fp8 path
on the card scales its operands.
"""

from __future__ import annotations

import numpy as np


def round_significand(x: np.ndarray, bits: int) -> np.ndarray:
    """x rounded to `bits` significant bits (the implicit one included)."""
    m, e = np.frexp(np.asarray(x, np.float64))       # |m| in [0.5, 1)
    return np.ldexp(np.round(m * (1 << bits)), e - bits)


def tf32(x: np.ndarray) -> np.ndarray:
    """TF32: 10 explicit significand bits."""
    return round_significand(x, 11)


def bf16(x: np.ndarray) -> np.ndarray:
    """bfloat16: 7 explicit significand bits."""
    return round_significand(x, 8)


def fp8_e4m3(x: np.ndarray) -> np.ndarray:
    """fp8 e4m3 with one per-tensor scale (amax onto 448), scaled back."""
    x = np.asarray(x, np.float64)
    amax = float(np.abs(x).max())
    if amax == 0.0:
        return x.copy()
    scale = 448.0 / amax
    y = x * scale
    normal = np.abs(y) >= 2.0 ** -6
    q = np.where(normal, round_significand(y, 4),
                 np.round(y * 2.0 ** 9) / 2.0 ** 9)
    return np.clip(q, -448.0, 448.0) / scale


FORMATS = {"tf32": tf32, "bf16": bf16, "fp8_e4m3": fp8_e4m3}
