"""The comparison that decides ``correct``.

Output blocks of the port are held against the reference's, over a sample
of voices and blocks drawn from the seed. Two numbers, each with its limit
from the configuration's ``limits``:

- ``err_rms``: the root of the summed squared gaps over the root of the
  summed squared reference samples, over every sample compared;
- ``err_max``: the widest gap over the widest reference sample.

A run is correct when every block handed to the session came back and
both numbers lie at or below their limits.
"""

from __future__ import annotations

import numpy as np


def gap_numbers(got: np.ndarray, want: np.ndarray) -> dict[str, float]:
    """err_rms and err_max of `got` against `want` (same shapes)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = got - want
    return {
        "err_rms": float(np.sqrt(np.sum(diff * diff)
                                 / max(np.sum(want * want), 1e-300))),
        "err_max": float(np.abs(diff).max()
                         / max(float(np.abs(want).max()), 1e-300)),
    }


def verdict(numbers: dict[str, float], limits: dict[str, float]
            ) -> tuple[bool, list[tuple[str, float, float]]]:
    """(every number within its limit, [(name, value, limit)]). A number
    that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        rows.append((name, value, limit))
        ok = ok and bool(np.isfinite(value)) and value <= limit
    return ok, rows
