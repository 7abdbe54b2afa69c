"""Per-block runtime instrumentation (port of tpu_audio/utils/profiling.py).

Capability equivalent of the reference's cudaEvent block timer (reference
src/conv.cu:299-304,454-462 and src/conv.h:61,80): accumulate per-block
runtimes, discard the first N warmup blocks (the reference initialises
``_nruns = -10`` to skip 10; here the warmup skip also absorbs kernel
builds and cuFFT plan creation), and report the running average. Extended with percentile
latency (p50/p90/p99), deadline-miss counting, and real-time-factor
computation, which the reference lacks but BASELINE.md requires.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field


@dataclass
class BlockTimer:
    """Collects per-block wall-clock durations (seconds)."""

    warmup: int = 10                 # blocks discarded, reference src/conv.h:80
    deadline_s: float | None = None  # e.g. 256/44100; None disables miss counting
    _seen: int = 0
    _samples: list = field(default_factory=list)
    _missed: int = 0
    _t0: float = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        elapsed = time.perf_counter() - self._t0
        self.record(elapsed)
        return elapsed

    def record(self, elapsed_s: float) -> None:
        self._seen += 1
        if self._seen <= self.warmup:
            return
        self._samples.append(elapsed_s)
        if self.deadline_s is not None and elapsed_s > self.deadline_s:
            self._missed += 1

    # -- reporting ---------------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._samples)

    @property
    def missed(self) -> int:
        return self._missed

    def avg_runtime(self) -> float:
        """Mean seconds/block over non-warmup blocks (reference avgRuntime, conv.h:61)."""
        if not self._samples:
            return 0.0
        return sum(self._samples) / len(self._samples)

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        xs = sorted(self._samples)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * len(xs)) - 1))
        return xs[idx]

    def rtf(self, block_period_s: float) -> float:
        """Real-time factor: >1 means faster than real time."""
        avg = self.avg_runtime()
        return block_period_s / avg if avg > 0 else float("inf")

    def summary(self, block_period_s: float | None = None) -> dict:
        out = {
            "blocks": self.count,
            "avg_ms": self.avg_runtime() * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p90_ms": self.percentile(90) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "max_ms": (max(self._samples) * 1e3) if self._samples else 0.0,
            "missed_deadlines": self._missed,
        }
        if block_period_s is not None:
            out["rtf"] = self.rtf(block_period_s)
            out["deadline_ms"] = block_period_s * 1e3
        return out
