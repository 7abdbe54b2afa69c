"""Per-block runtime instrumentation (port of tpu_audio/utils/profiling.py).

``BlockTimer``, the capability equivalent of the reference's cudaEvent
block timer (reference src/conv.cu:299-304,454-462 and src/conv.h:61,80):
accumulate per-block runtimes, discard the first N warmup blocks (the
reference initialises ``_nruns = -10`` to skip 10; here the warmup skip
also absorbs kernel builds and cuFFT plan creation), and report the
running average. Extended with percentile latency (p50/p99),
deadline-miss counting, and real-time-factor computation, which the
reference lacks but BASELINE.md requires.

``Spans``, the session's span recorder: named host intervals inside each
block (runtime/stream.py opens them at its layer boundaries), each with
the id of the block it serves and the span that encloses it, kept in a
preallocated store of fixed capacity and read out after the run. While
``torch.profiler`` records, every span also opens a ``record_function``
range named ``tpu_audio.<span>``, which puts it on the profiler's
timeline beside the kernels and copies it enqueued (the range
``torch.profiler.record_function`` opens, a ``user_annotation`` in the
Chrome trace).
"""

from __future__ import annotations

import math
import time
from array import array
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

RANGE_PREFIX = "tpu_audio."


def _nearest_rank(xs_sorted: list, q: float) -> float:
    idx = min(len(xs_sorted) - 1,
              max(0, math.ceil(q / 100.0 * len(xs_sorted)) - 1))
    return xs_sorted[idx]


@dataclass
class BlockTimer:
    """Collects per-block wall-clock durations (seconds)."""

    warmup: int = 10                 # blocks discarded, reference src/conv.h:80
    deadline_s: float | None = None  # e.g. 256/44100; None disables miss counting
    _seen: int = 0
    _samples: list = field(default_factory=list)
    _missed: int = 0

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
        return _nearest_rank(sorted(self._samples), q)

    def rtf(self, block_period_s: float) -> float:
        """Real-time factor: >1 means faster than real time."""
        avg = self.avg_runtime()
        return block_period_s / avg if avg > 0 else float("inf")

    def summary(self, block_period_s: float | None = None) -> dict:
        out = {
            "blocks": self.count,
            "avg_ms": self.avg_runtime() * 1e3,
            "p50_ms": self.percentile(50) * 1e3,
            "p99_ms": self.percentile(99) * 1e3,
            "max_ms": (max(self._samples) * 1e3) if self._samples else 0.0,
            "missed_deadlines": self._missed,
        }
        if block_period_s is not None:
            out["rtf"] = self.rtf(block_period_s)
            out["deadline_ms"] = block_period_s * 1e3
        return out


_profiler_enabled = torch.autograd._profiler_enabled
# the user-scope range that torch.profiler.record_function opens, through
# its direct binding: a quarter of record_function's cost, most of which
# lands outside the range, in the enclosing span's self time on the
# profiler's timeline
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


class Span(NamedTuple):
    """One recorded span. ``parent`` is the index of the enclosing span's
    record (None at the top), ``block`` the id of the block it serves (-1
    for none); the times are ``time.perf_counter_ns()`` stamps, ``end_ns``
    None while the span is open."""

    name: str
    block: int
    parent: int | None
    start_ns: int
    end_ns: int | None


class Spans:
    """Bounded in-memory span recorder for one host thread.

    ``open(name, block)`` and ``close()`` bracket a span, ``call(name, fn,
    *args)`` brackets one call. Spans nest: the innermost open span is the
    parent of the next one, which takes the parent's block id unless it is
    given one. The first ``capacity`` records are kept in preallocated
    arrays; later ones are counted in ``dropped`` and not kept, so a
    session that runs for hours holds a fixed amount of memory."""

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = capacity
        self.dropped = 0
        self._n = 0
        self._code = array("H", bytes(2 * capacity))
        self._block = array("q", bytes(8 * capacity))
        self._parent = array("q", bytes(8 * capacity))
        self._start = array("q", bytes(8 * capacity))
        self._end = array("q", bytes(8 * capacity))
        self._codes: dict[str, int] = {}
        self._names: list[str] = []
        # the open spans, innermost last: (record index or -1 when dropped,
        # block id, the profiler range or None)
        self._stack: list[tuple] = []

    def open(self, name: str, block: int | None = None) -> None:
        stack = self._stack
        if block is None:
            block = stack[-1][1] if stack else -1
        rng = _range_enter(RANGE_PREFIX + name) if _profiler_enabled() \
            else None
        i = self._n
        if i < self.capacity:
            code = self._codes.get(name)
            if code is None:
                code = self._codes[name] = len(self._names)
                self._names.append(name)
            self._code[i] = code
            self._block[i] = block
            self._parent[i] = stack[-1][0] if stack else -1
            self._n = i + 1
            self._start[i] = time.perf_counter_ns()
        else:
            self.dropped += 1
            i = -1
        stack.append((i, block, rng))

    def close(self) -> None:
        """Close the innermost open span."""
        end = time.perf_counter_ns()
        i, _, rng = self._stack.pop()
        if i >= 0:
            self._end[i] = end
        if rng is not None:
            _range_exit(rng)

    def call(self, name: str, fn, *args):
        """fn(*args) inside a span `name`."""
        self.open(name)
        try:
            return fn(*args)
        finally:
            self.close()

    def unwind(self) -> None:
        """Close every open span (a run that ended by an exception)."""
        while self._stack:
            self.close()

    def records(self) -> list[Span]:
        """The kept records, in the order they opened."""
        names = self._names
        return [Span(names[self._code[i]], self._block[i],
                     None if self._parent[i] < 0 else self._parent[i],
                     self._start[i], self._end[i] or None)
                for i in range(self._n)]

    def table(self) -> dict[str, dict]:
        """{name: {count, mean_ms, p99_ms, self_ms}} over the closed
        records, names in the order they first opened: the mean and the
        99th percentile (nearest rank) of the spans' durations, and their
        mean self time, each duration less the part its child spans cover
        (children on one thread do not overlap)."""
        recs = self.records()
        dur = [None if r.end_ns is None else r.end_ns - r.start_ns
               for r in recs]
        own = list(dur)
        for r, d in zip(recs, dur):
            if r.parent is not None and d is not None \
                    and own[r.parent] is not None:
                own[r.parent] -= d
        groups: dict[str, tuple[list, list]] = {}
        for r, d, s in zip(recs, dur, own):
            if d is not None:
                ds, ss = groups.setdefault(r.name, ([], []))
                ds.append(d)
                ss.append(s)
        return {name: {"count": len(ds),
                       "mean_ms": sum(ds) / len(ds) * 1e-6,
                       "p99_ms": _nearest_rank(sorted(ds), 99) * 1e-6,
                       "self_ms": sum(ss) / len(ss) * 1e-6}
                for name, (ds, ss) in groups.items()}
