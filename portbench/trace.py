"""Spans and probes installed from outside the port, and the reading of
``torch.profiler`` over a slice of the window.

The port has no spans of its own yet, so a traced run wraps the calls into
its layers from here: the engine's step functions (host wall and CUDA
events around each call), the session's upload, step choice, fetch and
delivery, the control plane's parameter snapshot and block end, and the
benchmark's own source and sink.
While the profiler records, every wrapper opens a ``record_function``
range named ``portbench.<span>``, so that each idle gap of the device can
be named by the host span open at its middle. The profile is read in
memory; no trace file is written.
"""

from __future__ import annotations

import bisect
import time
from contextlib import nullcontext

import torch

PREFIX = "portbench."
STEP_METHODS = ("step_coef_steady", "step_coef_indexed", "step_coef")
SESSION_SPANS = {"_upload": "upload", "_start_fetch": "fetch",
                 "_deliver": "deliver", "_pick_coef_step": "step_choice"}
CONTROL_SPANS = {"snapshot_device": "params", "end_block": "end_block"}


class Probe:
    """Times the engine's steps outside the profiled slice, and names the
    host's spans inside it."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.profiling = False
        self.step_host_s: list[float] = []
        self.step_events: list = []

    def span(self, name: str):
        """A ``record_function`` range while the profiler records."""
        if self.profiling:
            return torch.profiler.record_function(PREFIX + name)
        return nullcontext()

    def install_steps(self, engine) -> None:
        """Shadow the engine's step methods on the instance (a session
        built afterwards takes the wrappers)."""
        for name in STEP_METHODS:
            fn = getattr(engine, name, None)
            if fn is not None:
                setattr(engine, name, self._step(fn))

    def install_session(self, session) -> None:
        """Spans around the session's upload, fetch, delivery and step
        choice, and its control plane's parameter snapshot and block
        end."""
        for owner, spans in ((session, SESSION_SPANS),
                             (session.control, CONTROL_SPANS)):
            for name, span in spans.items():
                setattr(owner, name, self._spanned(getattr(owner, name),
                                                   span))

    def _spanned(self, fn, span: str):
        def call(*args, **kwargs):
            with self.span(span):
                return fn(*args, **kwargs)
        return call

    def _step(self, fn):
        def call(*args, **kwargs):
            if self.profiling:
                with torch.profiler.record_function(PREFIX + "step"):
                    return fn(*args, **kwargs)
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.step_host_s.append(time.perf_counter() - t0)
            if self.cuda:
                end.record()
                self.step_events.append((start, end))
            return out
        return call

    def step_device_ms(self) -> list[float]:
        """CUDA-event milliseconds of every timed step call."""
        if self.step_events:
            torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.step_events]


class Slice:
    """``torch.profiler`` over a slice of the window."""

    def __init__(self, probe: Probe):
        self.probe = probe
        self.prof = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        self.probe.profiling = True

    def stop(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.probe.profiling = False

    def summary(self) -> dict | None:
        """busy_s (the union of device activity), window_s (host clock from
        start to the final synchronise), kernels {name: [seconds, count]}
        and gaps {host span: [idle seconds, gaps]}; None when nothing was
        profiled or the profiler saw no device activity."""
        if self.prof is None:
            return None
        device, spans = [], []
        for e in self.prof.events():
            if e.name.startswith(PREFIX):
                if e.device_type == torch.autograd.DeviceType.CPU:
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name[len(PREFIX):]))
                continue
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("ProfilerStep")):
                device.append((e.time_range.start, e.time_range.end, e.name))
        if not device:
            return None
        kernels: dict[str, list] = {}
        for s, t, name in device:
            entry = kernels.setdefault(name, [0.0, 0])
            entry[0] += (t - s) * 1e-6
            entry[1] += 1
        union = _union([(s, t) for s, t, _ in device])
        busy_us = sum(t - s for s, t in union)
        spans.sort()
        starts = [s for s, _, _ in spans]
        gaps: dict[str, list] = {}
        for (_, end), (nxt, _) in zip(union, union[1:]):
            name = _span_at(spans, starts, 0.5 * (end + nxt))
            entry = gaps.setdefault(name, [0.0, 0])
            entry[0] += (nxt - end) * 1e-6
            entry[1] += 1
        return {"busy_s": busy_us * 1e-6, "window_s": self.t1 - self.t0,
                "kernels": kernels, "gaps": gaps}


def _union(intervals: list[tuple[float, float]]) -> list[list[float]]:
    """Merged, sorted intervals."""
    out: list[list[float]] = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def _span_at(spans, starts, t: float, depth: int = 8) -> str:
    """The innermost span open at time t: spans come from one host thread,
    so they nest, and the latest-opened one still open is the innermost.
    'session' where none of the `depth` spans opened last before t is
    open (the session's own host code between the harness's spans)."""
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(spans[max(0, i - depth): i]):
        if e >= t:
            return name
    return "session"
