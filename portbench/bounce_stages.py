"""Stage timer of ``render_offline`` (runtime/offline.py), wrapped from
outside: a frozen copy of ``chip_smoke.py:BounceStages``.

While the context is open it times the renderer's module functions: the
host input layout (``_block_tensor``), the prime (``_prime_fast``), the
step loop (host wall of the enqueue, CUDA events from its first step to
its last) and the collection (``_collect``: the pinned buffer, the step
loop, the wait and the host copy), summed over every call inside the
context.
"""

from __future__ import annotations

import time

import torch

NAMES = ("_block_tensor", "_prime_fast", "_step_loop", "_collect")


class BounceStages:
    def __init__(self, offline):
        self.offline = offline
        self.wall = dict.fromkeys(NAMES, 0.0)
        self.events = {name: [] for name in NAMES}
        self.steps = 0

    def __enter__(self):
        self.orig = {name: getattr(self.offline, name) for name in NAMES}
        for name in NAMES:
            setattr(self.offline, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.offline, name, fn)

    def _wrap(self, name):
        fn = self.orig[name]

        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                self.wall[name] += time.perf_counter() - t0
                self.events[name].append((start, end))
                if name == "_step_loop":   # (step, state, warmup, seg_len, ..)
                    self.steps += args[2] + args[3]
        return call

    def device_ms(self, name: str) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[name])

    def report(self, wall_s: float, audio_s: float, voices: int) -> dict:
        """The stage split of the bounces timed."""
        loop_ms = self.device_ms("_step_loop")
        out = {"wall_s": wall_s,
               "layout_wall_s": self.wall["_block_tensor"],
               "prime_wall_s": self.wall["_prime_fast"],
               "prime_device_ms": self.device_ms("_prime_fast"),
               "loop_wall_s": self.wall["_step_loop"],
               "loop_device_ms": loop_ms,
               "collect_wall_s": (self.wall["_collect"]
                                  - self.wall["_step_loop"]),
               "steps": self.steps,
               "ms_per_step": loop_ms / max(self.steps, 1),
               "x_real_time": audio_s / wall_s,
               "voice_s_per_s": voices * audio_s / wall_s}
        out["other_wall_s"] = (wall_s - out["prime_wall_s"]
                               - self.wall["_collect"]
                               - out["layout_wall_s"])
        return out
