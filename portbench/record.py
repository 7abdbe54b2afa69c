"""What one run of a cell leaves for its metric readers and its judge."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Run:
    voices: int
    block: int
    sample_rate: int
    t_proc: float                 # process start (host clock)
    t_first_read: float           # the source's first block: the window opens
    build_s: float                # model build, state, warm-up
    read_stamps: np.ndarray       # host clock when the session took block n
    deliver_stamps: np.ndarray    # host clock when the sink received block n
    timed: int                    # blocks [0, timed) count for stamp metrics
    shapes: dict                  # the MAC's F, VI, Pp, KOD and dtype
    memory_peak_bytes: int
    step_host_s: list = field(default_factory=list)
    step_device_ms: list = field(default_factory=list)
    profile: dict | None = None   # trace.Slice.summary()
    setup_parts: dict = field(default_factory=dict)   # seconds by stage
    judge_inputs: dict = field(default_factory=dict)

    def latencies_ms(self) -> np.ndarray:
        """Source hand-over to sink delivery, per timed block."""
        n = min(self.timed, len(self.deliver_stamps))
        return (self.deliver_stamps[:n] - self.read_stamps[:n]) * 1e3

    @property
    def deadline_ms(self) -> float:
        return self.block / self.sample_rate * 1e3
