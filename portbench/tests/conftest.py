"""Shared pieces of the benchmark's CPU tests: a cell of the manifest cut
to a size the CPU runs in seconds (4 IRs of 0.1 s, 6 voices), with the
configuration's own limits, on the harness's one host thread (a shared
machine's OpenMP pool can stall a 1.5 s window below the blocks the
comparison needs)."""

import copy
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("TPU_AUDIO_LOG", "warn")

from portbench import harness as _harness  # noqa: E402

_harness.pin_host_threads()

CELLS = ("ring_f32.stream_1024v", "ring_bf16.stream_2048v")


def tiny(cell):
    """`cell` at the CPU's size: every key but the sizes as committed."""
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["bank"].update(num_irs=4, ir_seconds=0.1)
    cell.traffic.update(voices=6, check_voices=4, check_blocks=6)
    return cell


@pytest.fixture
def harness():
    from portbench import harness as module

    return module
