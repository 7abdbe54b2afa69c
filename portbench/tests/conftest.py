"""Shared pieces of the benchmark's CPU tests: the cells as BENCHMARK.json
lists them, those of one generator kind, and a closed_stream cell cut to a
size the CPU runs in seconds (4 IRs of 0.1 s, 6 voices), with the
configuration's own limits, on the harness's one host thread (a shared
machine's OpenMP pool can stall a 1.5 s window below the blocks the
comparison needs). A test file of another kind brings its own cut."""

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


def cells_of_kind(kind: str, root: Path = ROOT) -> tuple:
    """The cells of `root`'s BENCHMARK.json whose traffic file names the
    generator `kind`, in manifest order."""
    m = _harness.load_manifest(root)
    return tuple(w["name"] for w in m["workloads"]
                 if _harness.resolve(m, w["name"], root, root / "portbench")
                 .traffic["kind"] == kind)


CELLS = tuple(w["name"] for w in _harness.load_manifest()["workloads"])
STREAM_CELLS = cells_of_kind("closed_stream")


def tiny(cell):
    """closed_stream `cell` at the CPU's size: every key but the sizes as
    committed."""
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["bank"].update(num_irs=4, ir_seconds=0.1)
    cell.traffic.update(voices=6, check_voices=4, check_blocks=6)
    return cell


@pytest.fixture
def harness():
    from portbench import harness as module

    return module
