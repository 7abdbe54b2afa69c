"""The benchmark's own CPU tests (portbench/tests) inside this suite: one
case per test file, each run by pytest in a fresh process from the repo
root. A fresh process, because this suite's conftest loads JAX, and the
benchmark's harness refuses to report a run from a process that has it
loaded (portbench/harness.py: FORBIDDEN). The tests marked ``cuda`` need
the card and are left out, as everywhere in this suite on the CPU."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p.name for p in (ROOT / "portbench" / "tests").glob(
    "test_*.py"))
TIMEOUT_S = 600


@pytest.mark.parametrize("name", FILES)
def test_portbench_file(name):
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", f"portbench/tests/{name}", "-q",
         "-m", "not cuda", "-p", "no:cacheprovider"],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout[-4000:], proc.stderr[-2000:])
