"""The command's refusals, a CPU rehearsal of a whole run at a tiny size,
and the card test, in every closed_stream cell of BENCHMARK.json."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.conftest import CELLS, ROOT, STREAM_CELLS

REHEARSE = r"""
import json, sys, time
T0 = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness
harness.pin_host_threads()
import torch
from portbench.tests.conftest import tiny
cell = tiny(harness.resolve(harness.load_manifest(), {cell!r}))
result = harness.run_cell(cell, 2**33 + 17, 1.5, False, torch.device("cpu"),
                          T0)
print(json.dumps({{"result": result,
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def python(code_or_args, cwd=ROOT, timeout=240):
    args = (["-c", code_or_args] if isinstance(code_or_args, str)
            else code_or_args)
    env = dict(os.environ, TPU_AUDIO_LOG="warn")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the refusal cannot show")
    proc = python(["portbench/run.py", "--workload", CELLS[0], "--seed",
                   "3", "--seconds", "1", "--trace", "0"])
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "no CUDA card" in proc.stderr


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_cpu_rehearsal_is_correct_and_loads_no_jax(harness, name):
    proc = python(REHEARSE.format(root=str(ROOT), cell=name))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    result = out["result"]
    assert result["correct"] and result["failed"] == 0
    assert list(result)[-1] == "checked"
    cell = harness.resolve(harness.load_manifest(), name)
    assert set(result["metrics"]) == {e["name"] for e in cell.end_to_end}
    assert "tpu_audio_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "tpu_audio"} & set(out["top"])
    assert proc.stderr.strip().splitlines()[-3].startswith("checked err_rms")


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/ has no
    system to measure."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = python(REHEARSE.format(root=str(tmp_path), cell=STREAM_CELLS[0]),
                  cwd=tmp_path)
    assert proc.returncode != 0
    assert "tpu_audio_torch" in proc.stderr
    proc = python(["portbench/run.py", "--workload", CELLS[0], "--seed",
                   "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", STREAM_CELLS)
def test_cell_on_the_card(harness, name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = harness.resolve(harness.load_manifest(), name).chips
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    proc = python(["portbench/run.py", "--workload", name, "--seed", "5",
                   "--seconds", "4", "--trace", "1"], timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["busy_s"] > 0
