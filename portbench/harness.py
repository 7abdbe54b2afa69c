"""Runs one cell of BENCHMARK.json once and builds its result line.

A cell is resolved by name: its configuration file (the manifest's
``file``), its traffic file ``traffic/<traffic>.json``, the generator that
the traffic's ``kind`` names (``generators/<kind>.py``) and one reader per
metric (``metrics/<metric>.py``, a ``read(run)`` that returns a number or
None when it finds nothing to read). A metric split by cells, such as
``<base>.host_paced``, reads with ``metrics/<base>.py`` unless it has a
file of its own. A later cell, mix or metric is new files and new
manifest entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_audio")
TOP = 10   # entries of each breakdown list
# One CPU thread for PyTorch's intra-op pool: on the card's shared host
# cores an OpenMP pool's barriers stall the session's per-block copies
# (block gaps at the 99th percentile 11 ms with 8 threads, 7 ms with one)
# and spread the host-paced cell's rate between runs (PERF.md, section 2).
HOST_THREADS = 1


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: Path


def pin_host_threads() -> None:
    """HOST_THREADS for OpenMP, MKL and PyTorch's intra-op pool; call it
    before anything loads torch."""
    os.environ["OMP_NUM_THREADS"] = str(HOST_THREADS)
    os.environ["MKL_NUM_THREADS"] = str(HOST_THREADS)
    import torch

    torch.set_num_threads(HOST_THREADS)


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def resolve(manifest: dict, name: str, root: Path = ROOT,
            bench: Path = BENCH) -> Cell:
    """The cell `name` with its configuration, traffic and the metrics it
    reports: an end-to-end metric without ``workloads`` in every cell; a
    per-layer metric in the cells its ``workloads`` lists, or, without
    the key, in every cell that reports the metric it ``moves``."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(cells))})")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (bench / "traffic" / f"{cell['traffic']}.json").read_text())
    e2e = [m for m in manifest["end_to_end"]
           if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in moved)]
    return Cell(name, cell["chips"], config, traffic, e2e, per_layer, bench)


def load_module(path: Path):
    """A module from its file (metric names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def generator(cell: Cell):
    return load_module(cell.bench / "generators"
                       / f"{cell.traffic['kind']}.py")


def reader_path(bench: Path, name: str) -> Path:
    """metrics/<name>.py, or the reader of the quantity a split name
    divides (the part before its first dot)."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = bench / "metrics" / f"{name.split('.', 1)[0]}.py"
    return path


def read_metrics(cell: Cell, run, entries: list) -> dict:
    """{name: {value, unit}} of every metric whose reader found a value."""
    out = {}
    for entry in entries:
        reader = load_module(reader_path(cell.bench, entry["name"]))
        value = reader.read(run)
        if value is not None and math.isfinite(value):
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({name for name in sys.modules
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str | None:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() or None


def breakdown(profile: dict) -> dict:
    ops = sorted(profile["kernels"].items(), key=lambda kv: -kv[1][0])
    gaps = sorted(profile["gaps"].items(), key=lambda kv: -kv[1][0])
    return {"device_ops": [[name[:160], sec] for name, (sec, _) in ops[:TOP]],
            "idle_gaps": [[f"{name} ({count} gaps)", sec]
                          for name, (sec, count) in gaps[:TOP]]}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_proc: float) -> dict | None:
    """One run of `cell`: its result line as a dict, or None (with the
    reason on standard error) when a forbidden module was loaded."""
    import torch

    gen = generator(cell)
    run = gen.run(cell, seed, seconds, traced, device, t_proc)
    verdict = gen.judge(run, cell)
    metrics = read_metrics(cell, run,
                           cell.per_layer if traced else cell.end_to_end)
    cuda = device.type == "cuda"
    info = {"platform": "gpu" if cuda else device.type,
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": cell.chips,
            "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": verdict["correct"],
              "attempted": verdict["attempted"],
              "failed": verdict["failed"], "metrics": metrics,
              "device": info}
    if traced and run.profile is not None:
        info["busy_s"] = run.profile["busy_s"]
        info["window_s"] = run.profile["window_s"]
        result["breakdown"] = breakdown(run.profile)
    if traced and cuda:
        info["power_limit"] = power_limit()
    result["checked"] = {name: {"value": value if math.isfinite(value)
                                else None, "limit": limit}
                         for name, value, limit in verdict["rows"]}
    leaked = forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded: {', '.join(leaked)}",
              file=sys.stderr)
        return None
    print("set-up seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.setup_parts.items()), file=sys.stderr)
    for name, value, limit in verdict["rows"]:
        print(f"checked {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    return result
