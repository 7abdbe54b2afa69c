"""BENCHMARK.json against the benchmark's contract, every piece of every
cell found by name, and a cell of a new generator kind added as new files.

The contract is a set of functions of (manifest, root), so that the test
of an addition can hold a copy's manifest to it as well. It checks the
manifest against itself and the rules, never against a list of cells."""

import filecmp
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import load_manifest
from portbench.tests.conftest import CELLS, ROOT, STREAM_CELLS, cells_of_kind

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
MAX_CELLS = 24


def one_line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def bench_of(root):
    return root / "portbench"


def check_keys(m, root):
    """The top level, the command and the run's length."""
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    for path in m["paths"]:
        assert PATH.match(path) and ".." not in path.split("/"), path
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert 1 <= len(m["configs"]) <= MAX_CELLS
    assert 1 <= len(m["workloads"]) <= MAX_CELLS
    assert 1 <= len(m["end_to_end"]) <= 16
    assert 1 <= len(m["per_layer"]) <= 128
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024


def check_names(m, root):
    """Every name valid and distinct; each entry's keys, units, sources,
    bounds and lines of text within the rules."""
    names = [e["name"] for group in KEYS for e in m[group]]
    assert len(names) == len(set(names)), names
    for name in names:
        assert NAME.match(name), name
    for group, keys in KEYS.items():
        for entry in m[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (group, entry)
    for c in m["configs"]:
        assert one_line(c["source"]) and one_line(c["why"]), c["name"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key), key
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
        assert metric["source"] in SOURCES, metric
        if "_roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%", metric
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in {e["name"] for e in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert one_line(metric["layer"]), metric["name"]


def check_chips(m, root):
    """1 or 4 chips a cell; at most a quarter of the cells, rounded down,
    ask for 4, and one always may."""
    fours = 0
    for w in m["workloads"]:
        assert w["chips"] in (1, 4), w["name"]
        assert one_line(w["why"]), w["name"]
        fours += w["chips"] == 4
    assert fours <= max(1, len(m["workloads"]) // 4), fours


def check_config_files(m, root):
    """Each configuration's file lies under paths, is no other's and
    exists; each configuration is some cell's, and a pair of configuration
    and traffic appears once."""
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for path in files:
        assert PATH.match(path) and ".." not in path.split("/"), path
        assert any(path.startswith(p + "/") for p in m["paths"]), path
        assert (root / path).is_file(), path
    used = {w["config"] for w in m["workloads"]}
    assert {c["name"] for c in m["configs"]} == used
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs)), pairs


def check_cell(m, root, name, harness):
    """The cell's configuration, traffic file and generator (callable run
    and judge), found by name; its configuration's limits."""
    cell = harness.resolve(m, name, root, bench_of(root))
    kind = cell.traffic["kind"]
    path = bench_of(root) / "generators" / f"{kind}.py"
    assert NAME.match(kind) and path.is_file(), (name, kind)
    gen = harness.generator(cell)
    for part in ("run", "judge"):
        assert callable(getattr(gen, part, None)), (name, kind, part)
    limits = cell.config["limits"]
    assert limits and all(isinstance(v, (int, float)) and math.isfinite(v)
                          and v >= 0 for v in limits.values()), limits
    if kind == "closed_stream":
        # the two numbers reference/judge.py computes
        assert set(limits) == {"err_rms", "err_max"}


def check_cells(m, root):
    from portbench import harness

    for w in m["workloads"]:
        check_cell(m, root, w["name"], harness)


def check_readers(m, root):
    """Every metric's reader resolves through harness.reader_path."""
    from portbench import harness

    for metric in m["end_to_end"] + m["per_layer"]:
        path = harness.reader_path(bench_of(root), metric["name"])
        assert path.is_file(), metric["name"]
        assert callable(harness.load_module(path).read), metric["name"]


def check_workloads_lists(m, root):
    """A metric's workloads name cells that exist, and every metric is
    reported in some cell (check_reports then holds its `moves`)."""
    from portbench import harness

    cells = {w["name"] for w in m["workloads"]}
    for metric in m["end_to_end"] + m["per_layer"]:
        listed = metric.get("workloads", [])
        assert len(listed) == len(set(listed)), metric["name"]
        assert set(listed) <= cells, (metric["name"], set(listed) - cells)
    reported = set()
    for name in cells:
        cell = harness.resolve(m, name, root, bench_of(root))
        reported |= {e["name"] for e in cell.end_to_end + cell.per_layer}
    names = {e["name"] for e in m["end_to_end"] + m["per_layer"]}
    assert names == reported, names - reported


def check_reports(m, root):
    """Every cell reports setup_s, another end-to-end metric and a
    per-layer metric, and each of its per-layer metrics moves one of its
    end-to-end metrics."""
    from portbench import harness

    for w in m["workloads"]:
        cell = harness.resolve(m, w["name"], root, bench_of(root))
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert cell.per_layer, w["name"]
        for metric in cell.per_layer:
            assert metric["moves"] in e2e, (w["name"], metric["name"])


CONTRACT = (check_keys, check_names, check_chips, check_config_files,
            check_cells, check_readers, check_workloads_lists,
            check_reports)


def check_contract(m, root):
    for check in CONTRACT:
        check(m, root)


def check_additions_only(old, new):
    """`new` is `old` with entries added at the ends of its lists and cell
    names appended to metrics' workloads lists; nothing else changed."""
    assert set(new) == set(old)
    for key, value in old.items():
        if not isinstance(value, list) or key not in KEYS:
            assert new[key] == value, key
            continue
        assert len(new[key]) >= len(value), key
        for before, after in zip(value, new[key]):
            if "workloads" in before:
                listed = after["workloads"]
                assert listed[:len(before["workloads"])] == \
                    before["workloads"], before["name"]
                after = {**after, "workloads": before["workloads"]}
            assert after == before, before["name"]


def test_manifest_keys_and_names():
    m = load_manifest()
    check_keys(m, ROOT)
    check_names(m, ROOT)
    check_chips(m, ROOT)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    check_reports(load_manifest(), ROOT)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(harness, name):
    check_cell(load_manifest(), ROOT, name, harness)


def test_config_files_lie_under_paths_and_are_distinct():
    check_config_files(load_manifest(), ROOT)


def test_every_metric_has_a_reader_and_names_cells_that_exist():
    check_readers(load_manifest(), ROOT)
    check_workloads_lists(load_manifest(), ROOT)


def test_a_config_traffic_and_metric_are_added_as_files(harness, tmp_path):
    """A later cell is new files and new manifest entries only."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = load_manifest()
    cfg = json.loads((ROOT / m["configs"][0]["file"]).read_text())
    cfg["model"]["mac_dtype"] = "bf16"
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "stream_1024v.json").read_text())
    traffic["voices"] = 64
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "dummy.metric.py").write_text(
        "def read(run):\n    return run.voices * 2.0\n")
    m["configs"].append({"name": "dummy_config", "source": "https://x.y",
                         "file": "portbench/configs/dummy_config.json",
                         "reduced": [], "why": "a dummy"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy_config",
                           "traffic": "dummy_mix", "chips": 1, "why": "d"})
    m["per_layer"].append({"name": "dummy.metric", "unit": "x",
                           "better": "higher", "source": "host_clock",
                           "layer": "dummy", "moves": "voice_s_per_s",
                           "workloads": ["dummy.cell"]})
    rate = next(e for e in m["end_to_end"] if e["name"] == "voice_s_per_s")
    rate["workloads"].append("dummy.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve(harness.load_manifest(tmp_path), "dummy.cell",
                           root=tmp_path, bench=bench)
    assert cell.config["model"]["mac_dtype"] == "bf16"
    assert cell.traffic["voices"] == 64
    assert [e["name"] for e in cell.per_layer] == ["dummy.metric"]
    assert {e["name"] for e in cell.end_to_end} == {"voice_s_per_s",
                                                    "setup_s"}
    check_contract(harness.load_manifest(tmp_path), tmp_path)
    check_additions_only(load_manifest(), harness.load_manifest(tmp_path))

    class FakeRun:
        voices = 64

    assert harness.read_metrics(cell, FakeRun(), cell.per_layer) == {
        "dummy.metric": {"value": 128.0, "unit": "x"}}


DUMMY_KIND = '''"""dummy_kind: draws `values` numbers from the seed, adds them
up one by one with the host clock's stamps, and compares the sum with an
exactly rounded sum of the same draw."""

import math
import time

import numpy as np

from portbench.record import Run


def run(cell, seed, seconds, traced, device, t_proc):
    t = cell.traffic
    values = np.random.default_rng(seed).standard_normal(t["values"])
    t0 = time.perf_counter()
    stamps = []
    total = 0.0
    for v in values.tolist():
        total += v
        stamps.append(time.perf_counter())
    stamps = np.asarray(stamps)
    return Run(voices=t["voices"], block=cell.config["block"],
               sample_rate=cell.config["sample_rate"], t_proc=t_proc,
               t_first_read=t0, build_s=0.0, read_stamps=stamps,
               deliver_stamps=stamps + 1e-6, timed=len(stamps),
               shapes={}, memory_peak_bytes=0,
               judge_inputs={"seed": seed, "total": float(total)})


def judge(run, cell, control=None):
    n = cell.traffic["values"]
    rng = np.random.default_rng(run.judge_inputs["seed"])
    values = rng.standard_normal(n)
    want = math.fsum(values.tolist())
    gap = abs(run.judge_inputs["total"] - want) / max(abs(want), 1e-300)
    limit = cell.config["limits"]["err_max"]
    ok = gap <= limit
    return {"correct": ok, "attempted": n, "failed": 0 if ok else n,
            "rows": [("err_max", gap, limit)]}
'''

RUN_COPY = r"""
import json, sys, time
T0 = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness
harness.pin_host_threads()
import torch
cell = harness.resolve(harness.load_manifest(), {cell!r})
results = [harness.run_cell(cell, 2**33 + 29, 0.5, traced,
                            torch.device("cpu"), T0)
           for traced in (False, True)]
print(json.dumps({{"bench": str(harness.BENCH), "results": results}}))
"""


def add_dummy_kind(root):
    """A generator of a new kind, a configuration, a traffic file, a cell, a
    per-layer metric and the cell appended to an end-to-end metric's
    workloads: new files and manifest additions only."""
    bench = bench_of(root)
    m = load_manifest(root)
    (bench / "generators" / "dummy_kind.py").write_text(DUMMY_KIND)
    cfg = json.loads((root / m["configs"][0]["file"]).read_text())
    (bench / "configs" / "dummy_config.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"kind": "dummy_kind", "values": 4096, "voices": 8}))
    (bench / "metrics" / "dummy_values.py").write_text(
        "def read(run):\n    return float(len(run.deliver_stamps))\n")
    m["configs"].append({"name": "dummy_config", "source": "https://x.y",
                         "file": "portbench/configs/dummy_config.json",
                         "reduced": [], "why": "a dummy"})
    m["workloads"].append({"name": "dummy.cell", "config": "dummy_config",
                           "traffic": "dummy_mix", "chips": 1,
                           "why": "a generator kind the harness has not seen"})
    m["per_layer"].append({"name": "dummy_values", "unit": "values",
                           "better": "higher", "source": "program_counter",
                           "layer": "dummy: the values handed over",
                           "moves": "voice_s_per_s",
                           "workloads": ["dummy.cell"]})
    rate = next(e for e in m["end_to_end"] if e["name"] == "voice_s_per_s")
    rate["workloads"].append("dummy.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m, indent=1))
    return m


def tree(root):
    return {p.relative_to(root) for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_of_a_new_kind_is_added_as_files(tmp_path):
    """A cell of a generator kind the harness has not seen, with its
    configuration, traffic and a per-layer metric, is new files and
    manifest additions: the copy passes the whole contract and runs. With
    as many four-chip cells as the rules allow it passes; one more fails
    the chips rule and nothing else."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = bench_of(tmp_path)
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    copied = tree(tmp_path)
    m = add_dummy_kind(tmp_path)
    new = {p.relative_to(tmp_path) for p in (
        bench / "generators" / "dummy_kind.py",
        bench / "configs" / "dummy_config.json",
        bench / "traffic" / "dummy_mix.json",
        bench / "metrics" / "dummy_values.py")}
    assert tree(tmp_path) == copied | new
    for rel in copied - {Path("BENCHMARK.json")}:
        assert filecmp.cmp(ROOT / rel, tmp_path / rel, shallow=False), rel
    check_additions_only(load_manifest(), m)
    check_contract(m, tmp_path)
    assert cells_of_kind("closed_stream", tmp_path) == STREAM_CELLS
    assert cells_of_kind("dummy_kind", tmp_path) == ("dummy.cell",)

    proc = subprocess.run(
        [sys.executable, "-c", RUN_COPY.format(root=str(tmp_path),
                                               cell="dummy.cell")],
        cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["bench"] == str(bench)
    plain, traced = out["results"]
    assert plain["correct"] and plain["attempted"] == 4096
    assert set(plain["metrics"]) == {"voice_s_per_s", "setup_s"}
    assert list(plain)[-1] == "checked"
    assert traced["correct"]
    assert traced["metrics"]["dummy_values"]["value"] == 4096.0

    # The chips rule on the copy, whatever cells it holds: turn its one-chip
    # cells, the new one first, to four chips up to a quarter of the cells
    # (one always may): the whole contract holds; one more fails the chips
    # rule and nothing else.
    allowed = max(1, len(m["workloads"]) // 4)
    ones = [w for w in reversed(m["workloads"]) if w["chips"] == 1]
    while sum(w["chips"] == 4 for w in m["workloads"]) < allowed:
        ones.pop(0)["chips"] = 4
    check_contract(m, tmp_path)
    ones.pop(0)["chips"] = 4
    for check in CONTRACT:
        if check is check_chips:
            with pytest.raises(AssertionError):
                check(m, tmp_path)
        else:
            check(m, tmp_path)


@pytest.mark.parametrize("cells", [1, 3, 4, 7, 8, 24])
def test_a_quarter_of_the_cells_may_ask_for_four_chips(cells):
    """check_chips on manifests of `cells` cells: max(1, cells // 4) on
    four chips pass, one more fails, and a chip count of 2 fails."""
    def manifest_with(fours, other=1):
        return {"workloads": [{"name": f"c{i}", "why": "w",
                               "chips": 4 if i < fours else other}
                              for i in range(cells)]}

    allowed = max(1, cells // 4)
    check_chips(manifest_with(allowed), ROOT)
    if allowed < cells:
        with pytest.raises(AssertionError):
            check_chips(manifest_with(allowed + 1), ROOT)
    with pytest.raises(AssertionError):
        check_chips(manifest_with(0, other=2), ROOT)
