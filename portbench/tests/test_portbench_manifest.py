"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by name."""

import json
import re
import shutil

import pytest

from portbench.tests.conftest import CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    assert {w["name"] for w in m["workloads"]} == set(CELLS)
    names = ([c["name"] for c in m["configs"]]
             + [w["name"] for w in m["workloads"]]
             + [e["name"] for e in m["end_to_end"] + m["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for metric in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(metric["unit"]), metric
        assert metric["better"] in ("lower", "higher")
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    for w in m["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_reports_setup_another_end_to_end_and_a_layer(harness):
    m = manifest()
    for name in CELLS:
        cell = harness.resolve(m, name)
        e2e = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for metric in cell.per_layer:
            assert metric["moves"] in e2e, (name, metric["name"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(harness, name):
    cell = harness.resolve(manifest(), name)
    assert cell.traffic["kind"] == "closed_stream"
    assert callable(harness.generator(cell).run)
    for entry in cell.end_to_end + cell.per_layer:
        reader = harness.load_module(harness.reader_path(cell.bench,
                                                         entry["name"]))
        assert callable(reader.read)
    assert set(cell.config["limits"]) == {"err_rms", "err_max"}


def test_config_files_lie_under_paths_and_are_distinct():
    m = manifest()
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    for path in files:
        assert path.startswith("portbench/") and (ROOT / path).exists()


def test_a_config_traffic_and_metric_are_added_as_files(harness, tmp_path):
    """A later cell is new files and new manifest entries only."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    m = manifest()
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

    class FakeRun:
        voices = 64

    assert harness.read_metrics(cell, FakeRun(), cell.per_layer) == {
        "dummy.metric": {"value": 128.0, "unit": "x"}}
