"""The churn_stream cells of BENCHMARK.json on the CPU: a rehearsal of a
whole run, plain and traced, at a tiny size; the churn metrics' readers
on synthetic runs; the control computed in the precision below the
configuration's fails and the port passes; and faults
of the fade path underneath make the run not correct: the fade skipped (a
hard switch), an interrupted fade restarted as if it had converged, every
event a block late, and the events of half the voices dropped. Then the
card test."""

import copy
import json
import time
from dataclasses import replace

import pytest
import torch

from portbench.tests.conftest import ROOT, cells_of_kind
from portbench.tests.test_portbench_metrics import reader, window
from portbench.tests.test_portbench_run import python

CHURN_CELLS = cells_of_kind("churn_stream")
SECONDS = 2.0

REHEARSE = r"""
import json, sys, time
T0 = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness
harness.pin_host_threads()
import torch
from portbench.tests.test_portbench_churn import tiny_churn
cell = tiny_churn(harness.resolve(harness.load_manifest(), {cell!r}))
results = [harness.run_cell(cell, 2**33 + 41, {seconds!r}, traced,
                            torch.device("cpu"), T0)
           for traced in (False, True)]
print(json.dumps({{"results": results,
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def tiny_churn(cell):
    """A churn_stream `cell` at the CPU's size: 16 voices, 4 IRs of 0.1 s,
    two voices re-selected every 8 blocks (one of them inside a live
    fade), 8 judged voices by 6 judged blocks; every other key as
    committed."""
    cell.config = copy.deepcopy(cell.config)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config["bank"].update(num_irs=4, ir_seconds=0.1)
    cell.traffic.update(voices=16, check_voices=8, check_blocks=6)
    cell.traffic["churn"].update(first_block=8, every_blocks=8,
                                 voices_per_event=2, interrupting=1,
                                 live_within_blocks=24,
                                 fresh_after_blocks=40)
    return cell


def cell_and_generator(harness, name):
    cell = tiny_churn(harness.resolve(harness.load_manifest(), name))
    return cell, harness.generator(cell)


@pytest.mark.parametrize("name", CHURN_CELLS)
def test_cpu_rehearsal_is_correct_reports_its_layers_and_loads_no_jax(
        harness, name):
    proc = python(REHEARSE.format(root=str(ROOT), cell=name,
                                  seconds=SECONDS))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced = out["results"]
    cell = harness.resolve(harness.load_manifest(), name)
    for result in (plain, traced):
        assert result["correct"] and result["failed"] == 0, result
        assert list(result)[-1] == "checked"
        assert result["checked"]["interrupted_pairs_short"]["value"] == 0
    assert set(plain["metrics"]) == {e["name"] for e in cell.end_to_end}
    # the CPU has no device trace: the profile's readers find nothing
    layers = {e["name"] for e in cell.per_layer}
    found = set(traced["metrics"])
    assert found == {n for n in layers
                     if not n.startswith(("device_idle_pct",
                                          "ring_mac_roofline"))}
    pct = next(n for n in found if n.startswith("indexed_block_pct"))
    assert 80.0 < traced["metrics"][pct]["value"] < 100.0
    full = next(n for n in found if n.startswith("collapses_full"))
    assert traced["metrics"][full]["value"] == 0.0
    assert "tpu_audio_torch" in out["top"]
    assert not {"jax", "jaxlib", "flax", "tpu_audio"} & set(out["top"])


@pytest.mark.parametrize("name", CHURN_CELLS)
def test_the_control_fails_and_the_port_passes(harness, name):
    cell, gen = cell_and_generator(harness, name)
    run = gen.run(cell, 2**32 + 77, SECONDS, False, torch.device("cpu"),
                  time.perf_counter())
    rng_state = run.judge_inputs["rng"].bit_generator.state
    port = gen.judge(run, cell)
    assert port["correct"], port["rows"]
    assert len(port["voices"]) == cell.traffic["check_voices"]
    assert len(port["blocks"]) == cell.traffic["check_blocks"]
    run.judge_inputs["rng"].bit_generator.state = rng_state
    control = gen.judge(run, cell, control=cell.config["control"])
    assert not control["correct"], control["rows"]
    rows = {name: (value, limit) for name, value, limit in control["rows"]}
    for number in cell.config["limits"]:
        assert rows[number][0] > rows[number][1], rows


def hard_switch(engine, wet):
    """The fade skipped: a re-selected channel plays its new IR at once."""
    real = engine.collapse_pure

    def collapse(state, old, changed, *rest):
        state = real(state, old, changed, *rest)
        return replace(state,
                       coef_a=torch.where(changed, 0.0, state.coef_a),
                       coef_c=torch.where(changed, wet, state.coef_c))
    engine.collapse_pure = collapse


def restarted_from_converged(engine, wet):
    """An interrupted fade re-based as if its voice had converged on the
    IR it leaves: the fade in flight is forgotten."""
    real = engine.collapse_pure

    def collapse(state, old, changed, *rest):
        state = replace(state,
                        coef_a=torch.where(changed, 0.0, state.coef_a),
                        coef_c=torch.where(changed, wet, state.coef_c))
        return real(state, old, changed, *rest)
    engine.collapse_pure = collapse


ENGINE_FAULTS = {"hard_switch": hard_switch,
                 "restarted_from_converged": restarted_from_converged}


def late_by_one(schedule_cls):
    class Late(schedule_cls):
        def pop_due(self, block_index):
            return super().pop_due(block_index - 1)
    return Late


def half_the_voices_dropped(schedule_cls):
    class Dropped(schedule_cls):
        def __init__(self, events=()):
            super().__init__([e for e in events
                              if int(e[1].removeprefix("v")) % 2])
    return Dropped


SCHEDULE_FAULTS = {"late_by_one": late_by_one,
                   "half_the_voices_dropped": half_the_voices_dropped}


@pytest.mark.parametrize("fault", sorted(ENGINE_FAULTS)
                         + sorted(SCHEDULE_FAULTS))
@pytest.mark.parametrize("name", CHURN_CELLS)
def test_a_broken_fade_path_is_not_correct(harness, monkeypatch, name,
                                           fault):
    cell, gen = cell_and_generator(harness, name)
    if fault in ENGINE_FAULTS:
        real = gen.ConvolutionReverb
        wet = cell.config["params"]["wet"]

        class Broken(real):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                ENGINE_FAULTS[fault](self.engine, wet)

        monkeypatch.setattr(gen, "ConvolutionReverb", Broken)
    else:
        monkeypatch.setattr(gen, "MidiSchedule",
                            SCHEDULE_FAULTS[fault](gen.MidiSchedule))
    run = gen.run(cell, 2**31 + 5, SECONDS, False, torch.device("cpu"),
                  time.perf_counter())
    verdict = gen.judge(run, cell)
    assert not verdict["correct"], verdict["rows"]
    rows = {name: (value, limit) for name, value, limit in verdict["rows"]}
    # the sample held the fades: the comparison itself caught the fault
    assert rows["unfaded_pair_share"][0] <= rows["unfaded_pair_share"][1]
    assert rows["interrupted_pairs_short"][0] == 0.0
    assert any(rows[n][0] > rows[n][1] for n in cell.config["limits"]), rows


def test_churn_readers_read_the_programs_spans_and_counters():
    """control_ms, select_ms and indexed_enqueue_ms are the means of the
    spans a churn run carries; indexed_block_pct and collapses_full read
    the session's counters; each reads nothing from a run without them
    (a closed_stream run, or a program without the span or counter)."""
    from portbench.generators.churn_stream import ChurnRun

    plain = window()
    names = ("control_ms", "select_ms", "indexed_enqueue_ms",
             "indexed_block_pct", "collapses_full")
    for name in names:
        assert reader(name).read(plain) is None
    fields = {k: getattr(plain, k) for k in plain.__dataclass_fields__}
    run = ChurnRun(**fields, span_ms={"control": [12.0, 14.0],
                                      "select": [0.5], "step.indexed": [],
                                      "step.steady": [0.2]},
                   counters={"indexed_blocks": 1940, "collapses_full": 0},
                   blocks=2000)
    assert reader("control_ms").read(run) == pytest.approx(13.0)
    assert reader("select_ms").read(run) == pytest.approx(0.5)
    assert reader("indexed_enqueue_ms").read(run) is None
    assert reader("indexed_block_pct").read(run) == pytest.approx(97.0)
    assert reader("collapses_full").read(run) == 0.0
    run.span_ms.pop("control")
    run.counters.pop("collapses_full")
    assert reader("control_ms").read(run) is None
    assert reader("collapses_full").read(run) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", CHURN_CELLS)
def test_churn_cell_on_the_card(harness, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = python(["portbench/run.py", "--workload", name, "--seed", "7",
                   "--seconds", "4", "--trace", "1"], timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["busy_s"] > 0
    pct = next(v for n, v in result["metrics"].items()
               if n.startswith("indexed_block_pct"))
    assert pct["value"] >= 95.0
