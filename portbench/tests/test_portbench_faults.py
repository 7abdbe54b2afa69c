"""The comparison that decides ``correct`` against what it must reject.

The control: the reference computed with the MAC's operands in the
precision below the configuration's (TF32 for the f32 path, fp8 e4m3 for
the bf16 path) must fail, the port must pass. The faults: a run with the
timed path broken underneath (the step returns its state unchanged, half
of the voices left out, an answer altered where it is produced) must come
out not correct. One chip has no exchange between chips to leave out.
All at the tiny CPU size of conftest.tiny, with the configurations' own
limits, in every closed_stream cell of BENCHMARK.json."""

import time
from dataclasses import fields, replace

import pytest
import torch

from portbench.tests.conftest import STREAM_CELLS, tiny


def cell_and_generator(harness, name):
    cell = tiny(harness.resolve(harness.load_manifest(), name))
    return cell, harness.generator(cell)


def run_and_judge(gen, cell, seed, control=None):
    run = gen.run(cell, seed, 1.5, False, torch.device("cpu"),
                  time.perf_counter())
    return gen.judge(run, cell, control=control)


@pytest.mark.parametrize("name", STREAM_CELLS)
def test_the_control_fails_and_the_port_passes(harness, name):
    cell, gen = cell_and_generator(harness, name)
    run = gen.run(cell, 2**32 + 99, 1.5, False, torch.device("cpu"),
                  time.perf_counter())
    rng_state = run.judge_inputs["rng"].bit_generator.state
    port = gen.judge(run, cell)
    assert port["correct"], port["rows"]
    run.judge_inputs["rng"].bit_generator.state = rng_state
    control = gen.judge(run, cell, control=cell.config["control"])
    assert not control["correct"], control["rows"]
    assert control["failed"] > 0


def unchanged_state(engine):
    real = engine.step_coef_steady

    def step(state, bank, params, x):
        before = replace(state, **{f.name: getattr(state, f.name).clone()
                                   for f in fields(state)})
        _, out = real(state, bank, params, x)
        return before, out
    engine.step_coef_steady = step


def half_the_voices(engine):
    real = engine.step_coef_steady

    def step(state, bank, params, x):
        state, out = real(state, bank, params, x)
        out = out.clone()
        out[out.shape[0] // 2:] = 0.0
        return state, out
    engine.step_coef_steady = step


def altered_answer(engine):
    real = engine.step_coef_steady

    def step(state, bank, params, x):
        state, out = real(state, bank, params, x)
        out = out.clone()
        out[0, 1, 100] += 0.05
        return state, out
    engine.step_coef_steady = step


@pytest.mark.parametrize("fault", [unchanged_state, half_the_voices,
                                   altered_answer])
@pytest.mark.parametrize("name", STREAM_CELLS)
def test_a_broken_timed_path_is_not_correct(harness, monkeypatch, name,
                                            fault):
    cell, gen = cell_and_generator(harness, name)
    real = gen.ConvolutionReverb

    class Broken(real):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            fault(self.engine)

    monkeypatch.setattr(gen, "ConvolutionReverb", Broken)
    verdict = run_and_judge(gen, cell, 2**31 + 3)
    assert not verdict["correct"], verdict["rows"]
