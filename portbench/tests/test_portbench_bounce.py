"""The offline_bounce cells of BENCHMARK.json on the CPU: the whole-track
reference against reference/convolve.py and a direct sum, its 16-bit wire
against the port's, the comparison against what it must reject (the TF32
control and four broken bounces), a rehearsal of whole runs through the
harness, and the cell's readers on synthetic runs.

The CPU cut (tiny_bounce): 4 voices, 4 IRs of 0.1 s, 300-block stems, the
configuration's limits. The IRs' gain is raised by the square root of the
cut in IR length, so the output keeps the full cell's level and the 16-bit
step the same share of it."""

import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench.generators import offline_bounce as gen_module
from portbench.reference import bounce as bref
from portbench.reference.convolve import Reference, pan_gains
from portbench.tests.conftest import ROOT, cells_of_kind
from portbench.tests.test_portbench_reference import direct

BOUNCE_CELLS = cells_of_kind("offline_bounce")
CUT_IR_SECONDS = 0.1
CUT_STEM_BLOCKS = 300


def tiny_bounce(cell):
    """offline_bounce `cell` at the CPU's size: every key but the sizes and
    the IRs' gain as committed."""
    cfg = json.loads(json.dumps(cell.config))
    trf = json.loads(json.dumps(cell.traffic))
    law = cfg["bank"]
    law["gain"] *= math.sqrt(law["ir_seconds"] / CUT_IR_SECONDS)
    law.update(num_irs=4, ir_seconds=CUT_IR_SECONDS)
    cfg["stem_seconds"] = (CUT_STEM_BLOCKS - 0.5) * cfg["block"] / \
        cfg["sample_rate"]
    trf.update(voices=4, check_voices=4, stem_blocks=CUT_STEM_BLOCKS)
    cell.config, cell.traffic = cfg, trf
    return cell


def cut(harness, name):
    cell = tiny_bounce(harness.resolve(harness.load_manifest(), name))
    return cell, harness.generator(cell)


def run_and_judge(gen, cell, seed, control=None):
    run = gen.run(cell, seed, 0.5, False, torch.device("cpu"),
                  time.perf_counter())
    return gen.judge(run, cell, control=control)


# -- the reference -------------------------------------------------------------------


@pytest.mark.parametrize("predelay", [0, 5, 24])
def test_reference_matches_convolve_and_a_direct_sum(predelay):
    """The one-FFT track equals convolve.Reference's partitioned blocks and
    the direct time-domain sum to float64 rounding, over the stem and a
    tail longer than the convolution."""
    rng = np.random.default_rng(11)
    block, blocks, tail = 8, 12, 8
    irs = rng.standard_normal((3, 2, 29))
    x = rng.standard_normal((2, blocks * block)) * 0.3
    params = {"wet": 0.9, "dry": 0.3, "predelay": predelay, "pan_wet": 0.25,
              "pan_dry": -0.5, "level": 0.8}
    select = (2, 1)
    out_samples = (blocks + tail) * block
    got = bref.BounceReference(irs, params, out_samples).render_f64(
        x, select).numpy()

    xz = np.zeros((2, out_samples))
    xz[:, : x.shape[1]] = x

    def inputs(js):
        return np.stack([xz[:, max(j, 0) * block:(max(j, 0) + 1) * block]
                         for j in js])

    blockwise = Reference(irs, block, params).render(
        inputs, select, np.arange(blocks + tail))
    level = params["level"]
    want = direct(xz, [irs[select[0]], irs[select[1]]],
                  params["wet"] * level * pan_gains(params["pan_wet"]),
                  params["dry"] * level * pan_gains(params["pan_dry"]),
                  predelay)
    assert np.abs(want).max() > 1.0    # the clamp is exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, np.concatenate(list(blockwise), axis=-1),
                               rtol=0, atol=1e-12)


def test_pcm16_wire_matches_the_port_bit_for_bit():
    from tpu_audio_torch.utils.wire import decode_pcm16, encode_pcm16

    rng = np.random.default_rng(3)
    k = np.arange(-32768, 32768)
    x = np.concatenate([
        rng.uniform(-1.3, 1.3, 200_000), (k + 0.5) / 32767.0,
        k / 32767.0, [-1.0, 1.0, -0.0, 0.0, 2.0, -2.0]]).astype(np.float32)
    xt = torch.from_numpy(x)
    mine, port = bref.encode_pcm16(xt), encode_pcm16(xt)
    assert mine.dtype == port.dtype == torch.int16
    assert torch.equal(mine, port)
    decoded = bref.decode_pcm16(port).numpy()
    want = decode_pcm16(port.numpy())
    assert decoded.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(decoded.view(np.int32), want.view(np.int32))


def test_fast_length():
    """The least 5-smooth length at or above n, as a search finds it."""
    def smooth(m):
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        return m == 1

    for n in range(1, 2000):
        m = bref.fast_length(n)
        assert m >= n and smooth(m)
        assert not any(smooth(k) for k in range(n, m))
    assert smooth(bref.fast_length(1_499_407))


@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_tail_is_the_engines_history(harness, name):
    """The frozen tail law equals the port's history_blocks at the cell's
    size and at the CPU cut."""
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution

    for cfg in (harness.resolve(harness.load_manifest(), name).config,
                cut(harness, name)[0].config):
        b = cfg["block"]
        length = int(cfg["bank"]["ir_seconds"] * cfg["sample_rate"])
        eng = FMajorPartitionedConvolution(
            1, b, -(-length // b), max_predelay=cfg["model"]["max_predelay"],
            num_irs=2, device="cpu")
        assert gen_module.tail_blocks(cfg) == eng.history_blocks


@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_stem_blocks_agree_with_stem_seconds(harness, name):
    cell = harness.resolve(harness.load_manifest(), name)
    assert gen_module.stem_blocks(cell) == cell.traffic["stem_blocks"]
    cell.traffic = dict(cell.traffic, stem_blocks=cell.traffic["stem_blocks"]
                        + 1)
    with pytest.raises(ValueError, match="stem_seconds"):
        gen_module.stem_blocks(cell)


# -- the comparison ------------------------------------------------------------------


@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_the_control_fails_and_the_port_passes(harness, name):
    cell, gen = cut(harness, name)
    run = gen.run(cell, 2**33 + 41, 0.5, False, torch.device("cpu"),
                  time.perf_counter())
    assert run.judge_inputs["stems"].dtype == np.float32
    k = run.judge_inputs["stems"] * 65536.0
    assert np.array_equal(k, np.round(k))
    state = run.judge_inputs["rng"].bit_generator.state
    port = gen.judge(run, cell)
    assert port["correct"], port["rows"]
    assert list(port["voices"])[0] == 0 and port["voices"][-1] == 3
    run.judge_inputs["rng"].bit_generator.state = state
    control = gen.judge(run, cell, control=cell.config["control"])
    assert not control["correct"], control["rows"]
    assert control["failed"] == control["attempted"] > 0


def segment_shifted(monkeypatch, offline):
    """One segment of every voice comes out a block late."""
    real = offline._collect

    def collect(*args, **kwargs):
        out = real(*args, **kwargs)
        nseg = out.shape[1] // 4               # voice-major: v * nseg + s
        rows = out[:, 1::nseg].copy()
        out[1:, 1::nseg] = rows[:-1]
        out[0, 1::nseg] = 0
        return out
    monkeypatch.setattr(offline, "_collect", collect)


def warmup_cut(monkeypatch, offline):
    """Two warm-up steps, below the wet ring's depth (prime_blocks)."""
    real = offline.render_offline
    monkeypatch.setattr(offline, "render_offline",
                        lambda *a, **k: real(*a, **k, warmup_blocks=2))


def half_the_voices(monkeypatch, offline):
    real = offline.render_offline

    def render(*args, **kwargs):
        out = real(*args, **kwargs)
        out[out.shape[0] // 2:] = 0.0
        return out
    monkeypatch.setattr(offline, "render_offline", render)


def tail_missing(monkeypatch, offline):
    real = offline.render_offline
    monkeypatch.setattr(offline, "render_offline",
                        lambda *a, **k: real(*a, **{**k,
                                                    "include_tail": False}))


@pytest.mark.parametrize("fault", [segment_shifted, warmup_cut,
                                   half_the_voices, tail_missing])
@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_a_broken_bounce_is_not_correct(harness, monkeypatch, name, fault):
    from tpu_audio_torch.runtime import offline

    cell, gen = cut(harness, name)
    fault(monkeypatch, offline)
    verdict = run_and_judge(gen, cell, 2**31 + 7)
    assert not verdict["correct"], verdict["rows"]
    assert verdict["failed"] > 0


# -- whole runs through the harness --------------------------------------------------

REHEARSE = r"""
import json, sys, time
T0 = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench import harness
harness.pin_host_threads()
import torch
from portbench.tests.test_portbench_bounce import tiny_bounce
cell = tiny_bounce(harness.resolve(harness.load_manifest(), {cell!r}))
results = [harness.run_cell(cell, 2**34 + 5, 1.0, traced,
                            torch.device("cpu"), T0)
           for traced in (False, True)]
print(json.dumps({{"results": results,
                   "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_cpu_rehearsal_is_correct_and_loads_no_jax(harness, name):
    """run_cell, untraced and traced: correct, with the metrics the
    manifest resolves (on the CPU the traced run has no profile, so no
    device_trace metric)."""
    proc = subprocess.run(
        [sys.executable, "-c", REHEARSE.format(root=str(ROOT), cell=name)],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced = out["results"]
    cell = harness.resolve(harness.load_manifest(), name)
    for result in (plain, traced):
        assert result["correct"] and result["failed"] == 0
        assert result["attempted"] >= 1
        assert list(result)[-1] == "checked"
        assert set(result["checked"]) == {"err_rms", "err_max",
                                          "bounces_misshapen"}
    assert set(plain["metrics"]) == {e["name"] for e in cell.end_to_end}
    assert set(traced["metrics"]) == {
        e["name"] for e in cell.per_layer if e["source"] != "device_trace"}
    assert traced["metrics"]["bounce_captures"]["value"] == 0.0
    assert traced["metrics"]["bounce_loop_s"]["value"] > 0.0
    assert not {"jax", "jaxlib", "flax", "tpu_audio"} & set(out["top"])
    assert "reference seconds" in proc.stderr


# -- the readers ---------------------------------------------------------------------


def reader(name):
    from portbench.harness import load_module

    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def bounce_run(**fields):
    """Two bounces of 5168 blocks at 64 voices, 2.0 s and 2.5 s apart."""
    calls = np.array([100.0, 102.0])
    returns = np.array([102.0, 104.5])
    return gen_module.BounceRun(
        voices=64, block=256, sample_rate=44100, t_proc=90.0,
        t_first_read=100.0, build_s=3.0,
        read_stamps=np.repeat(calls, 5168),
        deliver_stamps=np.repeat(returns, 5168), timed=2 * 5168,
        shapes={"F": 257, "VI": 1024, "Pp": 696, "KOD": 64,
                "dtype": "float32"}, memory_peak_bytes=0, **fields)


def test_readers_on_a_synthetic_run():
    run = bounce_run()
    for name in ("bounce_host_s", "bounce_loop_s", "bounce_captures"):
        assert reader(name).read(run) is None     # a program without them
    assert reader("voice_s_per_s").read(run) == pytest.approx(
        2 * 5168 * 64 * 256 / 44100 / 4.5)
    assert reader("setup_s").read(run) == pytest.approx(10.0)
    run = bounce_run(
        stages=[{"bounce": 2.0, "bounce.input": 0.3, "bounce.loop": 1.0,
                 "bounce.drain": 0.4, "bounce.output": 0.3},
                {"bounce": 2.4, "bounce.input": 0.5, "bounce.loop": 1.2,
                 "bounce.drain": 0.2, "bounce.output": 0.5}],
        counters=[{"steady_captures": 1}, {"steady_captures": 0}])
    assert reader("bounce_host_s").read(run) == pytest.approx(0.8)
    assert reader("bounce_loop_s").read(run) == pytest.approx(1.4)
    assert reader("bounce_captures").read(run) == pytest.approx(0.5)


def test_stage_seconds_and_range_gaps():
    """Per bounce, its span and its children's summed; each idle gap of
    the device named by the innermost bounce range open at its middle."""
    from tpu_audio_torch.utils.profiling import Span

    recs = [Span("bounce", -1, None, 0, 10_000_000_000),
            Span("bounce.input", -1, 0, 0, 1_000_000_000),
            Span("bounce.loop", -1, 0, 1_000_000_000, 9_000_000_000),
            Span("bounce.input", -1, 0, 9_000_000_000, 9_500_000_000),
            Span("other", -1, None, 0, 5),
            Span("bounce", -1, None, 20_000_000_000, None)]
    assert gen_module._stage_seconds(recs) == [
        {"bounce": 10.0, "bounce.input": 1.5, "bounce.loop": 8.0}]

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, device, start, end):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [
        event("tpu_audio.bounce", cpu, 0.0, 1000.0),
        event("tpu_audio.bounce.prime", cpu, 1.0, 100.0),
        event("tpu_audio.bounce.loop", cpu, 100.0, 600.0),
        event("tpu_audio.bounce.loop", cuda, 100.0, 600.0),   # mirrored
        event("tpu_audio.block", cpu, 0.0, 1000.0),           # not the bounce's
        event("fft", cuda, 10.0, 50.0),
        event("ring_mac_kernel", cuda, 150.0, 300.0),
        event("ring_mac_kernel", cuda, 400.0, 500.0),
        event("Memcpy DtoH", cuda, 900.0, 950.0),
        event("fft", cuda, 1200.0, 1300.0),
    ]
    # the bounce's start to the first kernel (prime), kernel to kernel
    # (loop, loop, bounce), the last copy to the bounce's end (bounce), then
    # work after the bounce (outside)
    assert gen_module.range_gaps(events) == {
        "bounce.prime": [pytest.approx(10e-6), 1],
        "bounce.loop": [pytest.approx(200e-6), 2],
        "bounce": [pytest.approx(450e-6), 2],
        "outside": [pytest.approx(200e-6), 1]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", BOUNCE_CELLS)
def test_cell_on_the_card(name):
    """A short traced run of the cell at its full size on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         "9", "--seconds", "6", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checked"]
    assert result["device"]["busy_s"] > 0
    assert "bounce_loop_s" in result["metrics"]
