"""The metric readers on synthetic runs: the rate and the tail move with a
stall, the profile's readers read what the slice recorded and nothing
else."""

import importlib

import numpy as np
import pytest

from portbench import trace
from portbench.record import Run
from portbench.tests.conftest import ROOT


def reader(name):
    from portbench.harness import load_module

    return load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def window(stall_at=None, stall_s=0.05, blocks=2000, pace=0.004,
           latency=0.006):
    """A closed loop: block n handed over every `pace` seconds and
    delivered `latency` later; a stall delays block `stall_at` and every
    block after it."""
    reads = 10.0 + pace * np.arange(blocks)
    delivered = reads + latency
    if stall_at is not None:
        delivered[stall_at] += stall_s
        reads[stall_at + 1:] += stall_s
        delivered[stall_at + 1:] += stall_s
    return Run(voices=1024, block=256, sample_rate=44100, t_proc=1.0,
               t_first_read=float(reads[0]), build_s=2.0,
               read_stamps=reads, deliver_stamps=delivered, timed=blocks,
               shapes={"F": 257, "VI": 2048, "Pp": 696, "KOD": 64,
                       "dtype": "float32"}, memory_peak_bytes=0)


def test_rate_counts_every_block_over_the_whole_window():
    run = window()
    wall = run.deliver_stamps[-1] - run.read_stamps[0]
    assert reader("voice_s_per_s").read(run) == pytest.approx(
        2000 * 1024 * 256 / 44100 / wall)
    assert reader("setup_s").read(run) == pytest.approx(9.0)


def test_a_stall_moves_the_rate_and_the_tail():
    calm, stalled = window(), window(stall_at=1000, stall_s=0.2)
    rate = reader("voice_s_per_s")
    assert rate.read(stalled) < rate.read(calm) * 0.98
    # a stall of one block is below the 99th percentile of 2000 blocks;
    # 30 stalls are above it
    many = window()
    for n in range(100, 1900, 60):
        many.deliver_stamps[n] += 0.05
    p99 = reader("block_ms_p99")
    assert p99.read(calm) == pytest.approx(6.0)
    assert p99.read(many) > 50.0
    assert reader("block_ms_p50").read(many) == pytest.approx(6.0)
    assert reader("deadline_missed_pct").read(calm) == 100.0 * 1 * (
        6.0 > 256 / 44.1)


def test_stamp_metrics_stop_at_the_profiled_slice():
    run = window()
    run.deliver_stamps[1500:] += 1.0       # the profiler's slice
    run.timed = 1499
    assert reader("block_ms_p99").read(run) == pytest.approx(6.0)


def test_step_probes_and_profile_readers():
    run = window()
    for name in ("step_enqueue_ms", "step_device_ms", "device_idle_pct",
                 "ring_mac_roofline"):
        assert reader(name).read(run) is None    # nothing to read
    run.step_host_s = [0.002, 0.004]
    run.step_device_ms = [3.0, 3.5]
    assert reader("step_enqueue_ms").read(run) == pytest.approx(3.0)
    assert reader("step_device_ms").read(run) == pytest.approx(3.25)
    run.profile = {"busy_s": 0.6, "window_s": 1.5, "gaps": {},
                   "kernels": {"void ring_mac_kernel(int const*)": [0.56, 200],
                               "ring_mac_small_kernel<64>": [0.0, 0],
                               "void fft_c2r(float)": [0.04, 400]}}
    assert reader("device_idle_pct").read(run) == pytest.approx(60.0)
    # 200 launches of a 1.400 ms bound in 0.56 s: 50 %
    assert reader("ring_mac_roofline").read(run) == pytest.approx(
        50.0, rel=1e-3)
    run.profile["kernels"] = {"void fft_c2r(float)": [0.04, 400]}
    assert reader("ring_mac_roofline").read(run) is None


def test_union_and_span_naming():
    assert trace._union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3],
                                                              [5, 8]]
    spans = sorted([(0.0, 10.0, "deliver"), (2.0, 4.0, "sink"),
                    (11.0, 15.0, "step")])
    starts = [s for s, _, _ in spans]
    assert trace._span_at(spans, starts, 3.0) == "sink"
    assert trace._span_at(spans, starts, 5.0) == "deliver"
    assert trace._span_at(spans, starts, 10.5) == "session"
    assert trace._span_at(spans, starts, 12.0) == "step"


def test_readers_import_nothing_of_the_port():
    for path in (ROOT / "portbench" / "metrics").glob("*.py"):
        text = path.read_text()
        assert "tpu_audio" not in text and "jax" not in text, path
    importlib.import_module("portbench.record")


def test_a_split_metric_reads_with_its_quantity():
    from portbench import harness

    bench = ROOT / "portbench"
    assert harness.reader_path(bench, "block_ms_p99.host_paced") == (
        bench / "metrics" / "block_ms_p99.py")
    assert harness.reader_path(bench, "ring_mac_roofline") == (
        bench / "metrics" / "ring_mac_roofline.py")


def test_slice_summary_reads_device_intervals_and_names_gaps():
    """Slice.summary over a fake profile: two kernels that overlap count
    once, the annotations mirrored onto the device are no device work,
    and each gap takes the host span open at its middle."""
    from types import SimpleNamespace

    import torch

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def event(name, device, start, end):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=end))

    events = [
        event("portbench.step", cpu, 0.0, 100.0),
        event("portbench.step", cuda, 0.0, 100.0),   # mirrored annotation
        event("portbench.deliver", cpu, 100.0, 400.0),
        event("portbench.sink", cpu, 320.0, 375.0),
        event("ring_mac_kernel<64>", cuda, 10.0, 60.0),
        event("fft", cuda, 50.0, 80.0),              # overlaps the MAC
        event("Memcpy DtoH", cuda, 200.0, 300.0),
        event("ring_mac_kernel<64>", cuda, 380.0, 400.0),
    ]
    probe = trace.Probe(torch.device("cpu"))
    sl = trace.Slice(probe)
    sl.prof = SimpleNamespace(events=lambda: events)
    sl.t0, sl.t1 = 0.0, 0.001
    out = sl.summary()
    assert out["busy_s"] == pytest.approx((70 + 100 + 20) * 1e-6)
    assert out["window_s"] == pytest.approx(0.001)
    assert out["kernels"]["ring_mac_kernel<64>"] == [pytest.approx(70e-6), 2]
    assert out["gaps"] == {"deliver": [pytest.approx(120e-6), 1],
                           "sink": [pytest.approx(80e-6), 1]}
