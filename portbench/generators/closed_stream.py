"""closed_stream: one client streams every voice through the served path,
``ConvolutionReverb(...).session(source, sink).run(state)``, as fast as the
port delivers (a closed loop: the session reads block n+1 only after it has
handed block n's step to the device).

The traffic file's keys:

- ``voices``: the session's stereo voices;
- ``amplitude``: the input noise's standard deviation;
- ``pool_blocks``: distinct pre-drawn blocks per voice (synth.make_pool),
  handed out in an order drawn from the seed (synth.block_order);
- ``session``: StreamSession options (pipeline_depth, chunk_blocks,
  fetch_batch, wire);
- ``warmup_blocks``: blocks of silence streamed in set-up through a
  session and state that are then thrown away;
- ``check_voices``, ``check_blocks``: how many voices (the first and the
  last among them) and blocks (the last delivered among them) the
  comparison draws from the seed;
- ``profile_seconds``: the slice at the end of a traced window that
  ``torch.profiler`` records (it starts there: once started, the
  profiler slows every later launch of the process).

The configuration file's keys: ``sample_rate``, ``block``, ``model``
(ConvolutionReverb's keyword arguments), ``bank`` (the IR law:
``num_irs``, ``ir_seconds``, ``decay``, ``gain``), ``params`` (wet, dry,
predelay, pan_wet, pan_dry, level for every voice and channel; voice v
plays IR v mod num_irs on both channels) and ``limits`` (judge.py).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import synth, trace
from portbench.record import Run
from portbench.reference import judge as judge_lib
from portbench.reference import precision
from portbench.reference.convolve import Reference
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.engine.bank import IRBank
from tpu_audio_torch.runtime.backends import BlockSink, BlockSource


class PoolSource(BlockSource):
    """Hands out block n = pool[order[n]] until `seconds` after its first
    read, stamping each block when the session takes it."""

    def __init__(self, pool: np.ndarray, order: np.ndarray, seconds: float,
                 probe=None, on_read=None):
        self.pool, self.order, self.seconds = pool, order, seconds
        self.probe, self.on_read = probe, on_read
        self.stamps: list[float] = []
        self.t_end = None

    def read(self):
        now = time.perf_counter()
        if self.t_end is None:
            self.t_end = now + self.seconds
        elif now >= self.t_end:
            return None
        n = len(self.stamps)
        self.stamps.append(now)
        if self.probe is None:
            return self.pool[self.order[n % len(self.order)]]
        self.t_end += self.on_read(now, self.t_end)
        with self.probe.span("source"):
            return self.pool[self.order[n % len(self.order)]]


class SilentSource(BlockSource):
    def __init__(self, voices: int, block: int, blocks: int):
        self.block = np.zeros((voices, 2, block), np.float32)
        self.left = blocks

    def read(self):
        if self.left <= 0:
            return None
        self.left -= 1
        return self.block


class KeepSink(BlockSink):
    """Stamps each delivered block and keeps the rows of the voices the
    comparison will hold against the reference."""

    def __init__(self, rows: np.ndarray, probe=None):
        self.rows, self.probe = rows, probe
        self.stamps: list[float] = []
        self.kept: list[np.ndarray] = []

    def write(self, block: np.ndarray) -> None:
        self.stamps.append(time.perf_counter())
        if self.probe is None:
            self.kept.append(block[self.rows])
            return
        with self.probe.span("sink"):
            self.kept.append(block[self.rows])


class NullSink(BlockSink):
    def write(self, block: np.ndarray) -> None:
        pass


def _set_params(control, params: dict, num_irs: int) -> None:
    """Every voice at the configuration's parameters, voice v on IR
    v mod num_irs on both channels, with no crossfade in flight."""
    v = control.num_voices
    control.select[:] = (np.arange(v) % num_irs)[:, None]
    control.vsteps[:] = 0
    control.predelay[:] = int(params["predelay"])
    control.wet[:] = params["wet"]
    control.dry[:] = params["dry"]
    control.pan_wet[:] = params["pan_wet"]
    control.pan_dry[:] = params["pan_dry"]
    control.level[:] = params["level"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_rows(rng, voices: int, count: int) -> np.ndarray:
    inner = rng.choice(np.arange(1, voices - 1),
                       size=min(max(count - 2, 0), max(voices - 2, 0)),
                       replace=False)
    return np.unique(np.concatenate([[0, voices - 1], inner])).astype(np.int64)


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_proc: float) -> Run:
    """One run of `cell`: set-up (the inputs from the seed, the model, a
    warm-up session of silence on a state then dropped, a fresh state),
    the window of `seconds` and, when `traced`, the probes and the
    profiled slice. The port's state is freed before it returns."""
    t_gen = time.perf_counter()
    cfg, trf = cell.config, cell.traffic
    voices, block, rate = trf["voices"], cfg["block"], cfg["sample_rate"]
    law = cfg["bank"]
    irs = synth.make_irs(seed, law["num_irs"], law["ir_seconds"], rate,
                         law["decay"], law["gain"], device)
    pool = synth.make_pool(seed, trf["pool_blocks"], voices, block,
                           trf["amplitude"], device)
    order = synth.block_order(seed, trf["pool_blocks"])
    rng = synth.sample_rng(seed)
    rows = _check_rows(rng, voices, trf["check_voices"])
    probe = trace.Probe(device) if traced else None

    t_build = time.perf_counter()
    bank = IRBank(sample_rate=rate)
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=voices, block=block,
                              sample_rate=rate, device=device,
                              **cfg["model"])
    _set_params(model.control, cfg["params"], len(irs))
    if probe is not None:
        probe.install_steps(model.engine)
    opts = trf["session"]
    warm = model.session(SilentSource(voices, block, trf["warmup_blocks"]),
                         NullSink(), **opts)
    warm.run(model.init_state())
    del warm
    state = model.init_state()
    _sync(device)
    build_s = time.perf_counter() - t_build

    profiled = None
    slice_ = None
    if probe is not None:
        probe.step_host_s.clear()
        probe.step_events.clear()
        slice_ = trace.Slice(probe)
        lead = trf["profile_seconds"]

        def on_read(now, t_end):
            """Start the profiled slice `lead` seconds before the window's
            end; the window then runs on for as long as the profiler took
            to start (its first start sets up CUPTI), so that the slice
            holds `lead` seconds of blocks."""
            nonlocal profiled
            if (profiled is not None or device.type != "cuda"
                    or now < t_end - lead):
                return 0.0
            profiled = len(source.stamps) - 1
            slice_.start()
            return time.perf_counter() - now
    else:
        on_read = None
    source = PoolSource(pool, order, seconds, probe, on_read)
    sink = KeepSink(rows, probe)
    session = model.session(source, sink, **opts)
    if probe is not None:
        probe.install_session(session)
    session.run(state)
    if slice_ is not None:
        slice_.stop()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    shapes = {"F": model.engine.num_bins, "VI": 2 * voices,
              "Pp": model.engine.pp,
              "KOD": int(model.spectra.rhs2.shape[3]),
              "dtype": str(model.engine.mac_dtype).removeprefix("torch.")}
    reads = np.asarray(source.stamps)
    parts = {"imports": t_gen - t_proc, "inputs": t_build - t_gen,
             "build": build_s, "window_start": reads[0] - t_build - build_s}
    timed = len(reads) if profiled is None else max(profiled - 1, 0)
    out = Run(voices=voices, block=block, sample_rate=rate, t_proc=t_proc,
              t_first_read=float(reads[0]), build_s=build_s,
              read_stamps=reads, deliver_stamps=np.asarray(sink.stamps),
              timed=timed, shapes=shapes, memory_peak_bytes=int(peak),
              setup_parts=parts)
    if probe is not None:
        out.step_device_ms = probe.step_device_ms()
        out.step_host_s = list(probe.step_host_s)
        out.profile = slice_.summary()
    out.judge_inputs = {"irs": irs, "pool": pool, "order": order,
                        "rows": rows, "kept": sink.kept, "rng": rng,
                        "params": cfg["params"], "limits": cfg["limits"]}
    # the program's state goes before the reference runs
    del session, state, model, bank, source, sink, probe, slice_
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def check_blocks(ref: Reference, delivered: int, rng, count: int
                 ) -> np.ndarray:
    """`count` blocks, the last delivered among them, drawn from those
    whose output depends on every partition of the IRs and on the
    predelay: none of them reads the silence before the stream's start."""
    first = ref.partitions + ref.predelay // ref.block + 1
    last = delivered - 1
    if last < first:
        return np.zeros(0, np.int64)
    inner = rng.choice(np.arange(first, last),
                       size=min(count - 1, last - first), replace=False)
    return np.unique(np.concatenate([inner, [last]])).astype(np.int64)


def render_reference(ref: Reference, inputs: dict, blocks: np.ndarray
                     ) -> np.ndarray:
    """[len(blocks), rows, 2, B] float64 for the checked voices."""
    pool, order = inputs["pool"], inputs["order"]
    k = inputs["irs"].shape[0]
    out = np.empty((len(blocks), len(inputs["rows"]), 2, ref.block))
    for r, v in enumerate(inputs["rows"]):
        def voice_inputs(js, v=v):
            return pool[order[np.maximum(js, 0) % len(order)], v]
        out[:, r] = ref.render(voice_inputs, (v % k, v % k), blocks)
    return out


def judge(run: Run, cell, control=None) -> dict:
    """The comparison with the float64 reference over the sample drawn
    from the seed. `control` (a precision.FORMATS name) puts the reference
    computed in that precision in the port's place."""
    inputs = run.judge_inputs
    attempted = len(run.read_stamps)
    delivered = len(run.deliver_stamps)
    ref = Reference(inputs["irs"], run.block, inputs["params"])
    blocks = check_blocks(ref, delivered, inputs["rng"],
                          cell.traffic["check_blocks"])
    limits = inputs["limits"]
    if len(blocks) == 0:
        numbers = {name: float("nan") for name in limits}
    else:
        want = render_reference(ref, inputs, blocks)
        if control is None:
            got = np.stack([inputs["kept"][t] for t in blocks])
        else:
            low = Reference(inputs["irs"], run.block, inputs["params"],
                            quantize=precision.FORMATS[control])
            got = render_reference(low, inputs, blocks)
        numbers = judge_lib.gap_numbers(got, want)
    ok, rows = judge_lib.verdict(numbers, limits)
    missing = attempted - delivered
    rows.append(("blocks_missing", float(missing), 0.0))
    correct = ok and missing == 0
    failed = (attempted if len(blocks) == 0
              else missing + (0 if ok else len(blocks)))
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "rows": rows, "blocks": blocks}
