"""offline_bounce: one client bounces the same per-voice stems through the
port's offline renderer back to back, as the CLI's ``--offline`` does:
``ConvolutionReverb(...).render_offline(stems, segments=..., wire=...,
input_wire=...)``, a closed loop (the next bounce starts when the last one
has returned).

The traffic file's keys:

- ``voices``: the model's stereo voices, one 16-bit stem each;
- ``stem_blocks``: each stem's length in blocks (the configuration's
  ``stem_seconds`` rounded up to a whole block);
- ``amplitude``, ``grid``: the stems' noise, its standard deviation, each
  sample rounded onto k / grid (a 16-bit WAV as io/wav.py's ``read_wav``
  returns it at the reference's scale: grid 65536);
- ``render``: render_offline's keyword arguments (the CLI's ``--offline``
  defaults: auto segments under ``max_virtual_voices``, the tail, the pcm16
  output wire, the input wire detected);
- ``clients``: 1, a closed loop; ``rate``: null, none offered;
- ``check_voices``: how many voices (the first and the last among them) the
  comparison draws from the seed, each compared sample for sample over its
  whole track and tail.

The configuration file's keys are closed_stream's (``sample_rate``,
``block``, ``model``, ``bank``, ``params``, ``limits``, ``control``) and
``stem_seconds``.

Set-up: the IRs and the stems from the seed, the model, one full-length
warm bounce. The window opens at the first timed bounce's call and takes a
bounce only while the time spent plus the last bounce's wall time fits in
it; a bounce delivers its stem blocks when it returns. A traced run passes
``spans=`` to every bounce (a program without it gets none), then profiles
one more whole bounce after the window with trace.Slice and names each of
the device's idle gaps by the innermost ``bounce*`` range of the program
open at its middle. The last bounce's output is judged.
"""

import gc
import inspect
import math
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import synth, trace
from portbench.generators.closed_stream import _check_rows, _set_params, _sync
from portbench.record import Run
from portbench.reference import judge as judge_lib
from portbench.reference import precision
from portbench.reference.bounce import BounceReference
from tpu_audio_torch.engine.bank import IRBank
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime import offline
from tpu_audio_torch.utils.profiling import RANGE_PREFIX, Spans

BOUNCE_RANGE = RANGE_PREFIX + "bounce"


@dataclass
class BounceRun(Run):
    stages: list = field(default_factory=list)    # per timed bounce: {span: s}
    counters: list = field(default_factory=list)  # per timed bounce


def tail_blocks(cfg: dict) -> int:
    """The blocks of ring-out the bounce appends to a stem: the fmajor
    engine's ``history_blocks`` law (engine/fmajor.py), frozen here: the
    delay line's partitions padded to a multiple of 8, the wet ring's
    slots (max_predelay // block + 2) and 2 more."""
    b = cfg["block"]
    length = int(cfg["bank"]["ir_seconds"] * cfg["sample_rate"])
    pp = -(-(-(-length // b)) // 8) * 8
    return pp + cfg["model"]["max_predelay"] // b + 4


def stem_blocks(cell) -> int:
    """The traffic's stem length, checked against the configuration's."""
    cfg, blocks = cell.config, cell.traffic["stem_blocks"]
    want = math.ceil(cfg["stem_seconds"] * cfg["sample_rate"] / cfg["block"])
    if blocks != want:
        raise ValueError(f"stem_blocks {blocks} is not stem_seconds "
                         f"{cfg['stem_seconds']} in whole blocks ({want})")
    return blocks


def make_stems(seed: int, voices: int, samples: int, amplitude: float,
               grid: float, device) -> np.ndarray:
    """[V, 2, T] float32 noise at `amplitude` on the k / `grid` grid (k a
    16-bit integer), drawn on `device` from a fifth child of the seed
    (synth.py's four draw the IRs, a pool, an order and the sample)."""
    child = np.random.SeedSequence(seed % (1 << 128)).generate_state(
        5, np.uint64)[4]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(child))
    x = torch.randn((voices, 2, samples), generator=gen, device=device)
    k = torch.clamp(torch.round(x * (amplitude * grid)), -32768, 32767)
    return (k / grid).cpu().numpy()


def _stage_seconds(records) -> list[dict]:
    """Per ``bounce`` record: {its name and each child's: seconds}."""
    out, index = [], {}
    for i, r in enumerate(records):
        if r.end_ns is None:
            continue
        if r.name == "bounce" and r.parent is None:
            index[i] = len(out)
            out.append({"bounce": (r.end_ns - r.start_ns) * 1e-9})
        elif r.parent in index:
            row = out[index[r.parent]]
            row[r.name] = row.get(r.name, 0.0) + (r.end_ns - r.start_ns) * 1e-9
    return out


def range_gaps(events) -> dict:
    """{the innermost bounce range open at the gap's middle: [idle s,
    gaps]} over the device's idle gaps in `events` (torch.profiler's, the
    device work picked as trace.Slice.summary picks it): those between its
    activities and those between the start or end of a ``bounce`` range
    and the activity nearest it, so that host stages before the first
    kernel and after the last copy count too; "outside" where no bounce
    range is open."""
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in events:
        if e.name.startswith(RANGE_PREFIX):
            if e.device_type == cpu and e.name.startswith(BOUNCE_RANGE):
                spans.append((e.time_range.start, e.time_range.end,
                              e.name[len(RANGE_PREFIX):]))
            continue
        if (e.device_type == cuda
                and not getattr(e, "is_user_annotation", False)
                and not e.name.startswith("ProfilerStep")):
            device.append((e.time_range.start, e.time_range.end))
    edges = [(t, t) for s, e, name in spans if name == "bounce"
             for t in (s, e)]
    union = trace._union(device + edges)
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps: dict[str, list] = {}
    for (_, end), (nxt, _) in zip(union, union[1:]):
        name = trace._span_at(spans, starts, 0.5 * (end + nxt))
        entry = gaps.setdefault("outside" if name == "session" else name,
                                [0.0, 0])
        entry[0] += (nxt - end) * 1e-6
        entry[1] += 1
    return gaps


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_proc: float) -> BounceRun:
    """One run of `cell`: set-up (the inputs from the seed, the model, a
    warm bounce), the window of `seconds` and, when `traced`, the spans
    and one profiled bounce. The port's state is freed before it
    returns."""
    t_gen = time.perf_counter()
    cfg, trf = cell.config, cell.traffic
    if trf["clients"] != 1 or trf["rate"] is not None:
        raise ValueError("offline_bounce runs one closed-loop client")
    voices, block, rate = trf["voices"], cfg["block"], cfg["sample_rate"]
    blocks = stem_blocks(cell)
    law = cfg["bank"]
    irs = synth.make_irs(seed, law["num_irs"], law["ir_seconds"], rate,
                         law["decay"], law["gain"], device)
    stems = make_stems(seed, voices, blocks * block, trf["amplitude"],
                       trf["grid"], device)

    t_build = time.perf_counter()
    bank = IRBank(sample_rate=rate)
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=voices, block=block,
                              sample_rate=rate, device=device,
                              **cfg["model"])
    _set_params(model.control, cfg["params"], len(irs))
    # a program whose renderer has no spans or counters runs without them
    has_spans = "spans" in inspect.signature(
        offline.render_offline).parameters
    has_counters = hasattr(model, "offline_counters")
    opts = trf["render"]

    def bounce(spans=None):
        extra = {"spans": spans} if spans is not None else {}
        t0 = time.perf_counter()
        out = model.render_offline(stems, **opts, **extra)
        return out, t0, time.perf_counter()

    _, w0, w1 = bounce()
    _sync(device)
    build_s = time.perf_counter() - t_build

    spans = Spans() if traced and has_spans else None
    calls, returns, shapes, counters = [], [], [], []
    last_wall = w1 - w0
    out = None
    while not calls or (time.perf_counter() - calls[0] + last_wall
                        <= seconds):
        out, t0, t1 = bounce(spans)
        calls.append(t0)
        returns.append(t1)
        shapes.append(tuple(out.shape))
        if has_counters:
            counters.append(model.offline_counters())
        last_wall = t1 - t0
    stages = _stage_seconds(spans.records()) if spans is not None else []
    if stages:
        print("bounce stages, mean s: " + ", ".join(
            f"{name} {np.mean([row.get(name, 0.0) for row in stages]):.4f}"
            for name in stages[0]), file=sys.stderr)
    if counters:
        print(f"bounce counters, last: {counters[-1]}", file=sys.stderr)

    profile = None
    if traced and device.type == "cuda":
        slice_ = trace.Slice(trace.Probe(device))
        slice_.start()
        out, _, _ = bounce(Spans() if has_spans else None)
        slice_.stop()
        shapes.append(tuple(out.shape))
        profile = slice_.summary()
        if profile is not None:
            profile["gaps"] = range_gaps(slice_.prof.events())
        del slice_
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    virtual = (counters[-1]["virtual_voices"] if counters else
               max(model.engine.__dict__.get("_offline_engines", {voices: 0})))
    shapes_mac = {"F": model.engine.num_bins, "VI": 2 * virtual,
                  "Pp": model.engine.pp,
                  "KOD": int(model.spectra.rhs2.shape[3]),
                  "dtype": str(model.engine.mac_dtype).removeprefix("torch.")}
    reads = np.repeat(np.asarray(calls), blocks)
    delivered = np.repeat(np.asarray(returns), blocks)
    parts = {"imports": t_gen - t_proc, "inputs": t_build - t_gen,
             "build": build_s, "window_start": calls[0] - t_build - build_s}
    result = BounceRun(
        voices=voices, block=block, sample_rate=rate, t_proc=t_proc,
        t_first_read=float(calls[0]), build_s=build_s, read_stamps=reads,
        deliver_stamps=delivered, timed=len(delivered), shapes=shapes_mac,
        memory_peak_bytes=int(peak), profile=profile, setup_parts=parts,
        stages=stages, counters=counters)
    result.judge_inputs = {
        "irs": irs, "stems": stems, "output": out, "shapes": shapes,
        "rng": synth.sample_rng(seed), "params": cfg["params"],
        "limits": cfg["limits"],
        "want_shape": (voices, 2, (blocks + tail_blocks(cfg)) * block)}
    # the program's state goes before the reference runs
    del model, bank, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return result


def judge(run: BounceRun, cell, control=None) -> dict:
    """The last bounce's output against the float64 reference through the
    16-bit wire, over every sample of the voices drawn from the seed, and
    every bounce's shape against the stems' with their tail. `control` (a
    precision.FORMATS name) puts the reference computed with its spectral
    products' operands in that precision in the port's place."""
    inputs = run.judge_inputs
    t0 = time.perf_counter()
    shapes, want_shape = inputs["shapes"], inputs["want_shape"]
    misshapen = sum(s != want_shape for s in shapes)
    rows = _check_rows(inputs["rng"], run.voices,
                       cell.traffic["check_voices"])
    limits = inputs["limits"]
    out = inputs["output"]
    if out is None or tuple(out.shape) != want_shape:
        numbers = {name: float("nan") for name in limits}
    else:
        k = inputs["irs"].shape[0]
        ref = BounceReference(inputs["irs"], inputs["params"], want_shape[-1])
        low = (None if control is None else
               BounceReference(inputs["irs"], inputs["params"],
                               want_shape[-1],
                               quantize=precision.FORMATS[control]))
        want = np.empty((len(rows), 2, want_shape[-1]), np.float32)
        got = out[rows] if low is None else np.empty_like(want)
        for r, v in enumerate(rows):
            select = (v % k, v % k)
            want[r] = ref.render(inputs["stems"][v], select).numpy()
            if low is not None:
                got[r] = low.render(inputs["stems"][v], select).numpy()
        numbers = judge_lib.gap_numbers(got, want)
    ok, checked = judge_lib.verdict(numbers, limits)
    checked.append(("bounces_misshapen", float(misshapen), 0.0))
    attempted = len(shapes)
    print(f"reference seconds: {time.perf_counter() - t0:.3f}",
          file=sys.stderr)
    return {"correct": ok and misshapen == 0, "attempted": attempted,
            "failed": attempted if not ok else misshapen, "rows": checked,
            "voices": rows}
