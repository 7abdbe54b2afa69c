"""churn_stream: closed_stream's closed loop, with players re-selecting IRs
live by MIDI: ``ConvolutionReverb(...).session(source, sink).run(state,
midi=MidiSchedule(...))``, voice v's two channels mapped to the MIDI
device ``v<v>`` by a ``CCMapping`` each, as the CLI's settings install
them, and every switch crossfading at the configuration's speed.

The traffic file's keys are closed_stream's (``voices``, ``amplitude``,
``pool_blocks``, ``session``, ``warmup_blocks``, ``check_voices``,
``check_blocks``, ``profile_seconds``) and:

- ``churn``: ``first_block`` and ``every_blocks`` (the event blocks),
  ``voices_per_event`` (one select message each, to an IR other than the
  voice's current one, drawn from the seed), ``interrupting`` (how many
  of them are drawn from the voices re-selected within the last
  ``live_within_blocks``, so that they interrupt a live fade; the others
  from the voices not re-selected within the last ``fresh_after_blocks``,
  whose fades have decayed);
- ``judge_span_blocks``: the comparison draws its blocks from the last
  this many delivered (the sink keeps them whole);
- ``fading_level``, ``min_fading_share``, ``min_interrupted_pairs``: at
  least that share of the judged (voice, block) pairs lie inside a fade
  whose a is at or above ``fading_level``, and at least that many inside
  one that interrupted a live fade.

The configuration file's keys are closed_stream's and ``midi``:
``status`` (the CC status byte), ``select_cc`` (the controller that
selects), ``speed`` (the crossfade's vsteps, every channel).

Set-up: the inputs and the event schedule from the seed, the model with
its mappings, a warm-up session of silence that re-selects a few voices
(so that the select collapse and the fade step have run), then the
parameters and a fresh state as the window starts. The schedule reaches
as far as synth.ORDER_LENGTH blocks. A traced run builds the window's
session with ``spans=`` and profiles the window's last
``profile_seconds``, naming each idle gap of the device by the innermost
span of the program open at its middle; the span metrics read the blocks
before the profiled slice.

The comparison: every block handed over must come back; the judged
blocks, then the judged voices (the first and the last among them, then
voices inside interrupted fades, then those inside live fades at the most
judged blocks, ties broken by the seed) are drawn, and held against
reference/crossfade.py.
"""

import collections
import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import synth, trace
from portbench.generators.closed_stream import (NullSink, PoolSource,
                                                SilentSource, _set_params,
                                                _sync)
from portbench.record import Run
from portbench.reference import judge as judge_lib
from portbench.reference import precision
from portbench.reference.crossfade import CrossfadeReference, FadeLaw
from tpu_audio_torch.engine.bank import IRBank
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import BlockSink
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.utils.profiling import RANGE_PREFIX, Spans

SPAN_CAPACITY = 1 << 19    # records: a 51 s traced window's, whole
SPANS = ("control", "select", "step.indexed", "step.steady", "block")


@dataclass
class ChurnRun(Run):
    span_ms: dict = field(default_factory=dict)   # span: [ms] before the slice
    counters: dict = field(default_factory=dict)  # the session's summary()
    blocks: int = 0                               # blocks the session streamed


class TailSink(BlockSink):
    """Stamps each delivered block and keeps the last `keep` of them whole
    (the session hands each one over in a buffer of its own)."""

    def __init__(self, keep: int):
        self.stamps: list[float] = []
        self.kept = collections.deque(maxlen=keep)

    def write(self, block: np.ndarray) -> None:
        self.stamps.append(time.perf_counter())
        self.kept.append((len(self.stamps) - 1, block))


def _schedule_seed(seed: int) -> int:
    """A sixth child of the seed (synth.py's four draw the IRs, a pool, an
    order and the sample; offline_bounce's fifth its stems)."""
    return int(np.random.SeedSequence(seed % (1 << 128)).generate_state(
        6, np.uint64)[5])


def make_events(seed: int, voices: int, num_irs: int, churn: dict,
                select0: np.ndarray, horizon: int) -> list:
    """[(block, voice, ir, cc value)]: one select a chosen voice, both its
    channels, drawn from the seed. The value is drawn among those that
    the reference's scaling (value * bank size / 128, src/conv.cu:259)
    maps onto the new IR."""
    rng = np.random.default_rng(_schedule_seed(seed))
    current = np.asarray(select0[:, 0], np.int64).copy()
    last = np.full(voices, -(1 << 40), np.int64)
    # the values that map onto IR k: [low[k], low[k] + count[k])
    values = np.arange(128) * num_irs // 128
    low = np.searchsorted(values, np.arange(num_irs))
    count = np.bincount(values, minlength=num_irs)
    events = []
    for block in range(churn["first_block"], horizon, churn["every_blocks"]):
        since = block - last
        live = np.flatnonzero(since <= churn["live_within_blocks"])
        fresh = np.flatnonzero(since >= churn["fresh_after_blocks"])
        n_int = min(churn["interrupting"], len(live))
        n_fresh = min(churn["voices_per_event"] - n_int, len(fresh))
        picked = np.sort(np.concatenate([
            rng.choice(live, n_int, replace=False),
            rng.choice(fresh, n_fresh, replace=False)]))
        irs = (current[picked] + 1
               + rng.integers(num_irs - 1, size=len(picked))) % num_irs
        cc = low[irs] + rng.integers(count[irs])
        current[picked] = irs
        last[picked] = block
        events += zip([block] * len(picked), picked.tolist(), irs.tolist(),
                      cc.tolist())
    return events


def midi_events(events: list, midi: dict) -> list:
    """The schedule's MIDI: one CC message a select, to device v<voice>."""
    return [(block, f"v{v}", bytes([midi["status"], midi["select_cc"],
                                    value]))
            for block, v, _, value in events]


def map_voices(control, midi: dict) -> None:
    """Voice v's two channels answer device v<v>'s select CC, every channel
    at the configuration's speed."""
    for v in range(control.num_voices):
        for ch in range(2):
            control.set_mapping(v, ch, CCMapping(
                device=f"v{v}", message=midi["status"],
                select=midi["select_cc"]))
    control.speed[:] = midi["speed"]


def span_gaps(events) -> dict:
    """{the innermost span open at the gap's middle: [idle s, gaps]} over
    the device's idle gaps in `events` (torch.profiler's, the device work
    picked as trace.Slice.summary picks it); the program's ``tpu_audio.*``
    ranges and the harness's own ``portbench.*`` ones name them, "session"
    where none is open."""
    cpu = torch.autograd.DeviceType.CPU
    cuda = torch.autograd.DeviceType.CUDA
    device, spans = [], []
    for e in events:
        for prefix in (RANGE_PREFIX, trace.PREFIX):
            if e.name.startswith(prefix):
                if e.device_type == cpu:
                    spans.append((e.time_range.start, e.time_range.end,
                                  e.name[len(prefix):]))
                break
        else:
            if (e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False)
                    and not e.name.startswith("ProfilerStep")):
                device.append((e.time_range.start, e.time_range.end))
    union = trace._union(device)
    spans.sort()
    starts = [s for s, _, _ in spans]
    gaps: dict[str, list] = {}
    for (_, end), (nxt, _) in zip(union, union[1:]):
        name = trace._span_at(spans, starts, 0.5 * (end + nxt), depth=16)
        entry = gaps.setdefault(name, [0.0, 0])
        entry[0] += (nxt - end) * 1e-6
        entry[1] += 1
    return gaps


def _span_ms(spans: Spans, before: int | None) -> dict:
    """{name: [ms]} of SPANS' closed records whose block comes before
    block `before` (None: every block)."""
    out = {name: [] for name in SPANS}
    for r in spans.records():
        if (r.name in out and r.end_ns is not None
                and (before is None or r.block < before)):
            out[r.name].append((r.end_ns - r.start_ns) * 1e-6)
    return out


def run(cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t_proc: float) -> ChurnRun:
    """One run of `cell`: set-up (the inputs and the schedule from the
    seed, the model, a warm-up session of silence with re-selects, a
    fresh state), the window of `seconds` and, when `traced`, the spans
    and the profiled slice. The port's state is freed before it
    returns."""
    t_gen = time.perf_counter()
    cfg, trf = cell.config, cell.traffic
    voices, block, rate = trf["voices"], cfg["block"], cfg["sample_rate"]
    law, midi = cfg["bank"], cfg["midi"]
    irs = synth.make_irs(seed, law["num_irs"], law["ir_seconds"], rate,
                         law["decay"], law["gain"], device)
    pool = synth.make_pool(seed, trf["pool_blocks"], voices, block,
                           trf["amplitude"], device)
    order = synth.block_order(seed, trf["pool_blocks"])
    rng = synth.sample_rng(seed)
    k = len(irs)
    select0 = np.repeat((np.arange(voices) % k)[:, None], 2, axis=1)
    events = make_events(seed, voices, k, trf["churn"], select0,
                         synth.ORDER_LENGTH)
    probe = trace.Probe(device) if traced else None

    t_build = time.perf_counter()
    bank = IRBank(sample_rate=rate)
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=voices, block=block,
                              sample_rate=rate, device=device,
                              **cfg["model"])
    map_voices(model.control, midi)
    _set_params(model.control, cfg["params"], k)
    opts = trf["session"]
    # the warm-up re-selects a few voices at its third block, so that the
    # select collapse and the fade step have run before the window
    warm_events = [(2, v, int((select0[v, 0] + 1) % k), 0)
                   for v in range(min(voices, trf["churn"]["voices_per_event"]))]
    warm_midi = [(b, f"v{v}", bytes([midi["status"], midi["select_cc"],
                                     -(-ir * 128 // k)]))
                 for b, v, ir, _ in warm_events]
    warm = model.session(SilentSource(voices, block, trf["warmup_blocks"]),
                         NullSink(), **opts)
    warm.run(model.init_state(), midi=MidiSchedule(warm_midi))
    del warm
    _set_params(model.control, cfg["params"], k)
    state = model.init_state()
    schedule = MidiSchedule(midi_events(events, midi))
    _sync(device)
    build_s = time.perf_counter() - t_build

    profiled = None
    slice_ = None
    if probe is not None:
        slice_ = trace.Slice(probe)
        lead = trf["profile_seconds"]

        def on_read(now, t_end):
            """closed_stream's: start the profiled slice `lead` seconds
            before the window's end, and run the window on for as long as
            the profiler took to start."""
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
    sink = TailSink(trf["judge_span_blocks"])
    spans = Spans(SPAN_CAPACITY) if traced else None
    extra = {"spans": spans} if spans is not None else {}
    session = model.session(source, sink, **opts, **extra)
    session.run(state, midi=schedule)
    if slice_ is not None:
        slice_.stop()
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = session.summary()
    counters = dict(summary.get("counters", {}))
    print(f"session counters: {counters}", file=sys.stderr)
    shapes = {"F": model.engine.num_bins, "VI": 2 * voices,
              "Pp": model.engine.pp,
              "KOD": int(model.spectra.rhs2.shape[3]),
              "dtype": str(model.engine.mac_dtype).removeprefix("torch.")}
    reads = np.asarray(source.stamps)
    parts = {"imports": t_gen - t_proc, "inputs": t_build - t_gen,
             "build": build_s, "window_start": reads[0] - t_build - build_s}
    timed = len(reads) if profiled is None else max(profiled - 1, 0)
    out = ChurnRun(voices=voices, block=block, sample_rate=rate,
                   t_proc=t_proc, t_first_read=float(reads[0]),
                   build_s=build_s, read_stamps=reads,
                   deliver_stamps=np.asarray(sink.stamps), timed=timed,
                   shapes=shapes, memory_peak_bytes=int(peak),
                   setup_parts=parts, counters=counters,
                   blocks=int(summary["blocks_streamed"]))
    if spans is not None:
        out.span_ms = _span_ms(spans, profiled)
        print("churn spans, mean ms: " + ", ".join(
            f"{name} {np.mean(ms):.4f} ({len(ms)})"
            for name, ms in out.span_ms.items() if ms), file=sys.stderr)
    if slice_ is not None:
        out.profile = slice_.summary()
        if out.profile is not None:
            out.profile["gaps"] = span_gaps(slice_.prof.events())
            sliced = len(reads) - profiled
            print(f"profiled slice: {sliced} blocks, device busy "
                  f"{out.profile['busy_s'] * 1e3 / max(sliced, 1):.4f} ms "
                  f"a block", file=sys.stderr)
    out.judge_inputs = {
        "irs": irs, "pool": pool, "order": order, "rng": rng,
        "kept": dict(sink.kept), "events": events, "select0": select0,
        "params": cfg["params"], "speed": midi["speed"],
        "limits": cfg["limits"]}
    # the program's state goes before the reference runs
    del session, state, model, bank, source, sink, probe, slice_, spans
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def judged_blocks(first: int, delivered: int, rng, count: int, span: int
                  ) -> np.ndarray:
    """`count` blocks, the last delivered among them, drawn from the last
    `span` delivered, none before `first` (the first block whose output
    depends on every partition of the IRs and on the predelay)."""
    last = delivered - 1
    lo = max(first, delivered - span)
    if last < lo:
        return np.zeros(0, np.int64)
    inner = rng.choice(np.arange(lo, last), size=min(count - 1, last - lo),
                       replace=False)
    return np.unique(np.concatenate([inner, [last]])).astype(np.int64)


def judged_voices(rng, live: np.ndarray, interrupted: np.ndarray,
                  count: int, min_interrupted: int) -> np.ndarray:
    """`count` voices: the first and the last; then, in an order drawn from
    the seed, voices inside interrupted fades at the judged blocks until
    they hold `min_interrupted` pairs; then those inside live fades at the
    most judged blocks, ties broken by the seed. `live`, `interrupted`:
    [V, blocks] bool."""
    voices = live.shape[0]
    picked = sorted({0, voices - 1})
    want = min(count, voices)
    rest = np.setdiff1d(np.arange(voices), picked)
    held = int(interrupted[picked].sum())
    for v in rng.permutation(rest[interrupted[rest].any(axis=1)]):
        if held >= min_interrupted or len(picked) >= want:
            break
        picked.append(int(v))
        held += int(interrupted[v].sum())
    rest = rng.permutation(np.setdiff1d(rest, picked))
    by_live = rest[np.argsort(-live[rest].sum(axis=1), kind="stable")]
    picked += [int(v) for v in by_live[:want - len(picked)]]
    return np.unique(np.asarray(picked, np.int64))


def judge(run: ChurnRun, cell, control=None) -> dict:
    """The comparison with the float64 crossfade reference over the sample
    drawn from the seed, and the sample's hold on the fades. `control` (a
    precision.FORMATS name) puts the reference computed in that precision
    in the port's place."""
    inputs, trf = run.judge_inputs, cell.traffic
    t0 = time.perf_counter()
    attempted = len(run.read_stamps)
    delivered = len(run.deliver_stamps)
    params, irs = inputs["params"], inputs["irs"]
    k = irs.shape[0]
    ref = CrossfadeReference(irs, run.block, params)
    q, r = divmod(ref.predelay, run.block)
    first = ref.partitions + q + 1
    blocks = judged_blocks(first, delivered, inputs["rng"],
                           trf["check_blocks"], trf["judge_span_blocks"])
    limits = inputs["limits"]
    need = (trf["min_fading_share"], trf["min_interrupted_pairs"])
    share = interrupted_pairs = 0.0
    if len(blocks) == 0:
        numbers = {name: float("nan") for name in limits}
        voices = np.zeros(0, np.int64)
    else:
        law = FadeLaw(inputs["select0"], k, params["wet"], inputs["speed"],
                      [(b, v, ch, ir) for b, v, ir, _ in inputs["events"]
                       for ch in range(2)])
        conv = np.unique(np.concatenate([blocks - q] + (
            [blocks - q - 1] if r else [])))
        fades = law.weights(conv)
        a = np.stack([fades[t - q].a[:, 0] for t in blocks], axis=1)
        live = a >= trf["fading_level"]
        cut = np.stack([fades[t - q].interrupted[:, 0] for t in blocks],
                       axis=1) & live
        voices = judged_voices(inputs["rng"], live, cut,
                               trf["check_voices"], need[1])
        share = float(live[voices].mean())
        interrupted_pairs = float(cut[voices].sum())
        low = (None if control is None else
               CrossfadeReference(irs, run.block, params,
                                  quantize=precision.FORMATS[control]))
        pool, order = inputs["pool"], inputs["order"]
        want = np.empty((len(blocks), len(voices), 2, run.block))
        got = np.full_like(want, np.nan)
        kept = inputs["kept"]
        for n, v in enumerate(voices):
            def voice_inputs(js, v=v):
                return pool[order[np.maximum(js, 0) % len(order)], v]

            def voice_weights(js, v=v):
                return np.stack([fades[int(j)].w[v] for j in js])
            want[:, n] = ref.render(voice_inputs, voice_weights, blocks)
            if low is not None:
                got[:, n] = low.render(voice_inputs, voice_weights, blocks)
            else:
                for i, t in enumerate(blocks):
                    if int(t) in kept:
                        got[i, n] = kept[int(t)][v]
        numbers = judge_lib.gap_numbers(got, want)
    ok, rows = judge_lib.verdict(numbers, limits)
    missing = attempted - delivered
    rows.append(("blocks_missing", float(missing), 0.0))
    rows.append(("unfaded_pair_share", 1.0 - share, 1.0 - need[0]))
    rows.append(("interrupted_pairs_short",
                 float(max(need[1] - interrupted_pairs, 0)), 0.0))
    held = share >= need[0] and interrupted_pairs >= need[1]
    correct = ok and missing == 0 and held
    failed = (attempted if len(blocks) == 0
              else missing + (0 if ok and held else len(blocks)))
    print(f"reference seconds: {time.perf_counter() - t0:.3f}",
          file=sys.stderr)
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "rows": rows, "blocks": blocks, "voices": voices}
