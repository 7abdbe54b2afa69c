"""Time-parallel offline rendering (bounce), far faster than real time (port
of tpu_audio/runtime/offline.py).

The streaming runtime serves one block per step. Offline, the whole input
is known up front, and partitioned overlap-save has finite memory: at
converged parameters one output block depends only on the trailing
``engine.history_blocks`` input blocks. So the track splits into S
segments, each segment becomes a VIRTUAL VOICE of the same engine
(``engine.with_voices(V * S)``; virtual voice s*V + v carries voice v
over segment s, but for a static bounce on the cascade: _stagger), every
virtual voice is primed with the input that precedes its segment (warm-up
output discarded), and all segments stream at once: the engine's voice
axis becomes the time axis.
The step count drops from T to warm-up + ceil(T / S); each step costs more
device work, behind the same host launches.

fmajor engines prime their delay line directly (``prime_fdl``: one batched
rfft of the whole input and one gather), so only the wet ring is streamed
during warm-up (``prime_blocks``). The cascade, the partitioned and the
monolithic engines have no ``prime_fdl`` and stream ``history_blocks`` of
warm-up; the last two and the cascade's 'selected' strategy bounce static
parameters only, as in the JAX package (the automated bounce replays fades
through collapse_pure or fmajor's 'selected' expansion, which they lack).
Every engine bounces in its MAC dtype (``with_voices`` carries it).

Automation (``schedule=``): the host replays the MIDI schedule against a
replica of the control plane in float32, op for op as the engine's fade
recursion runs (_ControlSim), and produces per-block parameter regimes,
re-select event tables and exact fade snapshots at every segment's warm-up
start. Every virtual voice enters its segment with the stream's fade state
and replays events at the stream's blocks, so the bounce matches the live
session to float precision. fmajor ('allk' and 'selected') and the 'allk'
cascade are automatable, from a converged control plane.

What the port does where the JAX renderer serves XLA:

  - the host knows the step index, so segment indices, parameter regimes and
    event rows are gathered on the host from _ControlSim's numpy tables, for
    every step at once, and uploaded before the step loop: a step uploads
    nothing and reads nothing back from the device;
  - the 'selected' collapse runs on the blocks the host event table marks,
    and the 'allk' collapse_pure likewise (on other blocks it is the
    identity);
  - the step loop runs in step chunks (_step_chunks, sized by the host
    bytes of their rows, _STAGING_BYTES): each step's output is copied,
    without waiting, into its chunk's staging buffer (pinned on CUDA), and
    an isfinite accumulator on the device is read once a chunk, after its
    drain; one worker thread writes each chunk's rows into the track-order
    result, off the wire, while the next chunk renders (_write_rows);
  - no compile cache and no background precompile;
  - a mesh (``mesh=``, parallel/mesh.py, voice axis only) splits the
    virtual voices into contiguous lanes, one per voice row: each lane
    runs the row's local engine on its own device, with its own copy of
    the bank, the input and the step tables, and the host loop steps every
    lane in turn, each lane's output copied into its slice of the step
    chunk's staging buffer. The lanes never communicate (the bounce's time
    axis is embarrassingly parallel), and the segment count is rounded so
    that the virtual voices split evenly, in whole stagger groups on the
    cascade (_mesh_round_segments). A mesh with a part axis > 1 is
    refused.

All paths need a fully resident bank (no working-set paging). A CUDA model
launches the engine's kernels on every step; only a CPU model takes their
plain versions.

Spans (``spans=``, a utils/profiling.py Spans; None records nothing): one
``bounce`` span per call, whose children follow one another and tile it:
``bounce.input`` (the checks, the segment plan and the block tensor on
the host: one pass over the f32 input in cache-sized pieces that scans
for the 16-bit grid, quantizes and writes the zero-padded block layout
into a host buffer kept on the base engine, reused by the next bounce of
the same shape and pinned when a lane is on CUDA: _input_blocks),
``bounce.upload`` (the block tensor to every lane's device, from
page-locked memory on CUDA), ``bounce.schedule`` (automated bounces
only: the control replay and the step tables), ``bounce.prime`` (the
replicated control plane, the converged states, the delay lines primed),
``bounce.layout`` (_step_inputs), then once per step chunk ``bounce.loop``
(the chunk's staging buffer and its steps' enqueue) and ``bounce.drain``
(the wait for the device, the isfinite check and the chunk's hand-off to
the output worker), and last ``bounce.output`` (the wait for the worker to
write the last chunk into the result). A chunked bounce repeats the
children once per chunk of the track inside its one ``bounce`` span.
Counters, always kept (``counters=``, a dict cleared and filled;
ConvolutionReverb.offline_counters() reads the last call's): ``segments``
and ``virtual_voices`` (per track chunk), ``steps`` and ``warmup_steps``
(summed over chunks), ``input_wire``, ``input_buffer_reused`` (1 when the
call reused the held buffer and allocated none), ``upload_bytes`` (the
block tensors' bytes sent to the devices), ``fetch_bytes`` (the staging
buffers' bytes read back), ``output_chunks`` (step chunks collected),
``output_overlap_steps`` (kept steps handed to the output worker before
the last step chunk of their render ran: all but the last chunk's) and
the engine's steady-step graph counters (``steady_captures``,
``steady_replays``, ``steady_eager``: engine/fmajor.py) over the call's
steps.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace
from functools import partial

import numpy as np
import torch

from tpu_audio_torch.engine.params import ControlPlane, VoiceParams
from tpu_audio_torch.runtime.stream import GRAPH_COUNTERS, engine_steps
from tpu_audio_torch.utils.log import Log
from tpu_audio_torch.utils.profiling import Spans
from tpu_audio_torch.utils.wire import decode_pcm16, encode_pcm16

# ms per steady step of the ring/'allk' fmajor engine at 4 s IRs as fixed +
# per virtual voice, fitted to the CUDA-event p50 at 64 and 512 virtual
# voices (1.770 and 2.604 ms) on an NVIDIA H100 80GB HBM3 at a 700 W power
# limit (chip_smoke.py phase 16); only used to CHOOSE the auto segment
# count, never for correctness
_STEP_FIXED_MS = 1.65
_STEP_PER_VOICE_MS = 0.00186

def _auto_segments(total_blocks: int, warmup: int, base_voices: int,
                   max_virtual_voices: int) -> int:
    """Segment count minimizing (warmup + T/S) * (c0 + c1*V*S): the warm-up
    overhead (W extra steps) trades against the per-step voice cost.
    d/dS = 0 at S* = sqrt(c0*T / (W*c1*V))."""
    s = math.sqrt(_STEP_FIXED_MS * total_blocks
                  / (max(warmup, 1) * _STEP_PER_VOICE_MS
                     * max(base_voices, 1)))
    s = int(round(s))
    return max(1, min(s, max(1, max_virtual_voices // max(base_voices, 1)),
                      total_blocks))


def _check_stereo(samples, num_voices: int) -> tuple[np.ndarray, bool]:
    """Validate bounce input: shared [2, T] stereo (or [T] mono,
    duplicated), or per-voice [V, 2, T] program material — the same
    convention WavSource streams. Returns (x, per_voice)."""
    x = np.asarray(samples, np.float32)
    if x.ndim == 1:
        x = np.stack([x, x])
    if x.ndim == 3:
        if x.shape[:2] != (num_voices, 2):
            raise ValueError(
                f"per-voice samples must be [{num_voices}, 2, T] "
                f"(model voices, stereo), got {x.shape}")
        return x, True
    if x.ndim != 2 or x.shape[0] != 2:
        raise ValueError(f"samples must be [2, T] stereo, [T] mono, or "
                         f"per-voice [V, 2, T], got {x.shape}")
    return x, False


def _check_full_resident(model) -> None:
    if getattr(model, "working_set", None) is not None:
        raise ValueError(
            "render_offline needs a fully-resident bank: working-set "
            "residency pages IRs on sequential select order, which "
            "time-parallel segments do not have (build the model without "
            "bank_capacity for offline bounces)")


# the 16-bit grids input_wire='auto' tries, in order: k/65536 (the reference
# WAV loader's headroom scaling), k/32768, k/32767 (the pcm16 wire)
_GRIDS = (65536.0, 32768.0, 32767.0)
# samples per piece of the block-tensor pass: 128 KiB of f32, which stays in
# a core's L2 through the piece's passes
_PIECE = 1 << 15
# host bytes of one step chunk's rows (_step_chunks): the step loop is
# collected a chunk at a time, and the output worker writes each chunk into
# the result while the next one runs. A chunk boundary costs ~1 ms of card
# time and the last chunk's write is not hidden: on an NVIDIA H100 80GB
# HBM3 at 700 W the 64-voice, 8-segment pcm16 bounce (0.5 MB a kept step,
# 738 kept steps) spent a median 1.442 s in its loop, drains and output
# wait at 32 MB (12 chunks; 11 bounces), 1.440 s at 16 MB, 1.454 s at
# 64 MB (3 each) and 1.981 s in one chunk (11)
_STAGING_BYTES = 32 << 20


def _on_grid(x: np.ndarray, scale: float) -> bool:
    xs = x * np.float32(scale)
    return bool(xs.min() >= -32768.0 and xs.max() <= 32767.0
                and not np.any(xs != np.round(xs)))


def _detect_input_grid(x: np.ndarray):
    """('pcm16', scale) when every sample of `x` sits exactly on one of the
    16-bit integer grids (_GRIDS, tried in order), else ('f32', None).
    Power-of-two grids round-trip bit-exactly; the 32767 grid reproduces
    the f32 division value exactly (the decoder divides)."""
    for scale in _GRIDS:
        if _on_grid(x, scale):
            return "pcm16", scale
    return "f32", None


def _log_grid(input_wire: str, scale) -> None:
    if input_wire == "pcm16":
        Log.info("offline", "input sits on a 16-bit grid (1/%g): "
                 "uploading as int16, bit-exact", scale)


def _input_decoder(input_wire: str, scale):
    """Decode of the uploaded input tensor on the device (identity for
    f32). Divides by the scale rather than multiplying by its reciprocal:
    exact on power-of-two grids and equal to the host's f32 `k/scale` for
    any scale."""
    if input_wire != "pcm16":
        return lambda a: a
    s = float(np.float32(scale))
    return lambda a: a.to(torch.float32) / s


class _Bounce:
    """One render_offline call's stage spans and counters (see the module
    docstring). Between start() and end() the ``bounce`` span and exactly
    one stage span below it are open."""

    def __init__(self, spans: Spans | None):
        self.spans = spans
        self.current = None
        self.counters = {"segments": 0, "virtual_voices": 0, "steps": 0,
                         "warmup_steps": 0, "input_wire": "f32",
                         "input_buffer_reused": 0,
                         "upload_bytes": 0, "fetch_bytes": 0,
                         "output_chunks": 0, "output_overlap_steps": 0,
                         **dict.fromkeys(GRAPH_COUNTERS, 0)}
        self.buffer_allocated = False

    def start(self) -> None:
        if self.spans is not None:
            self.spans.open("bounce")
            self.spans.open("bounce.input")
            self.current = "input"

    def stage(self, name: str) -> None:
        """Close the open stage span and open ``bounce.<name>``, unless
        that stage is the open one."""
        if self.spans is None or name == self.current:
            return
        self.spans.close()
        self.spans.open("bounce." + name)
        self.current = name

    def end(self) -> None:
        if self.current is not None:
            self.spans.close()
            self.spans.close()
            self.current = None

    def plan(self, nseg: int, virtual_voices: int) -> None:
        self.counters.update(segments=nseg, virtual_voices=virtual_voices)


def _graph_counts(engines) -> dict:
    return {n: sum(getattr(e, n, 0) for e in engines) for n in GRAPH_COUNTERS}


def render_offline(model, samples, *, segments: int | None = None,
                   include_tail: bool = True,
                   warmup_blocks: int | None = None,
                   max_virtual_voices: int = 512,
                   schedule=None,
                   track_chunk_blocks: int | None = None,
                   mesh=None, wire: str = "f32",
                   bucket_blocks=None, input_wire: str = "f32",
                   input_scale: float | None = None,
                   spans: Spans | None = None,
                   counters: dict | None = None) -> np.ndarray:
    """Render `samples` through `model` (ConvolutionReverb) at the control
    plane's current converged parameters: stereo [2, T] shared program
    material (or mono [T], duplicated like the CLI source), or per-voice
    [V, 2, T]. Returns per-voice output [V, 2, T_out], the streaming
    sinks' convention; T_out = T plus the reverb tail (`history_blocks` of
    ring-out) when `include_tail`.

    `segments=None` picks the segment count from the step-cost model
    (_auto_segments); `max_virtual_voices` caps segments * V (device
    memory: the f32 fmajor line is ~2.9 MB per virtual voice at 4 s IRs).
    `warmup_blocks` overrides the priming depth (a testing hook; the
    default is the exactness contract). `schedule` (a MidiSchedule)
    bounces a scripted automation timeline instead of static parameters —
    fmajor (either strategy) or the 'allk' cascade. `track_chunk_blocks`
    bounds device memory for very long tracks: the track renders in chunks
    of that many blocks, each re-primed from the trailing input history
    inside its slice (composable with `schedule=`; on the cascade the
    chunk grid and history prefix round up to the stagger ratio). `mesh`
    (a parallel/mesh.py Mesh with part=1) shards the virtual voices over
    its voice rows (fmajor and cascade engines; raise
    `max_virtual_voices` to feed every device). `wire='pcm16'` encodes
    the output to 16-bit PCM on the device and decodes it on the host: f32
    [V, 2, T] quantized to 1/32767. `bucket_blocks` rounds the padded track length
    up to a grid (or ~3 % with 'auto'); the pad is zero input, trimmed
    from the output. `input_wire='pcm16'` uploads the program material as
    int16, decoded on the device at `input_scale` (default 32767); 'auto'
    uploads bit-exactly when the input sits on a 16-bit grid and falls
    back to f32. `spans` records the call's stage spans and `counters`
    receives its counters (module docstring)."""
    bounce = _Bounce(spans)
    bounce.start()
    try:
        out = _render(model, samples, bounce, segments=segments,
                      include_tail=include_tail, warmup_blocks=warmup_blocks,
                      max_virtual_voices=max_virtual_voices,
                      schedule=schedule, track_chunk_blocks=track_chunk_blocks,
                      mesh=mesh, wire=wire, bucket_blocks=bucket_blocks,
                      input_wire=input_wire, input_scale=input_scale)
    finally:
        bounce.end()
    if counters is not None:
        counters.clear()
        counters.update(bounce.counters)
    return out


def _render(model, samples, bounce: _Bounce, *, segments, include_tail,
            warmup_blocks, max_virtual_voices, schedule, track_chunk_blocks,
            mesh, wire, bucket_blocks, input_wire, input_scale) -> np.ndarray:
    """render_offline's checks, then the one renderer (_render_span) over
    the whole track, or over every chunk of it (_render_chunked)."""
    _check_full_resident(model)
    if wire not in ("f32", "pcm16"):
        raise ValueError(f"wire must be 'f32' or 'pcm16', got {wire!r}")
    if input_wire not in ("f32", "pcm16", "auto"):
        raise ValueError(f"input_wire must be 'f32', 'pcm16', or 'auto', "
                         f"got {input_wire!r}")
    _bucket_total(1, bucket_blocks)  # validate even where chunking ignores it
    if input_wire == "auto" and track_chunk_blocks is not None:
        # every chunk goes up on the whole track's grid; an unchunked
        # bounce resolves 'auto' in its block-tensor pass (_input_blocks)
        input_wire, input_scale = _detect_input_grid(
            np.asarray(samples, np.float32))
        _log_grid(input_wire, input_scale)
    elif input_wire == "pcm16" and input_scale is None:
        input_scale = 32767.0
    eng = model.engine
    selected = schedule is not None and _check_automatable(eng)
    x, per_voice = _check_stereo(samples, eng.num_voices)
    tail = eng.history_blocks if include_tail else 0
    plan = partial(_plan, eng, segments=segments, warmup_blocks=warmup_blocks,
                   max_virtual_voices=max_virtual_voices, mesh=mesh,
                   static=schedule is None)
    render = partial(_render_span, model, per_voice=per_voice,
                     bounce=bounce, mesh=mesh, wire=wire,
                     input_wire=input_wire, input_scale=input_scale,
                     schedule=schedule, selected=selected)
    if track_chunk_blocks is not None:
        return _render_chunked(model, x, track_chunk_blocks, tail, plan,
                               render, schedule, bounce)
    total_blocks = _bucket_total(-(-x.shape[-1] // eng.block) + tail,
                                 bucket_blocks)
    return render(x, plan(total_blocks), x.shape[-1] + tail * eng.block)


def _render_span(model, x: np.ndarray, plan: tuple, keep: int, *,
                 per_voice: bool, bounce: _Bounce, mesh, wire, input_wire,
                 input_scale, schedule, selected: bool, sim=None,
                 abs_base: int = 0) -> np.ndarray:
    """The bounce of `x` (checked [2, T], or [V, 2, T] when `per_voice`)
    as `plan` (_plan's tuple) cuts it, its output trimmed to `keep`
    samples: the step loop runs in step chunks (_collect), and a worker
    thread writes each chunk's rows into the result (_write_rows) while
    the next one runs. Without a schedule every virtual voice steps at the
    control plane's converged parameters; with one it enters its segment
    with the replay's fade state and steps through the replay's tables.
    `sim` is the replay (_ControlSim, built over this span when None),
    read at block ``local + abs_base``: the chunked path's seam
    (_render_chunked)."""
    eng = model.engine
    fast, warmup, nseg, seg_len = plan
    v, b = eng.num_voices, eng.block
    vv, tpad = v * nseg, nseg * seg_len
    ratio, align = _stagger(eng, schedule is None)
    voice_major = align < ratio
    bounce.plan(nseg, vv)
    seng = _virtual_engine(eng, vv)
    lanes = _lanes(seng, model.spectra, mesh)

    # block tensor [T', 2, B] (shared) or [T', V, 2, B] (per-voice), zero
    # past the input (the zero tail flushes the ring-out), on every lane's
    # device
    xb, wire_in, scale = _input_blocks(eng, x, tpad, input_wire,
                                       input_scale, lanes, bounce)
    dec = _input_decoder(wire_in, scale)
    xb_dev = _upload_blocks(xb, lanes, bounce)
    starts = np.arange(nseg) * seg_len - warmup    # warm-up start per segment
    if schedule is not None:
        bounce.stage("schedule")
        if sim is None:
            sim = _ControlSim(model.control, schedule, tpad,
                              np.maximum(starts, 0))
        tables = _schedule_tables(sim, nseg, v, seg_len, warmup, abs_base)
        event = tables.pop("event")
        # the fade state entering each segment's warm-up, [nseg, V, 2, ...]:
        # coef_a, coef_c, the span g and the clipped selection
        snap = [np.stack(f) for f in
                zip(*(sim.snaps[max(t + abs_base, 0)] for t in starts))]
    bounce.stage("prime")
    # virtual voice j's base voice and segment: j = s*V + v (segment-major),
    # or j = v*nseg + s (voice-major: a static bounce on the cascade,
    # _stagger); a schedule's rows are segment-major
    if voice_major:
        voice, seg = np.divmod(np.arange(vv), nseg)
    else:
        seg, voice = np.divmod(np.arange(vv), v)
    p0 = {name: np.asarray(arr)[voice]
          for name, arr in vars(model.control.snapshot()).items()}
    t0 = starts[seg]
    voice_of = voice if per_voice else None
    # the row of step i's [nseg (x V), 2, B] input blocks that each virtual
    # voice reads; None where that is row j itself (_step_inputs' view)
    src = seg * v + voice if per_voice else seg
    src = None if np.array_equal(src, np.arange(vv)) else src

    def rows(arr: np.ndarray, lane: _Lane) -> torch.Tensor:
        """[nseg, V, 2, ...] -> the lane's rows of [nseg*V, 2, ...]."""
        arr = arr.reshape((vv,) + arr.shape[2:])[lane.lo:lane.hi]
        return torch.from_numpy(np.ascontiguousarray(arr)).to(lane.device)

    states, vparams, tbls = [], [], []
    for lane in lanes:
        lo, hi, dev, e, bank = (lane.lo, lane.hi, lane.device, lane.engine,
                                lane.bank)
        vparams.append(VoiceParams(**{name: arr[lo:hi] for name, arr
                                      in p0.items()}).to(dev))
        state = e.init_converged(bank, vparams[-1])
        if schedule is not None:
            g0 = rows(snap[2], lane)
            state = replace(state, coef_a=rows(snap[0], lane),
                            coef_c=rows(snap[1], lane))
            if selected:
                # the 'selected' strategy reads materialized per-voice
                # tensors; the snapshot is still an affine span of the bank
                # (the stream's collapse is base := a*base + c*bank[old],
                # the recursion the host g tracks), so expand g once and
                # gather the pre-event selection
                state = replace(
                    state,
                    base=e._span_expand(bank, g0).to(state.base.dtype
                                                     ).contiguous(),
                    sel_spectra=e._gather_selection(bank,
                                                    rows(snap[3], lane)),
                    base_pure=torch.zeros((hi - lo, 2), dtype=torch.bool,
                                          device=dev))
            else:
                if g0.shape[-1] != state.base_g.shape[-1]:
                    raise ValueError(
                        f"span width mismatch: control plane tracks "
                        f"{g0.shape[-1]} IRs, engine state carries "
                        f"{state.base_g.shape[-1]}")
                state = replace(state, base_g=g0,
                                base_pure=torch.ones((hi - lo, 2),
                                                     dtype=torch.bool,
                                                     device=dev))
            tbls.append({name: torch.from_numpy(np.ascontiguousarray(
                arr[:, lo:hi])).to(dev) for name, arr in tables.items()})
        if fast:
            state = _prime_fast(e, state, xb_dev[dev], t0[lo:hi],
                                _cut(voice_of, lo, hi), dec)
        states.append(state)
    bounce.stage("layout")
    inputs = {dev: _step_inputs(xd, nseg, seg_len, warmup, warmup + seg_len,
                                dec, src)
              for dev, xd in xb_dev.items()}
    del xb_dev

    Log.info("offline", "bounce: %d segment(s) x %d + %d warm-up steps (%d "
             "virtual voices in %d lane(s))%s", nseg, seg_len, warmup, vv,
             len(lanes), "" if sim is None else
             f", {len(sim.regimes)} regime(s), "
             f"{len(sim.ev_changed) - 1} re-select block(s)")

    if schedule is None:
        # converged static params ride the steady step (engine.step where
        # the engine slews its own spectra: the slew is then a converged
        # no-op)
        steady = [engine_steps(lane.engine)[0] for lane in lanes]

        def lane_step(i, j, st, x_i):
            return steady[j](st, lanes[j].bank, vparams[j], x_i)
    else:
        takes_params = seng.collapse_pure_takes_params

        def lane_step(i, j, st, x_i):
            e, bank, tbl = lanes[j].engine, lanes[j].bank, tbls[j]
            params = VoiceParams(**{f: tbl[f][i] for f in _ControlSim.FIELDS})
            if event[i]:
                old, chg = tbl["old"][i], tbl["changed"][i]
                if selected:
                    st = e.collapse(st, bank, old, chg,
                                    new_select=params.select)
                else:
                    st = e.collapse_pure(st, old, chg, *(
                        (params,) if takes_params else ()))
            if selected:
                return e.step_coef(st, bank, params, x_i)
            return e.step_coef_indexed(st, bank, params, x_i)

    def step(i, sts):
        outs = [lane_step(i, j, st, inputs[lane.device](i)[lane.lo:lane.hi])
                for j, (lane, st) in enumerate(zip(lanes, sts))]
        return [s for s, _ in outs], [y for _, y in outs]

    # the step loop in chunks of kept steps; each chunk's rows go to the
    # worker, which writes them into the result while the next chunk runs
    out = np.empty((v, 2, keep), np.float32)
    chunks = _step_chunks(seg_len, vv * 2 * b * (2 if wire == "pcm16" else 4))
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="bounce-output")
    try:
        written = []
        for k0, k1 in chunks:
            first = k0 == 0
            rows = _collect(step, states, warmup if first else 0, k1 - k0,
                            (vv, 2, b), wire, lanes, bounce,
                            start=0 if first else warmup + k0)
            written.append(pool.submit(_write_rows, rows, out, k0, seg_len,
                                       wire, voice_major))
            del rows    # the staging buffer is freed once the worker wrote it
        bounce.stage("output")
        for done in written:
            done.result()
    finally:
        pool.shutdown(cancel_futures=True)
    bounce.counters["output_chunks"] += len(chunks)
    bounce.counters["output_overlap_steps"] += chunks[-1][0]
    return out


def _step_chunks(kept: int, step_bytes: int) -> list[tuple[int, int]]:
    """The kept steps [0, kept) cut into chunks [k0, k1) of as many steps
    as _STAGING_BYTES holds rows of (`step_bytes` a step), the remainder
    last, so the one write left after the loop is the shortest; a bounce
    whose rows fit is one chunk."""
    n = max(1, _STAGING_BYTES // step_bytes)
    return [(k, min(k + n, kept)) for k in range(0, kept, n)]


def _write_rows(rows: np.ndarray, out: np.ndarray, k0: int, seg_len: int,
                wire: str, voice_major: bool) -> None:
    """Kept steps [k0, k0 + n) of _collect's rows [n, nseg*V, 2, B]
    (segment- or voice-major) into the result `out` [V, 2, keep], off the
    wire, in one pass: step k of segment s lands at samples
    s*seg_len*B + k*B of every voice, clipped to `keep`."""
    n, vv, _, b = rows.shape
    v, _, keep = out.shape
    nseg = vv // v
    rows = rows.reshape((n, v, nseg, 2, b) if voice_major
                        else (n, nseg, v, 2, b))
    for s in range(nseg):
        seg = rows[:, :, s] if voice_major else rows[:, s]     # [n, V, 2, B]
        lo = (s * seg_len + k0) * b
        m = min(n * b, keep - lo)
        if m <= 0:
            break
        full, rem = divmod(m, b)
        # a view: the split axis is the contiguous last one
        dst = out[..., lo:lo + full * b].reshape(v, 2, full, b)
        _from_wire(seg[:full], dst.transpose(2, 0, 1, 3), wire)
        if rem:
            _from_wire(seg[full, ..., :rem], out[..., lo + full * b:lo + m],
                       wire)


def _from_wire(src: np.ndarray, dst: np.ndarray, wire: str) -> None:
    if wire == "pcm16":
        decode_pcm16(src, out=dst)
    else:
        np.copyto(dst, src)


def _bucket_total(total_blocks: int, bucket_blocks) -> int:
    """Round the padded track length up to the bucket grid (see
    render_offline's `bucket_blocks`). 'auto' pads at most ~3 %: the grid
    is 2^(bitlen-5), i.e. 1/32 of the track's magnitude."""
    if bucket_blocks is None:
        return total_blocks
    if bucket_blocks == "auto":
        g = max(64, 1 << max(int(total_blocks).bit_length() - 5, 0))
    else:
        g = int(bucket_blocks)
        if g < 1:
            raise ValueError(f"bucket_blocks must be >= 1 or 'auto', "
                             f"got {bucket_blocks}")
    return -(-total_blocks // g) * g


def _chunk_input(x: np.ndarray, lo: int, hist: int, chunk_blocks: int,
                 b: int) -> np.ndarray:
    """Chunk `lo`'s input span: `hist` blocks of history prefix (zeros before
    the track) and `chunk_blocks` of payload (zeros past its end)."""
    t_samples = x.shape[-1]
    xs = np.zeros(x.shape[:-1] + ((hist + chunk_blocks) * b,), np.float32)
    src_lo = (lo - hist) * b
    src_hi = min((lo + chunk_blocks) * b, t_samples)
    if src_hi > max(src_lo, 0):
        dst = max(src_lo, 0) - src_lo
        xs[..., dst:dst + (src_hi - max(src_lo, 0))] = \
            x[..., max(src_lo, 0):src_hi]
    return xs


def _render_chunked(model, x: np.ndarray, chunk_blocks, tail: int, plan,
                    render, schedule, bounce: _Bounce) -> np.ndarray:
    """Bounded-memory bounce: the track renders in `chunk_blocks`-block
    chunks, each an independent time-parallel render (`render`,
    _render_span) of its slice plus `history_blocks` of trailing input
    prefix (output discarded): the contract that makes segments exact
    makes chunks exact. Every chunk has one span length, so one plan
    (`plan`, _plan) serves them all. A schedule is replayed ONCE over the
    whole (chunk-grid-padded) timeline, with fade snapshots at every
    chunk's segment warm-up starts in absolute blocks; each chunk reads
    parameters and events at ``local_block + (chunk_start - hist)``. The
    chunk grid and the history prefix round up to the plan's alignment
    (_stagger): every chunk's start offset then keeps the stream's
    phase."""
    chunk_blocks = int(chunk_blocks)
    if chunk_blocks < 1:
        raise ValueError(f"track_chunk_blocks must be >= 1, "
                         f"got {chunk_blocks}")
    eng = model.engine
    b = eng.block
    _, align = _stagger(eng, schedule is None)
    if chunk_blocks % align:
        chunk_blocks = -(-chunk_blocks // align) * align
        Log.info("offline", "chunk grid rounded up to %d blocks (cascade "
                 "stagger ratio %d alignment)", chunk_blocks, align)
    t_samples = x.shape[-1]
    hist = -(-eng.history_blocks // align) * align
    span = plan(hist + chunk_blocks)
    _, warmup, nseg, seg_len = span
    los = range(0, -(-t_samples // b) + tail, chunk_blocks)
    sim = None
    if schedule is not None:
        tpad = nseg * seg_len
        bounce.stage("schedule")
        sim = _ControlSim(model.control, schedule,
                          max(los[-1] - hist + tpad, tpad),
                          sorted({max(s * seg_len - warmup + lo - hist, 0)
                                  for lo in los for s in range(nseg)}))
    outs = []
    for lo in los:
        bounce.stage("input")
        out = render(_chunk_input(x, lo, hist, chunk_blocks, b), span,
                     (hist + chunk_blocks) * b, sim=sim, abs_base=lo - hist)
        outs.append(out[..., hist * b:])
    out = np.concatenate(outs, axis=-1)
    return out[..., :t_samples + tail * b]


class _ControlSim:
    """Host replay of a MIDI schedule against a control-plane replica.

    Produces, for ``total_blocks`` blocks (padded track + tail):

      - regime-compressed parameter timelines: ``regimes`` (list of field
        dicts, row 0 = the PRE-schedule initial plane, one more row per
        event block), ``regime_starts`` (the block each regime began —
        vsteps decays linearly from there), ``regime_of_block`` [T] i32;
      - re-select event tables: ``ev_changed``/``ev_old`` (row 0 = the
        no-event sentinel) and ``event_of_block`` [T] i32, applied by the
        engine's collapse_pure (or the 'selected' collapse);
      - ``snaps[block] = (coef_a, coef_c, base_g, select)`` — the exact f32
        fade state (and clipped selection) ENTERING ``block`` (pre-event),
        at every requested segment warm-up start.

    The coefficient recursion is the engine's, op for op in float32
    (a *= 1-r; c = c*(1-r) + wet*r with r = 1/(vsteps+5), vsteps
    decremented per block — engine/fmajor.py step_coef), and the span
    collapse is collapse_pure's (g := a*g + c*onehot(old); a=1; c=0), so a
    segment primed from a snapshot continues the recursion with the values
    the streaming session's state would hold.
    """

    FIELDS = ("select", "predelay", "vsteps", "dry", "wet",
              "pan_dry", "pan_wet", "level")

    def __init__(self, control, schedule, total_blocks: int,
                 snap_blocks) -> None:
        v = control.num_voices
        k = max(control.bank_size, 1)
        clone = ControlPlane(v, control.bank_size, control.max_predelay,
                             device="cpu")
        for name in ("select_base", "select_span", "select", "predelay",
                     "vsteps", "speed", "dry", "wet", "pan_dry", "pan_wet",
                     "level"):
            getattr(clone, name)[:] = getattr(control, name)
        clone.mappings = dict(control.mappings)
        if clone.vsteps.any():
            raise ValueError(
                "automated bounce requires a converged starting control "
                "plane (vsteps == 0 everywhere): finish in-flight fades in "
                "the streaming session, or start the schedule from rest")
        pending: dict = {}
        clone.on_select_change = (
            lambda vo, ch, old, new: pending.setdefault((vo, ch), old))

        a = np.zeros((v, 2), np.float32)
        c = clone.wet.astype(np.float32).copy()
        g = np.zeros((v, 2, k), np.float32)
        one = np.float32(1.0)
        five = np.float32(5.0)

        want = set(int(s) for s in snap_blocks)
        self.snaps: dict[int, tuple] = {}

        def regime_row():
            return {
                "select": np.clip(clone.select, 0, k - 1).astype(np.int32),
                "predelay": clone.predelay.astype(np.int32).copy(),
                "vsteps": clone.vsteps.astype(np.int32).copy(),
                "dry": clone.dry.copy(), "wet": clone.wet.copy(),
                "pan_dry": clone.pan_dry.copy(),
                "pan_wet": clone.pan_wet.copy(),
                "level": clone.level.copy(),
            }

        self.regimes = [regime_row()]
        self.regime_starts = [0]
        self.regime_of_block = np.zeros(total_blocks, np.int32)
        self.ev_changed = [np.zeros((v, 2), bool)]
        self.ev_old = [np.zeros((v, 2), np.int32)]
        self.event_of_block = np.zeros(total_blocks, np.int32)

        schedule.rewind_to(0)
        for t in range(total_blocks):
            if t in want:
                self.snaps[t] = (a.copy(), c.copy(), g.copy(),
                                 np.clip(clone.select, 0, k - 1
                                         ).astype(np.int32))
            due = schedule.pop_due(t)
            if due:
                for device, message in due:
                    clone.apply_midi_message(message, device)
                if pending:
                    changed = np.zeros((v, 2), bool)
                    old_sel = np.zeros((v, 2), np.int32)
                    for (vo, ch), old in pending.items():
                        changed[vo, ch] = True
                        old_sel[vo, ch] = old
                    pending.clear()
                    # collapse_pure's span re-base (one_hot of an
                    # out-of-range old yields the zero row)
                    oh = np.zeros((v, 2, k), np.float32)
                    inr = (old_sel >= 0) & (old_sel < k)
                    np.put_along_axis(oh, np.clip(old_sel, 0, k - 1)[..., None],
                                      1.0, axis=2)
                    oh *= inr[..., None]
                    gnew = a[..., None] * g + c[..., None] * oh
                    g = np.where(changed[..., None], gnew, g)
                    a = np.where(changed, one, a).astype(np.float32)
                    c = np.where(changed, np.float32(0.0), c).astype(np.float32)
                    self.ev_changed.append(changed)
                    self.ev_old.append(old_sel)
                    self.event_of_block[t] = len(self.ev_changed) - 1
                self.regimes.append(regime_row())
                self.regime_starts.append(t)
            self.regime_of_block[t] = len(self.regimes) - 1
            r = one / (clone.vsteps.astype(np.float32) + five)
            a = (a * (one - r)).astype(np.float32)
            c = (c * (one - r) + clone.wet * r).astype(np.float32)
            np.maximum(clone.vsteps - 1, 0, out=clone.vsteps)
        late = schedule.pop_due(1 << 62)
        if late:
            Log.warn("offline", "%d scheduled MIDI event(s) fall past the "
                     "bounce's %d blocks (ignored)", len(late), total_blocks)


def _check_automatable(eng) -> bool:
    """Validate that the engine replays automation (coef fades in the span,
    or the 'selected' snapshot expansion); returns the 'selected' flag."""
    strategy = getattr(eng, "mac_strategy", None)
    selected = (strategy == "selected" and hasattr(eng, "_span_expand")
                and hasattr(eng, "_gather_selection"))
    if not (selected or (strategy == "allk"
                         and hasattr(eng, "collapse_pure")
                         and hasattr(eng, "step_coef_indexed"))):
        raise ValueError(
            "automated bounce requires a coef-fade engine: fmajor (either "
            "MAC strategy) or the 'allk' cascade — re-selects and "
            "crossfades replay through collapse(_pure)")
    return selected


def _stagger(eng, static: bool) -> tuple[int, int]:
    """(ratio, align): the engine's stagger ratio (1 on every engine but
    the cascade) and the block count that a bounce's warm-up, segments and
    chunk grid round up to.

    The cascade's tail schedule is staggered: virtual voice j computes its
    tail at local blocks t % ratio == j % ratio, its block counter starting
    at 0 with its segment's warm-up. A scheduled bounce runs on the
    stream's phases, as an event's fade scattering needs: segment-major
    (j % ratio == v % ratio) with every warm-up start on a ratio boundary,
    so align = ratio. A static one runs on the JAX static renderer's:
    voice-major (align < ratio), unrounded. Converged parameters are
    phase-invariant in f32, but the bf16 tail's rounding is not, and the
    port's bf16 static bounce is held to that renderer's."""
    ratio = int(getattr(eng, "ratio", 1))
    return ratio, 1 if static else ratio


def _plan(eng, total_blocks: int, *, segments, warmup_blocks,
          max_virtual_voices, mesh=None, static=False):
    """Segment plan of every bounce: (fast, warmup, nseg, seg_len), the
    warm-up and the segment length rounded up to _stagger's alignment
    (1 unless a scheduled bounce runs on the cascade)."""
    fast = hasattr(eng, "prime_fdl")
    if mesh is not None and not (fast or hasattr(eng, "ratio")):
        raise ValueError(
            "mesh-sharded bounce supports fmajor and cascade engines "
            "(voice data parallelism over the virtual-voice axis)")
    ratio, align = _stagger(eng, static)
    warmup = int(warmup_blocks if warmup_blocks is not None
                 else (eng.prime_blocks if fast else eng.history_blocks))
    warmup = -(-warmup // align) * align
    v = eng.num_voices
    if segments is None:
        nseg = min(_auto_segments(total_blocks, warmup, v,
                                  max_virtual_voices), total_blocks)
    else:
        nseg = int(segments)
        if nseg < 1:
            raise ValueError(f"segments must be >= 1, got {segments}")
    nseg = _mesh_round_segments(nseg, v, mesh, ratio)
    seg_len = -(-(-(-total_blocks // nseg)) // align) * align
    return fast, warmup, nseg, seg_len


def _schedule_tables(sim: _ControlSim, nseg: int, v: int, seg_len: int,
                     warmup: int, abs_base: int) -> dict:
    """Every step's parameters and re-select events, gathered on the host
    from the replay's tables: {field: [steps, nseg*V, 2]} for the eight
    VoiceParams fields plus "old" and "changed" (segment-major: virtual
    voice s*V + v carries voice v over segment s), and "event" [steps]
    bool, True where some virtual voice re-selects.

    Pre-roll steps (absolute block < 0: a segment that starts less than one
    warm-up window into the timeline) read regime row 0, the initial plane,
    whose converged coefficients make the recursion a no-op before block
    0, and no event."""
    steps = warmup + seg_len
    idx = (np.arange(nseg)[None, :] * seg_len
           + np.arange(steps)[:, None] - warmup)                # [steps, nseg]
    aidx = idx + abs_base                                       # absolute block
    live = aidx >= 0
    aidxc = np.clip(aidx, 0, sim.regime_of_block.size - 1)
    reg = np.where(live, sim.regime_of_block[aidxc], 0)
    offs = np.where(live, aidx - np.asarray(sim.regime_starts)[reg], 0)
    ev = np.where(live, sim.event_of_block[aidxc], 0)

    def gather(rows, tbl):
        return tbl[rows].reshape(steps, nseg * v, *tbl.shape[2:])

    out = {f: gather(reg, np.stack([r[f] for r in sim.regimes]))
           for f in _ControlSim.FIELDS}
    out["vsteps"] = np.maximum(
        out["vsteps"] - np.repeat(offs, v, axis=1)[..., None], 0
    ).astype(np.int32)
    out["changed"] = (gather(ev, np.stack(sim.ev_changed))
                      & np.repeat(live, v, axis=1)[..., None])
    out["old"] = gather(ev, np.stack(sim.ev_old))
    out["event"] = out["changed"].any(axis=(1, 2))
    return out


def _input_blocks(eng, x: np.ndarray, t_pad_blocks: int, input_wire: str,
                  input_scale, lanes, bounce: _Bounce):
    """The block tensor of `x` (f32 [2, T] or [V, 2, T]) in the engine's
    host buffer (_input_buffer), its input wire and scale.
    'auto' lays x out as int16 on the first of _GRIDS on which every sample
    sits, else as f32 — _detect_input_grid's answer, found by the pass that
    quantizes. A grid that the first row's first piece already misses is
    not tried, so float input goes straight to the f32 layout."""
    b = eng.block
    per_voice = x.ndim == 3
    shape = (t_pad_blocks,) + (x.shape[:1] if per_voice else ()) + (2, b)
    pinned = any(dev.type == "cuda" for dev in _devices(lanes))
    xb = None
    if input_wire == "auto":
        input_wire, input_scale = "f32", None
        head = x[(0,) * (x.ndim - 1)][:_PIECE]
        for scale in _GRIDS:
            if not _on_grid(head, scale):
                continue
            xb = _block_tensor(x, per_voice, t_pad_blocks, b, x.shape[-1],
                               out=_input_buffer(eng, shape, torch.int16,
                                                 pinned, bounce),
                               scale=scale, exact=True)
            if xb is not None:
                input_wire, input_scale = "pcm16", scale
                _log_grid(input_wire, input_scale)
                break
    if xb is None:
        dtype = torch.int16 if input_wire == "pcm16" else torch.float32
        xb = _block_tensor(x, per_voice, t_pad_blocks, b, x.shape[-1],
                           out=_input_buffer(eng, shape, dtype, pinned,
                                             bounce),
                           scale=input_scale)
    bounce.counters["input_wire"] = input_wire
    return xb, input_wire, input_scale


def _input_buffer(eng, shape: tuple, dtype: torch.dtype, pinned: bool,
                  bounce: _Bounce) -> np.ndarray:
    """The host buffer of a block tensor, kept on the base engine beside
    _offline_engines and reused by the next bounce of the same shape,
    dtype and pinning; only the newest is held. Pinned when a lane is on
    CUDA, so the upload is a DMA from page-locked memory. A bounce may
    rewrite it because no copy out of it is pending by then: the upload
    (a .to that blocks) returns when its copy is done. On a CPU lane the
    uploaded tensor is the buffer itself, and every use of it is a copy
    (the bulk rfft, the prev_in gather, _step_inputs), so nothing the
    bounce returns or keeps aliases it."""
    key = (shape, dtype, pinned)
    held = eng.__dict__.get("_offline_input")
    if held is not None and held[0] == key:
        bounce.counters["input_buffer_reused"] = int(
            not bounce.buffer_allocated)
        return held[1].numpy()
    eng.__dict__.pop("_offline_input", None)    # free it before allocating
    buf = torch.empty(shape, dtype=dtype, pin_memory=pinned)
    eng.__dict__["_offline_input"] = (key, buf)
    bounce.buffer_allocated = True
    bounce.counters["input_buffer_reused"] = 0
    return buf.numpy()


def _block_tensor(x: np.ndarray, per_voice: bool, t_pad_blocks: int,
                  b: int, t_samples: int, out: np.ndarray | None = None,
                  scale: float | None = None, exact: bool = False):
    """Zero-padded block tensor: [T', 2, B] for shared program material,
    [T', V, 2, B] for per-voice [V, 2, T] input, written into `out` (a new
    array of x's dtype by default) in one pass over x, a row and a
    cache-sized piece (_PIECE) at a time; the zero pad is exact in any
    grid. With `scale`: int16 on the k/scale grid, round(x * scale) (half
    to even, in f32) clipped to int16 — or, when `exact`, x * scale itself,
    and None at the first piece holding a value that is no int16 (off the
    grid, out of range or not finite: its int16 cast reads back
    different)."""
    if out is None:
        out = np.empty((t_pad_blocks,) + (x.shape[:1] if per_voice else ())
                       + (2, b), x.dtype)
    dst = out.reshape(t_pad_blocks, -1, b)                  # [T', rows, B]
    tb, rem = divmod(t_samples, b)
    step = max(1, _PIECE // b)
    tmp = np.empty(step * b, np.float32)
    off = np.empty(step * b, bool)
    s = None if scale is None else np.float32(scale)

    def piece(src: np.ndarray, to: np.ndarray) -> bool:
        if s is None:
            np.copyto(to, src)
            return True
        t = tmp[:src.size].reshape(src.shape)
        np.multiply(src, s, out=t)
        if not exact:
            np.clip(np.rint(t, out=t), -32768, 32767, out=t)
        np.copyto(to, t, casting="unsafe")
        if not exact:
            return True
        m = off[:src.size].reshape(src.shape)
        return not np.not_equal(t, to, out=m).any()

    # the int16 cast of a misfit is no fault under `exact`
    with np.errstate(invalid="ignore" if exact else None):
        for r, i in enumerate(np.ndindex(x.shape[:-1])):
            row = x[i]
            blocks = row[:tb * b].reshape(tb, b)
            for t0 in range(0, tb, step):
                t1 = min(t0 + step, tb)
                if not piece(blocks[t0:t1], dst[t0:t1, r]):
                    return None
            if rem and not piece(row[tb * b:t_samples], dst[tb, r, :rem]):
                return None
    if rem:
        dst[tb, :, rem:] = 0
    dst[tb + bool(rem):] = 0
    return out


def _mesh_round_segments(nseg: int, v: int, mesh, ratio: int = 1) -> int:
    """Round the segment count up so the virtual voices split evenly over
    the mesh's voice axis: v*nseg virtual voices for fmajor, and
    v*nseg/ratio stagger-group rows for the cascade, which also makes
    every lane's voice count a whole number of stagger groups."""
    if mesh is None:
        return nseg
    voice_n = int(mesh.shape["voice"])
    w = v // ratio
    need = voice_n // math.gcd(w, voice_n)
    return -(-nseg // need) * need


@dataclass
class _Lane:
    """The virtual voices [lo, hi) one voice row of a mesh renders (every
    virtual voice without a mesh): its engine, its copy of the bank and
    its device."""

    engine: object
    bank: object
    device: torch.device
    lo: int
    hi: int


def _lanes(seng, bank, mesh) -> list[_Lane]:
    if mesh is None:
        return [_Lane(seng, bank, seng.device, 0, seng.num_voices)]
    if mesh.shape["part"] > 1:
        raise ValueError("the mesh-sharded bounce shards the virtual-voice "
                         "axis only: build the mesh with part=1")
    from tpu_audio_torch.parallel.mesh import sharded

    sh = sharded(seng, mesh)
    placed = sh.place_bank(bank)
    n = sh.local_voices
    return [_Lane(sh.locals[r][0], placed.shards[r][0], row[0], r * n,
                  (r + 1) * n) for r, row in enumerate(mesh.devices)]


def _devices(lanes) -> list[torch.device]:
    out = []
    for lane in lanes:
        if lane.device not in out:
            out.append(lane.device)
    return out


def _upload_blocks(xb: np.ndarray, lanes, bounce: _Bounce) -> dict:
    """The block tensor on every lane's device: {device: tensor}."""
    bounce.stage("upload")
    out = {dev: torch.from_numpy(xb).to(dev) for dev in _devices(lanes)}
    bounce.counters["upload_bytes"] += xb.nbytes * len(out)
    return out


def _cut(arr, lo: int, hi: int):
    return None if arr is None else arr[lo:hi]


def _virtual_engine(eng, vv: int):
    """`eng.with_voices(vv)` memoized on the base engine, so repeated
    bounces (chunks, takes) reuse one virtual engine and its constants."""
    cache = eng.__dict__.setdefault("_offline_engines", {})
    if vv not in cache:
        if vv == eng.num_voices:
            cache[vv] = eng
        elif (getattr(eng, "mac_strategy", None) == "allk"
              and getattr(eng, "swap_snapshot", False)):
            # a bounce never swaps banks mid-fade: drop the fmajor fade
            # snapshot `base`, ~5.7 MB per virtual voice at 4 s IRs in ring
            # mode
            cache[vv] = eng.with_voices(vv, swap_snapshot=False)
        else:
            cache[vv] = eng.with_voices(vv)
    return cache[vv]


def _prime_fast(seng, state, xb_dev: torch.Tensor, t0: np.ndarray,
                voice_of: np.ndarray | None, dec):
    """Prime every virtual voice's input history: one batched rfft over the
    whole block tensor (input_spectra_bulk), the gather into the delay line
    (prime_fdl), and prev_in set to block t0-1's samples. `voice_of` maps
    virtual voices onto a per-voice input's base voices (None for shared
    program material). The spectra are freed before the step loop."""
    dev = xb_dev.device
    t0_dev = torch.from_numpy(t0.astype(np.int64)).to(dev)
    vof = (None if voice_of is None
           else torch.from_numpy(voice_of.astype(np.int64)).to(dev))
    spec = seng.input_spectra_bulk(dec(xb_dev))
    state = seng.prime_fdl(state, spec, t0_dev, voice_of=vof)
    del spec
    prev = (t0_dev - 1).clamp(0, xb_dev.shape[0] - 1)
    pim = dec(xb_dev[prev] if vof is None else xb_dev[prev, vof])
    pim = torch.where((t0_dev >= 1)[:, None, None], pim, 0.0)
    return replace(state, prev_in=pim)


def _step_inputs(xb_dev: torch.Tensor, nseg: int, seg_len: int,
                 warmup: int, steps: int, dec, src: np.ndarray | None):
    """Every step's input blocks, laid out on the device before the loop:
    block s*seg_len + i - warmup of each segment s at step i, zero before
    the track, as [nseg*V, 2, B] (per-voice input, segment-major) or
    [nseg, 2, B] (shared). Returns inputs(i) -> f32 [nseg*V, 2, B], step
    i's block of every virtual voice j: row src[j], gathered by one copy
    a step, or row j itself, a view, when `src` is None."""
    dev = xb_dev.device
    idx = (np.arange(nseg)[None, :] * seg_len
           + np.arange(steps)[:, None] - warmup)                # [steps, nseg]
    rows = torch.from_numpy(np.clip(idx, 0, xb_dev.shape[0] - 1).reshape(-1)
                            ).to(dev)
    blocks = dec(xb_dev.index_select(0, rows))
    blocks = blocks.reshape((steps, nseg) + tuple(xb_dev.shape[1:]))
    before = torch.from_numpy(idx < 0).to(dev)
    blocks.view(steps, nseg, -1).masked_fill_(before[..., None], 0.0)
    blocks = blocks.reshape(steps, -1, 2, xb_dev.shape[-1])
    if src is None:
        return lambda i: blocks[i]
    src = torch.from_numpy(src).to(dev)
    return lambda i: blocks[i].index_select(0, src)


def _step_loop(step, state: list, warmup: int, kept: int, out: torch.Tensor,
               wire: str, devices, start: int = 0) -> list:
    """Run `warmup` + `kept` steps from step `start` on, queue each kept
    output's copy into the host buffer `out` without waiting, and return
    the isfinite accumulators (a bool tensor per device, not yet read): the
    loop reads nothing back from the device. `step(i, states)` steps every
    lane and returns (states, the lanes' outputs in virtual-voice order),
    each copied into its rows of `out`; `state`, the lanes' states, is
    advanced in place, so the next step chunk continues from it. The
    accumulators see the RAW output: the pcm16 encoder clips NaN into
    ordinary int16 values, so a check after it could never fail."""
    ok = {dev: torch.ones((), dtype=torch.bool, device=dev)
          for dev in devices}
    for i in range(warmup + kept):
        state[:], ys = step(start + i, state)
        if i < warmup:
            continue
        v0 = 0
        for y in ys:
            ok[y.device] &= torch.isfinite(y).all()
            if wire == "pcm16":
                y = encode_pcm16(y)
            out[i - warmup, v0:v0 + y.shape[0]].copy_(y, non_blocking=True)
            v0 += y.shape[0]
    return list(ok.values())


def _collect(step, state: list, warmup: int, kept: int, shape: tuple,
             wire: str, lanes, bounce: _Bounce, start: int = 0) -> np.ndarray:
    """Drive one step chunk (_step_loop: `warmup` + `kept` steps from step
    `start`, the lanes' states `state` carried from the last chunk and
    advanced in place) and collect its kept steps' rows on the host as
    [kept, *shape], step-major: one staging buffer, pinned on CUDA, takes
    every kept step's output as it is produced; then the devices drain and
    the isfinite accumulators are read, so non-finite output raises on
    every wire, at the first chunk that holds it. Each call adds its steps,
    bytes and graph counts to the bounce's counters."""
    devices = _devices(lanes)
    engines = list({id(lane.engine): lane.engine for lane in lanes}.values())
    graphs = _graph_counts(engines)
    bounce.stage("loop")
    dtype = torch.int16 if wire == "pcm16" else torch.float32
    cuda = devices[0].type == "cuda"
    out = torch.empty((kept,) + shape, dtype=dtype, pin_memory=cuda)
    oks = _step_loop(step, state, warmup, kept, out, wire, devices,
                     start=start)
    bounce.stage("drain")
    if cuda:
        for dev in devices:
            torch.cuda.synchronize(dev)
    if not all(bool(ok) for ok in oks):
        raise RuntimeError(
            "offline bounce produced non-finite output (device isfinite "
            "accumulator on the raw engine output)")
    c = bounce.counters
    for name, n in _graph_counts(engines).items():
        c[name] += n - graphs[name]
    c["steps"] += warmup + kept
    c["warmup_steps"] += warmup
    c["fetch_bytes"] += out.numel() * out.element_size()
    return out.numpy()
