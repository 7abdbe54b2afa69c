"""Application entry point: settings-driven streaming reverb on a GPU (port
of tpu_audio/app/main.py: the streaming path, the live path and the offline
bounce of every engine, and the engine groups of a settings file whose conv
pairs differ).

Capability equivalent of the reference's main() (reference src/main.cu:18-116):
select the GPU, read settings, build IR banks and convolution voices, wire
control mappings and initial values, stream audio, report the average
per-block runtime at exit. The JACK graph becomes file / synthetic block
backends or shared-memory rings that another process (a JACK bridge,
runtime/jack_bridge.py) fills and drains; ALSA rawmidi becomes a scripted
MIDI schedule or live byte FIFOs and device files (--midi-fifo).

    python -m tpu_audio_torch.app --settings settings.txt \
        --input in.wav --output out.wav [--midi events.txt] \
        [--engine fmajor|cascade|partitioned|monolithic [--cascade-ratio N]
         [--predelay-side write|read] [--variant coef|materialized]]
        [--voices N] [--blocks N] [--realtime [--clock sleep|native]]
        [--chunk-blocks N | --fetch-batch N [--wire f32|pcm16]]
        [--cache-dir DIR] [--profile DIR] [--no-swap-snapshot]
        [--bank-prep device|host]
        [--bank-capacity N [--async-paging] [--ws-exhausted defer|raise]
         [--fault-upload td|dual|derived]]
        [--offline [SEGMENTS] [--offline-chunk-blocks N]
         [--offline-wire f32|pcm16] [--offline-input-wire auto|f32|pcm16]
         [--offline-bucket [BLOCKS]]]
        [--device cuda|cpu]

The live path (a server fed by another process, until Enter or EOF):

    python -m tpu_audio_torch.app --settings settings.txt \
        --input-ring tpu_in --output-ring tpu_out [--ring-blocks 64] \
        [--output-latency 4] \
        --realtime --clock native [--midi-fifo [DEV=]PATH ...] \
        [--underrun stop|silence] [--max-dry-blocks N] --until-enter

A settings file whose conv pairs differ in fftSize, maxPredelay or index
files runs one engine group per distinct pair geometry over the same input
and writes their sum (the reference's JACK playback mix), streamed or with
``--offline``; live rings and FIFOs are refused there.

The fmajor and cascade banks are prepared on the engine's device unless
``--bank-prep host`` asks for the numpy prep (the JAX CLI's default);
``--fault-upload`` picks the working set's fault payload, resolved per
engine as the JAX CLI resolves it when absent. ``--fetch-batch N`` fetches
N outputs in one device-to-host copy, ``--wire pcm16`` as 16-bit PCM.
``--cache-dir`` keeps host-computed IR spectra (the partitioned engine's,
and with ``--bank-prep host`` the fmajor and cascade packed banks) in a
disk cache shared with the JAX package (the JAX flag's XLA compile cache
has no counterpart: the CUDA kernels build once into
``tpu_audio_torch/_build/``). ``--profile DIR`` records the session's
spans (runtime/stream.py) and writes a torch.profiler Chrome trace of the
session to ``DIR/<pid>.pt.trace.json``, the spans in it as
``tpu_audio.<span>`` ranges, which ``python -m tpu_audio_torch.app.tools
profile DIR`` summarises; the run's span table and the session's
counters are printed below its summary line.
"""

from __future__ import annotations

import argparse
import os
import time

from tpu_audio_torch.models.reverb import ConvolutionReverb, pair_geometry_keys
from tpu_audio_torch.runtime.backends import (
    ImpulseSource, NoiseSource, NullSink, SilenceSource, WavSink, WavSource,
)
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.utils.device import select_gpu
from tpu_audio_torch.utils.log import Log
from tpu_audio_torch.utils.profiling import Spans


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_audio_torch",
        description="GPU convolution reverb (PyTorch + CUDA)")
    p.add_argument("--settings", default="settings.txt",
                   help="reference-format settings file")
    p.add_argument("--root", default=None,
                   help="base dir for relative IR index paths")
    p.add_argument("--input", default=None,
                   help="input WAV (default: --signal test signal)")
    p.add_argument("--output", default=None,
                   help="output WAV (default: discard)")
    p.add_argument("--signal", default="impulse",
                   choices=["impulse", "noise", "silence"],
                   help="test signal when --input is absent")
    p.add_argument("--midi", default=None,
                   help="scripted MIDI schedule file (block hexbytes per line)")
    p.add_argument("--engine", default="fmajor",
                   choices=["fmajor", "cascade", "partitioned", "monolithic"],
                   help="'fmajor' (uniform partitions, the MAC kernels), "
                        "'cascade' (two stages, the voice-scaling engine), "
                        "'partitioned' (complex partition spectra, "
                        "--variant) or 'monolithic' (the reference's one "
                        "fftSize-point FFT per block)")
    p.add_argument("--mac-dtype", default="f32", choices=["f32", "bf16"],
                   help="fmajor and cascade: store the delay lines and MAC "
                        "tensors in bf16 (half the bytes the MAC kernels "
                        "read; exact products summed in f32, ~-48 dB "
                        "wet-path floor)")
    p.add_argument("--variant", default="coef",
                   choices=["coef", "materialized"],
                   help="partitioned engine only: fades as two scalar "
                        "coefficients over a frozen snapshot ('coef') or "
                        "by slewing the full spectra ('materialized')")
    p.add_argument("--midi-fifo", action="append", default=None,
                   metavar="[DEVICE=]PATH",
                   help="FIFO/device path to read live MIDI bytes from; "
                        "repeatable, with an optional device id matched "
                        "against conv[i].cc.device mappings (the reference "
                        "runs one reader per ALSA device, src/main.cu:47-48)")
    p.add_argument("--input-ring", default=None, metavar="NAME",
                   help="read input blocks from this shared-memory ring "
                        "(created here; another process writes into it — "
                        "the live path, reference src/jackclient.cu:24-44)")
    p.add_argument("--output-ring", default=None, metavar="NAME",
                   help="write output blocks to this shared-memory ring "
                        "(created here; another process consumes it)")
    p.add_argument("--ring-blocks", type=int, default=64,
                   help="shm ring capacity in blocks")
    p.add_argument("--output-latency", type=int, default=4, metavar="BLOCKS",
                   help="silent blocks queued in --output-ring ahead of the "
                        "first output block: the consumer then plays a "
                        "block that is up to this many periods late on "
                        "time")
    p.add_argument("--underrun", default=None, choices=["stop", "silence"],
                   help="source-dry policy (default: silence when "
                        "--input-ring is used, else stop)")
    p.add_argument("--max-dry-blocks", type=int, default=None,
                   help="end an unbounded live session after this many "
                        "consecutive silence-substituted blocks")
    p.add_argument("--until-enter", action="store_true",
                   help="run until Enter/EOF on stdin (the reference parks "
                        "its main thread the same way, src/main.cu:95)")
    p.add_argument("--predelay-side", default="write",
                   choices=["write", "read"],
                   help="cascade only: apply block-predelay at ring WRITE "
                        "(reference residual semantics) or at ring READ "
                        "(a FIFO head ring; predelay edits re-time the "
                        "buffered wet, so both give the same output)")
    p.add_argument("--cascade-ratio", type=int, default=16,
                   help="cascade engine tail stagger ratio (tail partition "
                        "size = ratio*block; auto-shrunk to fit the voice "
                        "count and IR length)")
    p.add_argument("--no-swap-snapshot", action="store_true",
                   help="span-only fades (fmajor 'allk'): drop the "
                        "materialized fade snapshot, the largest state "
                        "tensor (~11 MB/voice at 4 s IRs); bank hot-swaps "
                        "then wait for in-flight crossfades to decay")
    p.add_argument("--bank-capacity", type=int, default=None,
                   help="working-set IR residency: keep only N IR slots on "
                        "the device (the all-K MAC) and page IRs from the "
                        "full bank in on demand — large banks at "
                        "small-bank speed when few IRs sound at once")
    p.add_argument("--bank-prep", default=None,
                   choices=["host", "device"],
                   help="where the fmajor and cascade IR spectra and MAC "
                        "packs are computed: 'device' (their default) "
                        "uploads time-domain PCM and transforms and packs "
                        "it on the card (the reference's prepare() "
                        "architecture, src/conv.cu:207-253); 'host' runs "
                        "the numpy prep and uploads the packed bank. The "
                        "other engines always prepare on the host")
    p.add_argument("--fault-upload", default=None,
                   choices=["dual", "derived", "td"],
                   help="working-set fault payload (fmajor, ring and roll "
                        "modes): 'td' uploads the time-domain IR and "
                        "transforms and packs it on the device; "
                        "'derived' uploads only its host spectra row, the "
                        "MAC columns rebuilt on the device; 'dual' (the "
                        "JAX package's upload of both layouts) takes the "
                        "derived route, the same bits (default: td with "
                        "--bank-prep device, derived with host, dual for "
                        "the cascade)")
    p.add_argument("--ws-exhausted", default="defer",
                   choices=["defer", "raise"],
                   help="working-set policy when every resident slot is "
                        "fade-protected: 'defer' parks the select and "
                        "applies it once a slot frees (serving never "
                        "crashes on hot MIDI); 'raise' keeps the strict "
                        "capacity-sizing contract")
    p.add_argument("--async-paging", action="store_true",
                   help="working-set residency only: pack bank misses on "
                        "a background thread and CUDA stream; the select "
                        "(and its crossfade) applies on the first block the "
                        "IR is resident. The pager holds the GIL while it "
                        "packs, so on the port this misses more deadlines "
                        "than the default sync paging (PERF.md); prefer sync "
                        "paging")
    p.add_argument("--voices", type=int, default=None,
                   help="override voice count (default: conv.count/2)")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N blocks")
    p.add_argument("--block-size", type=int, default=256)
    p.add_argument("--sample-rate", type=int, default=None,
                   help="session rate (default: the input WAV's rate, "
                        "else 44100); IR banks resample to it on load")
    p.add_argument("--max-ir-seconds", type=float, default=None,
                   help="truncate bank IRs (memory control)")
    p.add_argument("--normalize-bank", default=None,
                   choices=["energy", "peak"],
                   help="equalise IR loudness across the bank before use")
    p.add_argument("--out-voice", default=None,
                   help="which voice to write: index or 'all' (default 0)")
    p.add_argument("--realtime", action="store_true",
                   help="pace blocks at the audio rate")
    p.add_argument("--clock", default="sleep", choices=["sleep", "native"],
                   help="realtime pacing source (native = drift-free C++ "
                        "absolute-deadline clock)")
    p.add_argument("--pipeline-depth", type=int, default=1,
                   help="blocks (chunks, batches) in flight between step "
                        "and sink")
    p.add_argument("--chunk-blocks", type=int, default=1,
                   help="blocks per dispatch: one upload, one chunk step and "
                        "one fetch per N blocks (MIDI applies at chunk "
                        "granularity; not for the monolithic engine or "
                        "--variant materialized)")
    p.add_argument("--fetch-batch", type=int, default=1,
                   help="outputs per device->host copy (keeps per-block "
                        "dispatch and control; N blocks more delivery "
                        "latency; --pipeline-depth then counts batches)")
    p.add_argument("--wire", default="f32", choices=["f32", "pcm16"],
                   help="device->host output format with --fetch-batch > 1 "
                        "(pcm16 halves the bytes; the engine stays f32)")
    p.add_argument("--cache-dir", default=None,
                   help="IR spectra disk cache directory (the partitioned "
                        "engine's, and the fmajor and cascade packed banks "
                        "with --bank-prep host; shared with the JAX "
                        "package)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="record the session's spans, print their table "
                        "and the session's counters, and write a "
                        "torch.profiler trace of the session to "
                        "DIR/<pid>.pt.trace.json (summarise it with "
                        "python -m tpu_audio_torch.app.tools profile DIR)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (best CUDA device; fails without one), "
                        "'cuda:N', or 'cpu' for the plain PyTorch path")
    p.add_argument("--offline", nargs="?", const="auto", default=None,
                   metavar="SEGMENTS",
                   help="time-parallel offline bounce: render the input "
                        "far faster than real time, write --output, exit "
                        "(runtime/offline.py). Optional segment count, "
                        "default auto. A scripted --midi schedule bounces "
                        "too (matching the live session to float "
                        "precision); only live rings, FIFOs and "
                        "--realtime need the streaming session")
    p.add_argument("--offline-chunk-blocks", type=int, default=None,
                   metavar="N",
                   help="bound device memory on long --offline bounces: "
                        "render N blocks at a time, each chunk re-primed "
                        "from its trailing input history (exact; composes "
                        "with a --midi schedule)")
    p.add_argument("--offline-wire", default="pcm16",
                   choices=["f32", "pcm16"],
                   help="--offline readback format (default pcm16: the CLI "
                        "writes 16-bit WAVs anyway; f32 keeps full "
                        "precision)")
    p.add_argument("--offline-input-wire", default="auto",
                   choices=["auto", "f32", "pcm16"],
                   help="--offline upload format for the program material: "
                        "'auto' (default) uploads as int16 bit-exactly when "
                        "the input sits on a 16-bit grid (every 16-bit WAV "
                        "does) and falls back to f32; 'pcm16' quantizes any "
                        "input to half an LSB")
    p.add_argument("--offline-bucket", nargs="?", const="auto",
                   default=None, metavar="BLOCKS",
                   help="round --offline track lengths up to a bucket grid "
                        "(default 'auto' ~= 3%% padding); the zero pad is "
                        "trimmed from the output")
    p.add_argument("--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.quiet:
        Log.level = 2

    device = (select_gpu(verbose=not args.quiet) if args.device == "cuda"
              else args.device)

    if not os.path.exists(args.settings):
        Log.error("app", "settings file not found: %s", args.settings)
        return 2

    # the session rate drives IR-bank resampling AND the real-time
    # deadline: an input WAV's rate is authoritative unless overridden
    if args.sample_rate is None:
        if args.input:
            from tpu_audio_torch.io.wav import wav_sample_rate
            args.sample_rate = wav_sample_rate(args.input)
            Log.info("app", "session rate %d Hz (from %s)",
                     args.sample_rate, args.input)
        else:
            args.sample_rate = 44100

    # pairs with different fftSize / maxPredelay / banks (the reference
    # builds independent instances, src/main.cu:31-39): one batched engine
    # per distinct geometry, outputs summed like the JACK playback wiring
    from tpu_audio_torch.io.settings import Settings
    parsed = Settings().open(args.settings, verbose=False)
    if len(set(pair_geometry_keys(parsed, args.root))) > 1:
        return _run_groups(args, device)

    t0 = time.perf_counter()
    model = ConvolutionReverb.from_settings(
        args.settings, engine=args.engine, root=args.root,
        num_voices=args.voices,
        max_ir_seconds=args.max_ir_seconds,
        normalize_bank=args.normalize_bank, variant=args.variant,
        block=args.block_size, sample_rate=args.sample_rate,
        swap_snapshot=not args.no_swap_snapshot, verbose=not args.quiet,
        bank_capacity=args.bank_capacity, ws_exhausted=args.ws_exhausted,
        async_paging=args.async_paging, cascade_ratio=args.cascade_ratio,
        predelay_side=args.predelay_side, mac_dtype=args.mac_dtype,
        cache_dir=args.cache_dir, bank_prep=args.bank_prep,
        fault_upload=args.fault_upload, device=device)
    Log.info("app", "model built in %.3f s", time.perf_counter() - t0)
    rings = []
    try:
        if args.offline is not None:
            return _offline(args, [model], mix=False)
        if args.input_ring or args.output_ring:
            from tpu_audio_torch.runtime.native import native_available
            if not native_available():
                Log.error("app", "shm rings need the native runtime (g++)")
                return 2
        return _stream(args, model, rings)
    finally:
        # unlink shm rings even if setup or streaming fails partway — a
        # crashed server must not strand /dev/shm segments
        for ring in rings:
            ring.close(unlink=True)
        if model.working_set is not None:
            model.working_set.close()


def _offline_input(args):
    """Program material for an offline bounce: the input WAV, or the
    synthetic --signal (the streaming sources' semantics)."""
    import numpy as np

    b = args.block_size
    if args.input:
        from tpu_audio_torch.io.wav import read_wav
        wav = read_wav(args.input, verbose=not args.quiet)
        return wav.stereo().T.astype(np.float32), wav.sample_rate
    n = args.blocks or 400
    if args.signal == "noise":
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((2, n * b)) * 0.1).astype(np.float32)
    else:
        x = np.zeros((2, n * b), np.float32)
        if args.signal == "impulse":
            x[:, 0] = 1.0
    return x, args.sample_rate


def _offline(args, models, mix: bool) -> int:
    """Render every model offline over the same input and report
    throughput. mix=True writes the sum of every voice of every model (the
    engine groups' path, the reference's JACK playback mix); otherwise
    --out-voice (an index or 'all') picks what is written, like the
    streaming WavSink."""
    import time

    if args.input_ring or args.output_ring or args.midi_fifo or args.realtime:
        Log.error("app", "--offline bounces cannot take LIVE input "
                  "(rings/FIFOs/realtime need the streaming session; a "
                  "scripted --midi schedule bounces fine)")
        return 2
    x, sample_rate = _offline_input(args)
    segments = None if args.offline == "auto" else int(args.offline)
    schedule = None
    if args.midi:
        with open(args.midi) as fh:
            schedule = MidiSchedule.parse(fh.read())
    bucket = args.offline_bucket
    if bucket not in (None, "auto"):
        bucket = int(bucket)

    t0 = time.monotonic()
    try:
        # (each replay rewinds the schedule's cursor)
        outs = [model.render_offline(
            x, segments=segments, schedule=schedule,
            track_chunk_blocks=args.offline_chunk_blocks,
            wire=args.offline_wire, bucket_blocks=bucket,
            input_wire=args.offline_input_wire)              # [V, 2, T']
            for model in models]
    except ValueError as exc:  # e.g. working-set models
        Log.error("app", "--offline: %s", exc)
        return 2
    wall = time.monotonic() - t0
    n = min(o.shape[-1] for o in outs)
    audio_s = n / sample_rate
    print(f"offline bounce: {audio_s:.1f} s of audio in {wall:.1f} s wall "
          f"({audio_s / wall:.1f}x real time)")

    if args.output:
        from tpu_audio_torch.io.wav import write_wav
        out, voice = outs[0], args.out_voice
        if mix:
            total = sum(o[..., :n].sum(axis=0) for o in outs)
            write_wav(args.output, total.T, sample_rate)
        elif voice == "all":
            root, ext = os.path.splitext(args.output)
            for v in range(out.shape[0]):
                write_wav(f"{root}_v{v:03d}{ext or '.wav'}", out[v].T,
                          sample_rate)
        else:
            write_wav(args.output, out[int(voice or 0)].T, sample_rate)
        Log.info("app", "wrote %s", args.output)
    return 0


def _run_groups(args, device) -> int:
    """A settings file whose conv pairs differ: the pairs grouped by engine
    geometry (reference src/main.cu:31-39), every pair fed the same stereo
    input, the outputs summed (the JACK playback mix, main.cu:86-89),
    streamed or --offline. Live rings and FIFOs serve one engine group per
    process: split the settings file and run one app per geometry, the
    topology of the reference's independent Convolution instances."""
    from tpu_audio_torch.models.reverb import ReverbGroups

    if args.input_ring or args.output_ring or args.midi_fifo:
        Log.error("app", "heterogeneous conv pairs run the offline groups "
                  "path; for live rings start one app process per "
                  "geometry (split the settings file)")
        return 2
    groups = ReverbGroups.from_settings(
        args.settings, engine=args.engine, root=args.root,
        max_ir_seconds=args.max_ir_seconds, verbose=not args.quiet,
        variant=args.variant, block=args.block_size,
        sample_rate=args.sample_rate, mac_dtype=args.mac_dtype,
        cache_dir=args.cache_dir, bank_prep=args.bank_prep, device=device)
    if args.offline is not None:
        # every group bounced over the same input and summed, as
        # ReverbGroups.process sums them
        return _offline(args, groups.models, mix=True)

    x, sample_rate = _offline_input(args)
    midi = None
    if args.midi:
        with open(args.midi) as fh:
            midi = MidiSchedule.parse(fh.read())
    total, summaries = groups.process(x, midi=midi, max_blocks=args.blocks)
    for pairs, s in zip(groups.pair_ids, summaries):
        print(f"group pairs {pairs}: {s['blocks_streamed']} blocks | "
              f"avg {s.get('avg_ms', 0):.3f} ms | "
              f"p99 {s.get('p99_ms', 0):.3f} | rtf {s.get('rtf', 0):.2f}")
    if args.output:
        from tpu_audio_torch.io.wav import write_wav
        write_wav(args.output, total.T, sample_rate)
        Log.info("app", "wrote %s", args.output)
    return 0


def _profiled_run(directory: str, session, state, **run_kwargs) -> None:
    """session.run under torch.profiler (the CPU's ops, and the device's
    kernels and copies on a CUDA model), its Chrome trace written to
    `directory`/<pid>.pt.trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if session.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        session.run(state, **run_kwargs)
        if session.device.type == "cuda":
            torch.cuda.synchronize(session.device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{os.getpid()}.pt.trace.json")
    prof.export_chrome_trace(path)
    Log.info("app", "profiler trace written to %s", path)


def _print_spans(spans: Spans, counters: dict) -> None:
    """The session's span table (per span: count, mean and 99th-percentile
    duration, mean self time) and its counters."""
    print(f"spans: {'name':<14} {'count':>7} {'mean_ms':>9} {'p99_ms':>9} "
          f"{'self_ms':>9}" + (f"  ({spans.dropped} dropped past "
                               f"{spans.capacity})" if spans.dropped else ""))
    for name, row in spans.table().items():
        print(f"spans: {name:<14} {row['count']:>7d} {row['mean_ms']:>9.3f} "
              f"{row['p99_ms']:>9.3f} {row['self_ms']:>9.3f}")
    print("counters: " + " | ".join(f"{k} {v}" for k, v in counters.items()))


def _stream(args, model, rings: list) -> int:
    """Stream through the session; shm rings opened here are appended to
    `rings` (the caller unlinks them)."""
    v, b = model.engine.num_voices, model.block
    if args.input_ring or args.output_ring:
        # the process's first step loads the kernels and plans the FFTs;
        # take it before the rings exist, so that the first block a
        # producer writes is rendered in time and no backlog of captured
        # blocks builds up behind it
        warm = model.session(SilenceSource(v, b, 1), NullSink(),
                             chunk_blocks=args.chunk_blocks)
        Log.info("app", "warmed up in %.3f s",
                 warm.warm_up(model.init_state()))
    if args.input_ring:
        from tpu_audio_torch.runtime.native import NativeRing, RingSource
        ring_in = NativeRing(args.ring_blocks * v * 2 * b,
                             shm_name=args.input_ring)
        rings.append(ring_in)
        source = RingSource(ring_in, v, b, blocking=True)
        sample_rate = args.sample_rate
        Log.info("app", "input ring /dev/shm/%s (%d blocks)",
                 args.input_ring, args.ring_blocks)
    elif args.input:
        source = WavSource(args.input, v, b, max_blocks=args.blocks)
        sample_rate = source.sample_rate or args.sample_rate
        if source.sample_rate and source.sample_rate != args.sample_rate:
            Log.warn("app", "input is %d Hz but the session runs %d Hz: "
                     "program audio will play detuned (drop --sample-rate "
                     "to adopt the input's rate)",
                     source.sample_rate, args.sample_rate)
    else:
        n = args.blocks or 400
        source = {"impulse": ImpulseSource(v, b, n),
                  "noise": NoiseSource(v, b, n),
                  "silence": SilenceSource(v, b, n)}[args.signal]
        sample_rate = args.sample_rate

    if args.output_ring:
        from tpu_audio_torch.runtime.native import NativeRing, RingSink
        ring_out = NativeRing(args.ring_blocks * v * 2 * b,
                              shm_name=args.output_ring)
        rings.append(ring_out)
        sink = RingSink(ring_out, latency_blocks=args.output_latency)
        Log.info("app", "output ring /dev/shm/%s (%d blocks)",
                 args.output_ring, args.ring_blocks)
    elif args.output:
        voice = args.out_voice
        if voice is not None and voice != "all":
            voice = int(voice)
        sink = WavSink(args.output, sample_rate, voice=voice)
    else:
        sink = NullSink()

    underrun = args.underrun or ("silence" if args.input_ring else "stop")
    midi = None
    if args.midi:
        with open(args.midi) as fh:
            midi = MidiSchedule.parse(fh.read())
    live_midi = None
    try:
        if args.midi_fifo:
            from tpu_audio_torch.runtime.midi_transport import (
                MidiByteStream, MultiMidiStream,
            )
            streams = []
            for spec in args.midi_fifo:
                device, _, path = spec.rpartition("=")
                streams.append(MidiByteStream(path, device=device))
            live_midi = (streams[0] if len(streams) == 1
                         else MultiMidiStream(streams))

        spans = Spans() if args.profile else None
        session = model.session(source, sink, realtime=args.realtime,
                                pipeline_depth=args.pipeline_depth,
                                chunk_blocks=args.chunk_blocks,
                                fetch_batch=args.fetch_batch, wire=args.wire,
                                underrun_policy=underrun,
                                max_consecutive_underruns=args.max_dry_blocks,
                                clock=args.clock, spans=spans)
        if args.until_enter:
            import sys
            import threading

            def _watch_stdin():
                try:
                    sys.stdin.readline()
                except Exception:
                    pass
                Log.info("app", "stdin: stopping session")
                session.stop()

            threading.Thread(target=_watch_stdin, daemon=True).start()
        state = model.init_state()
        if args.profile:
            _profiled_run(args.profile, session, state, max_blocks=args.blocks,
                          midi=midi, live_midi=live_midi)
        else:
            session.run(state, max_blocks=args.blocks, midi=midi,
                        live_midi=live_midi)
    finally:
        if live_midi is not None:
            live_midi.close()

    # reference exit report (src/main.cu:106) + the latency stats it lacked
    s = session.summary()
    if s.get("blocks", 0) == 0:
        print(f"streamed {s['blocks_streamed']} blocks "
              f"(all within the warmup discard window; no timing recorded) "
              f"| underruns {s['underruns']}")
    else:
        print(f"streamed {s['blocks_streamed']} blocks | avg {s['avg_ms']:.3f} ms "
              f"| p50 {s['p50_ms']:.3f} | p99 {s['p99_ms']:.3f} "
              f"| rtf {s.get('rtf', 0):.2f} | missed {s['missed_deadlines']} "
              f"| underruns {s['underruns']}"
              + (f" | dropped {sink.dropped}" if hasattr(sink, "dropped")
                 else ""))
        # deadline-margin hint: batched fetches on the 16-bit wire make
        # one copy per N blocks of half the bytes, which helps only where
        # the device-to-host copy is the limit; on an H100 they moved no
        # pace at 64 or 2048 voices, and the host's int16 decode put the
        # 2048-voice pcm16 wire behind (PERF.md section 6)
        if (args.wire == "f32"
                and s["p99_ms"] > 0.9 * session.block_period * 1e3):
            Log.warn("app", "f32 wire p99 (%.2f ms) is within 10%% of the "
                     "%.2f ms deadline; --fetch-batch 16 --wire pcm16 "
                     "helps only if the device-to-host copy is the limit "
                     "(on an H100 it is not: PERF.md section 6)",
                     s["p99_ms"], session.block_period * 1e3)
    if spans is not None:
        _print_spans(spans, s["counters"])
    ws = model.working_set
    if ws is not None:
        print(f"working set: {ws.capacity} slots | misses {ws.misses} "
              f"| hits {ws.hits} | deferred {ws.deferred} "
              f"| starved {ws.starved}")
    if args.output:
        Log.info("app", "wrote %s", args.output)
    return 0 if s["blocks_streamed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
