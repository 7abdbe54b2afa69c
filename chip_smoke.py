#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_audio_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: select the GPU, print its name and power limit, check that
     TF32 is off;
  2. build: compile the ring_mac CUDA kernel from tpu_audio_torch/csrc;
  3. kernel vs plain: the kernel against its plain PyTorch version in
     float64 at the 64-voice main-path shapes (every ring phase) and at an
     odd small shape, within 1e-5 of the output's scale;
  4. the slice at full width: 64 stereo voices, 4 synthetic 4 s IRs,
     256-frame blocks at 44.1 kHz, streamed through StreamSession for 800
     blocks with a re-select and an interrupting re-select; every block
     must ride the kernel, the fades the indexed step, every output must be
     finite, and voices 0 and 63 must match a float64 fftconvolve golden
     before the re-selects and after the fades decay;
  5. timing on the card (CUDA events): per-step steady and indexed, the
     kernel alone against the plain MAC, and the session's wall time.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}. The script imports nothing of JAX
and nothing of the JAX package.
"""

import json
import subprocess
import sys
import time

import numpy as np

VOICES, BLOCK, RATE = 64, 256, 44100
NUM_IRS, IR_SECONDS = 4, 4.0
BLOCKS = 800
SELECT_AT, INTERRUPT_AT = 300, 306
SELECT_CC = 21
DEADLINE_MS = BLOCK / RATE * 1e3


def synthetic_bank(num_irs, ir_seconds, sample_rate):
    """Exponential-decay noise IRs from numpy seed 0 (the synthetic bank
    benchlib/measure.py:make_bank falls back to)."""
    ir_len = int(ir_seconds * sample_rate)
    rng = np.random.default_rng(0)
    irs = []
    for _ in range(num_irs):
        t = np.arange(ir_len, dtype=np.float32)
        env = np.exp(-t / (0.4 * ir_len)).astype(np.float32)
        irs.append(rng.standard_normal((2, ir_len)).astype(np.float32)
                   * env * 0.3)
    return irs


def golden(x, ir_pair, wet, dry, predelay):
    """float64 offline composition for one voice at constant parameters,
    centre pans and unit level: input channel i convolves its IR pair
    ir_pair[i] [O, L]; the wet sum is delayed by channel 0's predelay,
    clamped, and the dry mix added after."""
    from scipy.signal import fftconvolve

    t = x.shape[-1]
    out = np.zeros((2, t))
    for o in range(2):
        acc = np.zeros(t)
        for i in range(2):
            conv = fftconvolve(x[i].astype(np.float64),
                               ir_pair[i][o].astype(np.float64))[:t]
            acc[predelay:] += conv[: t - predelay] * wet
        out[o] = np.clip(acc, -1.0, 1.0) + (x[0] + x[1]) * dry
    return out


def cuda_ms(fn, reps, warmup=20):
    """Mean device milliseconds per call over `reps` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.ops import ring_mac as rm
    from tpu_audio_torch.ops.partition import num_partitions
    from tpu_audio_torch.runtime.backends import BlockSink, NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule
    from tpu_audio_torch.utils.device import select_gpu
    from tpu_audio_torch.utils.log import Log

    Log.level = 2  # warnings and errors only: one select logs per voice

    # -- 1. device ----------------------------------------------------------------
    dev = select_gpu(verbose=False)
    kind = torch.cuda.get_device_name(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()
    card = smi[dev.index] if dev.index < len(smi) else smi[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    print(card)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise RuntimeError("TF32 is on after device selection")

    # -- 2. build -----------------------------------------------------------------
    path, build_s, ptxas = rm.build()
    print(f"build: {path.name} compiled in {build_s:.2f} s"
          if build_s else f"build: {path.name} already built")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  {line.strip()}")

    # -- 3. kernel vs plain ---------------------------------------------------------
    engine_pp = -(-num_partitions(int(IR_SECONDS * RATE), BLOCK) // 8) * 8
    f_full, vi_full, kod_full = BLOCK + 1, 2 * VOICES, 4 * NUM_IRS
    rng = np.random.default_rng(0)
    max_abs_err = 0.0
    tensors = {}
    for name, (f, vi, pp, kod) in (("64-voice", (f_full, vi_full, engine_pp,
                                                 kod_full)),
                                   ("odd-small", (7, 4, 16, 8))):
        fdl = torch.tensor(rng.standard_normal((f, vi, 2, pp),
                                               dtype=np.float32), device=dev)
        rhs2 = torch.tensor(rng.standard_normal((f, 2, 2 * pp, kod),
                                                dtype=np.float32), device=dev)
        tensors[name] = (fdl, rhs2)
        for w in sorted({0, 1, 347 % pp, pp - 1}):
            wt = torch.tensor(w, dtype=torch.int32, device=dev)
            got = rm.ring_mac(wt, fdl, rhs2)
            torch.cuda.synchronize()
            ref64 = rm.ring_mac_reference(w, fdl.double(), rhs2.double())
            ref32 = rm.ring_mac_reference(wt, fdl, rhs2)
            scale = ref64.abs().max().item()
            err = (got.double() - ref64).abs().max().item()
            err32 = (ref32.double() - ref64).abs().max().item()
            print(f"kernel vs plain [{name} F={f} VI={vi} Pp={pp} KOD={kod} "
                  f"w={w}]: max_abs_err {err:.3e} (plain f32 {err32:.3e}, "
                  f"limit {1e-5 * scale:.3e})")
            if not err <= 1e-5 * scale:
                raise AssertionError(f"ring_mac kernel disagrees with the "
                                     f"plain version at {name} w={w}")
            if name == "64-voice":
                max_abs_err = max(max_abs_err, err)

    # -- 4. the slice at full width -------------------------------------------------
    irs = synthetic_bank(NUM_IRS, IR_SECONDS, RATE)
    bank = IRBank(sample_rate=RATE)
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="fmajor",
                              max_predelay=8192, device=dev)
    if model.engine.pp != engine_pp:
        raise AssertionError(f"engine Pp {model.engine.pp} != {engine_pp}")
    cp = model.control
    cp.wet[:] = 0.7
    cp.dry[:] = 0.2
    cp.predelay[:] = 1024
    cp.speed[:] = 50
    for v in range(VOICES):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=SELECT_CC))
    midi = MidiSchedule([(SELECT_AT, "", bytes([0xB0, SELECT_CC, 32])),
                         (INTERRUPT_AT, "", bytes([0xB0, SELECT_CC, 64]))])

    class KeepSink(BlockSink):
        """Keeps voices 0 and 63; checks every block is finite."""

        def __init__(self):
            self.kept, self.finite, self.blocks = [], True, 0

        def write(self, block):
            self.finite &= bool(np.isfinite(block).all())
            self.kept.append(block[[0, VOICES - 1]].copy())
            self.blocks += 1

    sink = KeepSink()
    session = model.session(NoiseSource(VOICES, BLOCK, BLOCKS,
                                        amplitude=0.01, seed=0), sink)
    state = model.init_state()
    rm.ring_mac.launches = 0
    t0 = time.perf_counter()
    state = session.run(state, midi=midi)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = rm.ring_mac.launches
    steps = session.blocks_streamed
    print(f"slice: {steps} blocks in {run_s:.3f} s, ring_mac launches "
          f"{launches}, indexed blocks {session.indexed_blocks}, selects "
          f"{cp.select[0].tolist()}")
    if steps != BLOCKS or sink.blocks != BLOCKS:
        raise AssertionError(f"streamed {steps} blocks, delivered "
                             f"{sink.blocks}, wanted {BLOCKS}")
    if launches != steps:
        raise AssertionError(f"ring_mac launched {launches} times in "
                             f"{steps} steps")
    if session.indexed_blocks < 20:
        raise AssertionError(f"only {session.indexed_blocks} blocks rode "
                             f"step_coef_indexed")
    if not sink.finite:
        raise AssertionError("non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError("the crossfades did not decay by the end")

    out = np.concatenate(sink.kept, axis=-1)            # [2 voices, 2, T]
    noise = np.random.default_rng(0)                    # NoiseSource's stream
    x = np.concatenate(
        [(noise.standard_normal((VOICES, 2, BLOCK)) * 0.01).astype(np.float32)
         for _ in range(BLOCKS)], axis=-1)[[0, VOICES - 1]]
    windows = (("before the re-selects", 0, SELECT_AT, 0),
               ("after the fades decay", 500, BLOCKS, 2))
    golden_err = 0.0
    for i, v in enumerate((0, VOICES - 1)):
        for label, b0, b1, sel in windows:
            want = golden(x[i], [irs[sel], irs[sel]], wet=0.7, dry=0.2,
                          predelay=int(cp.predelay[v, 0]))
            err = np.abs(out[i, :, b0 * BLOCK: b1 * BLOCK]
                         - want[:, b0 * BLOCK: b1 * BLOCK]).max()
            golden_err = max(golden_err, float(err))
            print(f"golden voice {v} blocks {b0}-{b1 - 1} ({label}, IR "
                  f"{sel}): max_abs_err {err:.3e} (limit 1e-4)")
            if not err <= 1e-4:
                raise AssertionError(f"voice {v} disagrees with the golden "
                                     f"{label}")
    summary = session.summary()

    # -- 5. timing on the card --------------------------------------------------------
    engine, bank_t = model.engine, model.spectra
    params = cp.snapshot_device()
    xt = torch.tensor(x[:, :, :BLOCK].repeat(32, axis=0), device=dev)
    step_ms = {}
    for name in ("step_coef_steady", "step_coef_indexed"):
        step = getattr(engine, name)
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(520)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(520)]
        for s, e in zip(starts, ends):
            s.record()
            state, _ = step(state, bank_t, params, xt)
            e.record()
        torch.cuda.synchronize()
        times = np.array([s.elapsed_time(e) for s, e in zip(starts, ends)])[20:]
        step_ms[name] = (float(np.percentile(times, 50)),
                         float(np.percentile(times, 99)))
    fdl, rhs2 = tensors["64-voice"]
    wt = torch.tensor(5, dtype=torch.int32, device=dev)
    kernel_runs, plain_runs = [], []
    for _ in range(2):  # interleaved: plain, kernel, kernel, plain
        plain_runs.append(cuda_ms(lambda: rm.ring_mac_reference(wt, fdl, rhs2),
                                  200))
        kernel_runs.append(cuda_ms(lambda: rm.ring_mac(wt, fdl, rhs2), 200))
    kernel_ms = float(np.mean(kernel_runs))
    plain_ms = float(np.mean(plain_runs))
    mac_bytes = (fdl.numel() + rhs2.numel() // 2) * 4  # fdl + the window
    tag = f"[{card}]"
    lines = [
        ("steady_step_p50_ms", step_ms["step_coef_steady"][0]),
        ("steady_step_p99_ms", step_ms["step_coef_steady"][1]),
        ("indexed_step_p50_ms", step_ms["step_coef_indexed"][0]),
        ("indexed_step_p99_ms", step_ms["step_coef_indexed"][1]),
        ("ring_mac_kernel_us", kernel_ms * 1e3),
        ("ring_mac_kernel_GBps", mac_bytes / (kernel_ms * 1e-3) / 1e9),
        ("ring_mac_plain_us", plain_ms * 1e3),
        ("session_wall_avg_ms_per_block", summary["avg_ms"]),
        ("session_wall_p50_ms_per_block", summary["p50_ms"]),
        ("session_wall_p99_ms_per_block", summary["p99_ms"]),
        ("session_rtf", summary["rtf"]),
        ("session_missed_deadlines", summary["missed_deadlines"]),
        ("deadline_ms", DEADLINE_MS),
        ("golden_max_abs_err", golden_err),
    ]
    for key, value in lines:
        print(f"{key} {value} {tag}")

    print(json.dumps({"kernels": [{
        "name": "ring_mac", "route": "cuda",
        "source": "tpu_audio_torch/csrc/ring_mac.cu",
        "replaces": "tpu_audio/ops/pallas_mac.py:160",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
