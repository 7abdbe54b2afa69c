#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (tpu_audio_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. device: select the GPU, print its name and power limit, check that
     TF32 is off;
  2. build: compile both CUDA kernels from tpu_audio_torch/csrc, one nvcc
     per source, started together;
  3. ring_mac vs plain: the kernel against its plain PyTorch version in
     float64 at the 64-voice shapes of KOD 16, 36 and 64 (4, 9 and 16 IRs)
     and at an odd small shape, at every ring phase, within 1e-5 of the
     output's scale (the library yardstick of phase 5 too);
  4. ring mode at full width: 64 stereo voices, 4 synthetic 4 s IRs,
     256-frame blocks at 44.1 kHz, streamed through StreamSession for 800
     blocks with a re-select and an interrupting re-select; every block
     must ride ring_mac (and none mac_shift), the fades the indexed step,
     every output must be finite, and voices 0 and 63 must match a float64
     fftconvolve golden before the re-selects and after the fades decay;
  5. ring-mode timing on the card (CUDA events): per-step steady, indexed
     and general, the session's wall time; ring_mac against its plain
     version and against one library call (an einsum over the sliced
     window) at the 64-voice shapes of KOD 16, 36 and 64, interleaved, with
     GB/s and the share of the roofline bound;
  6. mac_shift vs plain: at the 64-voice shapes of KOD 16, 36 and 64 and at
     an odd small shape the shifted line must be bit-identical to the plain
     version's and m within 1e-5 of the float64 plain version's scale;
  7. roll mode at full width (ring=False, swap_snapshot=True): the same 64
     voices and IRs through StreamSession for 800 blocks with a re-select
     (collapse_pure, the indexed step), a live swap_bank mid-fade to the
     same IRs reordered and scaled by 0.5 (materialize_base, the general
     step) and an interrupting re-select during that fade (the
     materializing collapse); every block must ride mac_shift and none
     ring_mac, the indexed and general blocks are counted against floors,
     and voices 0 and 63 must match the golden before the re-select and
     after the fades decay against the new bank;
  8. 'selected' at full width: 64 voices, ring mode, a 24-IR synthetic 4 s
     bank that mac_strategy='auto' resolves to 'selected', through
     ConvolutionReverb's session for 600 blocks with a re-select and an
     interrupt (the materializing collapse, the general step), against
     the same golden;
  9. roll and 'selected' timing: per-step steady, indexed and general
     (CUDA events), mac_shift alone against its plain version and one
     torch.einsum of the unshifted line at KOD 16, 36 and 64, interleaved;
 10. roll mode at the all-K ceiling: 64 voices, 16 synthetic 4 s IRs,
     mac_strategy='auto' (which must resolve to 'allk': KOD=64), through
     StreamSession for 400 blocks with a re-select and an interrupting
     re-select; every block must ride mac_shift and none ring_mac, and
     voices 0 and 63 must match the golden before the re-select and after
     the fades decay; then its steady step is timed;
 11. ring mode at the all-K ceiling: ConvolutionReverb with its defaults
     (ring mode, mac_strategy='auto' -> 'allk', KOD=64) over the same 16
     IRs, 400 blocks through its session with a re-select and an
     interrupting re-select; every block must ride ring_mac and none
     mac_shift, with phase 10's checks against the golden; then its steady
     step is timed;
 12. a working set at the reference bank's size: 152 synthetic 4 s IRs
     served through 16 resident slots (ConvolutionReverb with
     bank_capacity=16, its bank prepared on the card: ring mode, 'allk',
     KOD=64),
     800 blocks in which new IRs of the full bank are selected every 32
     blocks (13 sync faults), then a re-select of a resident IR (a hit)
     and quiet blocks; every block must ride ring_mac and none mac_shift,
     the output must be finite, voices 0 and 63 must match the golden
     before the churn and after the last fade to 3e-6 (and read above that
     against the golden of the IR played before the hit, the control),
     and the resident bank must equal a fresh device prep of the IRs its
     slots name. The same
     timeline runs again with async_paging=True (the pager packs each
     fault on its own CUDA stream), where every deferred select must
     apply. Prints the model's build time, one fault's time at first use
     (the session's warm-up) and warm, and both sessions' figures;
 13. ring_mac at the cascade's shapes (KOD 16): the head [257, VI, 2, 32]
     and one group's tail [4097, VI/16, 2, 48] at 64 and 1024 voices,
     against the float64 plain version at four ring phases within 1e-5 of
     scale, then timed against plain and one einsum, interleaved; the
     bf16 form the same way at the 64-voice tail (VI = 8), against plain
     and torch.bmm;
 14. the cascade at full width: ConvolutionReverb(engine='cascade'), 64
     voices, the 4 IRs, ratio 16, through its session for 800 blocks with
     phase 4's re-select and interrupt, a swap_bank requested mid-fade
     (to phase 7's new bank; it must wait for the fades to decay, then
     apply) and a predelay edit at 720. Every block must launch ring_mac
     twice (head and tail) and mac_shift never, the fades ride the
     indexed step, voices 0 and 63 must match the golden before the
     re-select and, against the new bank, after the swap. The same
     timeline then runs with predelay_side='read', which must equal the
     write side within 2e-5 of scale on every block and voice; both
     sides' steps are timed, with their device busy time per step and the
     device operations that take most of it;
 15. the cascade at 1024 voices (4 s IRs, f32, ratio 16) through the
     model's session for 300 blocks with a re-select at 100, two ring_mac
     launches per block, voices 0 and 1023 against the golden before the
     re-select and after the fade, the host ms of each part of its
     session block; its steps and the fmajor ring/allk steady step at 1024
     voices (swap_snapshot=False) are timed;
 16. the offline bounce at full width: ConvolutionReverb's defaults (ring,
     'allk') at 64 voices render 30 s of per-voice noise with the tail,
     auto segments resolving to 8 (512 virtual voices), twice; every step
     must launch ring_mac (warm-up + segment length) and none mac_shift,
     the output must be finite, voices 0 and 63 must match the golden at
     every segment boundary and over the tail; prints each take's prime,
     step-loop and collection times, ms per step (CUDA events), x real
     time and voice-seconds per second, then the steady step at 512
     virtual voices (device busy, top ops) and at 64, and ring_mac at the
     bounce's shape (VI = 1024) against plain, einsum and bound;
 17. an automated bounce: phase 4's re-select and interrupt and a wet
     change at 320 as a MidiSchedule over 800 blocks, whole and in chunks
     of 256 blocks, each equal to the model's session streaming the same
     timeline on the card within 2e-5 of scale on every block and voice;
 18. the other engines' bounces, 10 s at 64 voices: the cascade (ratio 16,
     auto segments, two ring_mac launches per step) and a roll-mode engine
     (4 segments, every step on mac_shift), both against the golden, with
     each kernel first held against its plain version at the shapes these
     bounces give it;
 19. checkpoint and recovery at full width: ConvolutionReverb's defaults at
     64 voices over phase 4's IRs stream 800 blocks of per-voice noise from
     a seekable in-memory source with phase 4's re-select and interrupt and
     a wet change at 350, once uninterrupted and once through run_resilient
     with a checkpoint every 160 blocks and a sink that fails when blocks
     400 and 700 are delivered: two rebuilds, resumed from 320 (mid-fade)
     and 640, the wet change replayed. The recovered output must equal the
     uninterrupted one within 1e-6 of scale (it prints whether it is
     bit-identical), voices 0 and 63 must match the golden, and every
     stepped block, replays included, must launch ring_mac. Prints the
     checkpoint's size, each save's device-to-host and file-write ms and
     its block's ms, each rebuild and load;
 20. the same for the cascade (ratio 16): 400 blocks, re-selects at 150
     and 230, a checkpoint every 100 blocks, one failure at block 250
     (resumed from 200, mid-cycle of the ratio), two ring_mac launches per
     stepped block;
 21. the live path in one process at full width: a producer thread writes
     1000 noise blocks into a shm NativeRing paced by a NativeBlockClock;
     the session reads them through RingSource (silence on underrun),
     realtime on the native clock, writes through RingSink to a ring a
     consumer thread drains, and takes a select and a wet CC from a FIFO
     through MidiByteStream. The consumer must get every block in order,
     voices 0 and 63 must match the golden of the input as read, every
     block must launch ring_mac, and the native framer and clock must be
     the ones in use. Prints p50 / p99 per block, RTF, missed deadlines,
     underruns, the clock's missed ticks and the latency from producer
     write to consumer read;
 22. the CLI behind the C JACK bridge: the stub jackd and the C bridge
     built into tpu_audio_torch/_build, `python -m tpu_audio_torch.app
     --voices 1` on shm rings, realtime on the native clock with a MIDI
     FIFO, for 1000 blocks of 256 frames (periods of 5805 us); the app
     must exit 0 with its summary, the bridge report its periods and
     underruns, and the playback be finite and sound without a gap;
 23. the monolithic engine (the reference's algorithm: one 131072-point
     cuFFT forward and one inverse per block): ConvolutionReverb(engine=
     'monolithic', fft_size=131072) at 64 voices over phase 4's IRs, 600
     blocks of noise at 0.001 with phase 4's re-select and interrupt;
     voices 0 and 63 against the golden of IR 0 cut to 130048 samples
     before the re-select, and through the fades against the exact
     input-synchronous golden (each input block with the IR mix it met),
     within 1e-4 of the output's scale; ms per block p50/p99, RTF, missed
     deadlines, the step's CUDA-event ms, device busy and peak memory; then
     96 blocks at phase 4's amplitude, where the overlap-add clamps, voices
     0 and 63 against the same engine on the CPU within 1e-4 of scale;
 24. the partitioned engine: the same IRs and timeline on phase 4's input
     for 600 blocks, variant 'coef' (steady and general steps), then
     'materialized'; each against the full-IR golden before the re-select
     and after the fades decay, coef against materialized on every block
     and voice within 2e-5 of scale, the same figures per step; then a
     static bounce of 10 s of per-voice noise with the coef engine at auto
     segments (warm-up history_blocks), the golden at every segment
     boundary;
 25. a settings file whose conv pairs differ (fftSize 131072 and 65536,
     two 2-IR banks written as WAVs) through `python -m tpu_audio_torch.app
     --engine monolithic`, streamed and then --offline: the streamed WAV
     against the sum of the two groups' goldens within 1 LSB, the bounced
     WAV against the streamed one within 1 LSB. Neither MAC kernel may
     launch in phases 23-25;
 26. the bf16 kernels (mac_dtype='bf16'): ring_mac and mac_shift on bf16
     operands against their plain versions (upcast, float64 sums) within
     1e-5 of scale at the 64-voice shapes of KOD 16, 36 and 64 (the
     shifted line bit-identical), and ring_mac at the 2048-voice cascade's
     head and tail shapes, and ring_mac's library yardstick (torch.bmm on
     the bf16 operands over the gathered window, f32 out) held to the same
     limit; each timed against its plain version, that yardstick, one
     torch.einsum on the bf16 operands (it rounds m to bf16) and its bound
     (bytes, or bf16 operations over the card's bf16 tensor-core peak);
 27. fmajor in bf16 at 64 voices over phase 4's IRs: the model's session
     on phase 4's timeline (every block on the bf16 ring_mac) above 40 dB
     SNR against phase 4's f32 session; a roll-mode session in bf16 and in
     f32, 600 blocks of the same timeline (every bf16 block on the bf16
     mac_shift), above 40 dB SNR; a static bounce of 10 s by the bf16
     model against the f32 model's, above 40 dB SNR; ms per block p50 /
     p99, RTF, missed deadlines, the steady step's time and device busy,
     peak memory; then the 'selected' steps (per-voice products on bf16
     operands, no f32 copy of them), fmajor ring and the cascade, steady
     and general, in f32 and in bf16;
 28. the JAX bench's cascade_2048: 2048 voices, bf16, ratio 16,
     read-side predelay, 4 s IRs, 300 blocks with a re-select at 100; two
     bf16 ring_mac launches per block, voices 0 and 2047's wet path above
     40 dB SNR against the float64 golden before the re-select and after
     the fade; the same figures plus the steps' top device ops; then the
     CLI (`--engine cascade --mac-dtype bf16 --voices 2048`) for 40
     blocks;
 29. the JAX bench's sel152: 152 synthetic 4 s IRs through the cascade's
     'selected' strategy in f32 (mac_strategy 'auto'), 64 voices, 600
     blocks, every voice re-selecting at 300 (a 150-block fade on the
     general step) and a swap_bank at 450, mid-fade; no MAC kernel
     launches; voices 0 and 63 against the golden within 2e-5 of scale
     before the re-select and after the swap; collapse,
     regather_selection and materialize_base timed at first use and warm;
     then the CLI over the bank written as 152 WAVs for 40 blocks;
 30. chunked serving (StreamSession(chunk_blocks=8)) at 64 voices over
     phase 4's IRs, 803 blocks (a partial last chunk), a re-select at 296
     and an interrupt at 304 on the chunk grid: ring 'allk' f32 (every
     block on ring_mac) against its per-block run within 2e-5 of scale and
     against the golden; roll 'allk' f32 (every block on mac_shift) and
     ring in bf16 (every block on the bf16 ring_mac), each against its
     per-block run; the 'allk' cascade in chunks of 16 over 400 blocks (two
     ring_mac launches per block) against per block; run_resilient in
     chunks with one sink failure, to the bit against the chunked run;
     host ms per block p50 / p99, RTF, missed and the steady step's device
     busy per block at chunk 1 and chunk 8; a monolithic session refuses
     chunks;
 31. the operational surface: `tools makeindex`, `bank-info` and
     `prebuild-cache` as subprocesses over phase 4's IRs written as WAVs;
     the CLI's `--engine partitioned --cache-dir` twice (a miss that
     computes and writes the spectra, then a hit that computes nothing;
     the output WAVs equal to the bit; both build times); the CLI's
     default fmajor route at 64 voices with `--chunk-blocks 8` (80 blocks)
     and under `--profile` (40 blocks), one ring_mac launch per block;
     `tools profile` must list ring_mac among the trace's kernel events;
     `tools inspect-checkpoint` on a checkpoint saved in the phase;
 32. the device mesh (tpu_audio_torch/parallel/mesh.py) over every card
     when the machine has two or more, else over virtual shards on one
     card (run_mesh's docstring lists the runs): ring 'allk' f32 over
     voice=2 (and 4 with four cards) with checkpoints every 97 blocks and
     a resume on the mesh and on one device, roll 'allk' f32 over voice=1
     x part=2 with a swap_bank mid-fade, roll bf16 over voice=2 x part=2,
     the bf16 cascade at 2560 voices over voice=2, the working set over
     voice=2 and the bounce over voice=2; each against the same run on
     one device, with one kernel launch per shard per block (two on the
     cascade), and host ms per block, RTF, missed deadlines and the
     sharded steady step's device busy per block; then each kernel at
     every shape those mesh runs gave it (recorded as they ran) against
     its plain version, timed beside its bound;
 33. roll mode at 96 voices (VI = 192 delay-line rows, no multiple of 128:
     mac_shift's small tiles): phase 4's IRs, ring=False, 'allk', 400
     blocks in f32 then 400 in bf16 through StreamSession with phase 7's
     controls (a re-select, a swap_bank mid-fade, an interrupt); every
     block must ride mac_shift (its bf16 form in bf16) and none ring_mac,
     voices 0, 40, 64 and 95 (every f32 row tile and both bf16 ones) of
     the f32 run must match the golden before the re-select and once the
     fades decay, the bf16 run must track the f32 one at >= 40 dB SNR;
     then each form at the session's shape against its plain version,
     timed beside its bound, and the steady step's device busy;
 34. the host link (run_host_link's docstring lists the runs): phase 4's
     ring session (400 blocks) per block and with fetch_batch=16 in f32
     (bit-identical) and on the pcm16 wire (within one step of the 16-bit
     grid), phase 28's 2048-voice bf16 cascade (200 blocks) per block and
     in f32 and pcm16 batches of 16, phase 12's bank on the 16-bit grid uploaded
     over both wires (the banks bit-identical), host against device bank
     prep for fmajor and the cascade with the packed-bank caches' miss and
     hit, and phase 12's working set for 300 blocks with 'derived' and
     'td' faults in ring and roll mode (a 'derived' slot bit-identical to
     the host pack of both layouts, JAX's 'dual' payload); host ms per
     block, RTF, device-to-host copies and
     bytes per block, ms and bytes per fault.

Phase 22 runs the app at the debug log level and prints the blocks that
missed their deadline beside any silent playback periods.

The line before the last is a JSON object describing each kernel (its
launches summed over the phases whose path rides it: 4, 11, 12, 14-17,
18's cascade, 19-21, 30, 31, 32 and 34 for ring_mac, 7, 10, 18's roll
engine, 30, 32, 33 and 34 for mac_shift, 27-28, 30, 32 and 34 for
ring_mac_bf16 and 27, 32 and 33 for mac_shift_bf16; its
times and roofline bound at KOD=16, under per_kod at KOD 16, 36 and 64,
ring_mac's at the cascade's four shapes under cascade and at the bounce's
shape under bounce, ring_mac_bf16's at the 2048-voice cascade's shapes
and the 64-voice tail under cascade, each kernel's at phase 32's shard
shapes under mesh and mac_shift's two forms at phase 33's shape under
roll96, whose errors its max_abs_err covers too); the last line is
{"ok": true, "device": {...}}. The
script imports nothing of JAX and nothing of the JAX package.
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

VOICES, BLOCK, RATE = 64, 256, 44100
NUM_IRS, IR_SECONDS = 4, 4.0
BLOCKS = 800
SELECT_AT, INTERRUPT_AT = 300, 306
SELECT_CC, PREDELAY_CC = 21, 22
DEADLINE_MS = BLOCK / RATE * 1e3
# roll mode: re-select to IR 1 at 300, swap mid-fade at 320 to the bank
# new[k] = 0.5 * irs[ROLL_PERM[k]], interrupt to new IR 2 at 326
ROLL_SWAP_AT, ROLL_INTERRUPT_AT = 320, 326
ROLL_PERM = (1, 2, 3, 0)
# 'selected': 24 IRs, re-select at 200 (IR 6), interrupt at 206 (IR 12)
SEL_IRS, SEL_BLOCKS, SEL_SELECT_AT, SEL_INTERRUPT_AT = 24, 600, 200, 206
# roll mode at the all-K ceiling: 16 IRs, re-select at 100 (IR 4),
# interrupt at 106 (IR 8)
CEIL_IRS, CEIL_BLOCKS, CEIL_SELECT_AT, CEIL_INTERRUPT_AT = 16, 400, 100, 106
# working set: 152 IRs through 16 slots; a new IR of the full bank every
# 32 blocks from block 100 (CC values 20, 27, ..., 104 -> IRs 23 ... 123),
# then a re-select of the fourth of them (resident: a hit) at 516
WS_IRS, WS_CAPACITY, WS_BLOCKS = 152, 16, 800
WS_CHURN = [(100 + 32 * j, 20 + 7 * j) for j in range(13)]
WS_HIT_AT, WS_HIT_VALUE = 516, 41
WS_QUIET_FROM = 660  # the hit's fade has decayed below 1e-6 by then
# phase 12's golden limit: sound runs read 1.43e-6 (the 4-IR ring phase
# reads 1.39e-6 with the same kernel); a voice playing the IR it played
# before the hit, as a stale or misplaced slot would, reads far above it
WS_GOLDEN_LIMIT = 3e-6
# the cascade (phases 13-15): ratio 16 over 4 s IRs, so P1p = 32 head and
# P2p = 48 tail partitions, F2 = 16 * 256 + 1 tail bins
CAS_RATIO, CAS_PP1, CAS_PP2 = 16, 32, 48
# phase 14: re-select at 300, interrupt at 306 (as phase 4), a swap_bank to
# the bank new[k] = 0.5 * irs[ROLL_PERM[k]] requested mid-fade at 320 (it
# waits for the fades to decay), the golden against the new bank over
# 520-719, then a predelay edit (CC 41: 2624 samples) at 720
CAS_BLOCKS, CAS_SWAP_AT, CAS_AFTER = 800, 320, 520
CAS_EDIT_AT, CAS_EDIT_VALUE = 720, 41
# phase 15: 1024 voices, 300 blocks, a re-select at 100 (IR 1); the fade
# and the tail's 2*ratio+1 blocks of lag are over by 250
BIG_VOICES, BIG_BLOCKS, BIG_SELECT_AT, BIG_AFTER = 1024, 300, 100, 250
# ring_mac's shapes on the cascade's two stages, KOD 16: (F, VI, Pp)
CASCADE_SHAPES = {
    "head_64v": (BLOCK + 1, 2 * VOICES, CAS_PP1),
    "tail_64v": (CAS_RATIO * BLOCK + 1, 2 * VOICES // CAS_RATIO, CAS_PP2),
    "head_1024v": (BLOCK + 1, 2 * BIG_VOICES, CAS_PP1),
    "tail_1024v": (CAS_RATIO * BLOCK + 1, 2 * BIG_VOICES // CAS_RATIO,
                   CAS_PP2)}
# those whose rows fall below the 128-row tile, where phase 13 holds and
# times the bf16 form too (mac_dtype='bf16' on a 64-voice cascade)
CASCADE_BF16_SHAPES = ("tail_64v",)
RING_KODS = (16, 36, 64)  # 4, 9 and 16 IRs: the main path, a KOD that is no
                         # multiple of 16, the all-K ceiling
# the offline bounce (phases 16-18): 30 s of per-voice noise at 0.01 for 64
# voices, whose auto segment count must resolve to 8 (512 virtual voices),
# bounced twice (the host's time spreads between calls)
BOUNCE_SAMPLES, BOUNCE_SEGMENTS, BOUNCE_REPS = 30 * RATE, 8, 2
# phase 17: phase 4's re-select and interrupt, then a wet change (CC 23 to
# 100/128) at 320, mid-fade, over 800 blocks; chunks of 256 blocks
AUTO_WET_CC, AUTO_WET_AT, AUTO_WET_VALUE, AUTO_CHUNK = 23, 320, 100, 256
# phase 18: 10 s; the cascade at auto segments, roll mode at 4 segments
ENGINE_SAMPLES, ROLL_SEGMENTS = 10 * RATE, 4
# phase 19: phase 4's timeline plus a wet change (CC 23 to 100/128) at 350,
# a checkpoint every 160 blocks, the sink failing once when block 400 and
# once when block 700 is delivered (resumes from 320, mid-fade, and 640)
REC_EVERY, REC_FAILS, REC_WET_AT = 160, (400, 700), 350
# phase 20: the cascade, 400 blocks, re-selects at 150 and 230, a
# checkpoint every 100 blocks (200 % 16 = 8: the restored host counter
# lands mid-cycle of the ratio-16 tail), the sink failing at block 250
CAS_REC_BLOCKS, CAS_REC_EVERY, CAS_REC_FAIL = 400, 100, 250
CAS_REC_SELECTS = ((150, 32), (230, 64))
# phase 21: 1000 blocks through shm rings of 64 blocks, a select CC once
# the producer passes block 300 and a wet CC once it passes 600
LIVE_BLOCKS, LIVE_RING_BLOCKS, LIVE_SELECT_NEAR, LIVE_WET_NEAR = (
    1000, 64, 300, 600)
# phase 22: the CLI behind the C bridge, 1000 blocks; the stub jackd runs
# 1500 periods of 5805 us (the app stops at 1000, the rest underrun)
CLI_BLOCKS, STUB_PERIODS, STUB_PERIOD_US = 1000, 1500, 5805
# phases 23-24: the reference's own engines over phase 4's IRs and
# timeline, 600 blocks. The monolithic engine runs the settings default
# fftSize (IRs truncated to 131072 - 1024 samples, the reference's cap) on
# noise at 0.001: its overlap-add clamps every partial sum (the reference's
# f_pointwiseAdd), so a golden that clamps the whole sum holds only where no
# partial sum reaches +-1. A stretch of MONO_CLAMP_BLOCKS more blocks at
# phase 4's amplitude reaches the clamp; it is held against the same engine
# on the CPU instead
ENG_BLOCKS, ENG_AFTER, MONO_FFT, MONO_AMPLITUDE = 600, 500, 131072, 0.001
MONO_CLAMP_BLOCKS = 96
# phase 25: conv pairs at fftSize 131072 and 65536 over two 2-IR banks,
# 400 blocks of stereo noise through the CLI, streamed and --offline
HET_FFTS, HET_BLOCKS, HET_AMPLITUDE = (131072, 65536), 400, 0.004
# phase 27: roll mode in bf16 and in f32, 600 blocks of phase 4's timeline
ROLL27_BLOCKS = 600
# phase 28: the JAX bench's cascade_2048 (bench.py:804-811): 2048 voices,
# bf16, ratio 16, read-side predelay, 300 blocks, a re-select at 100; the
# CLI then runs it for 40 blocks (phase 29's CLI too)
HUGE_VOICES, HUGE_BLOCKS, HUGE_SELECT_AT = 2048, 300, 100
CLI_CASCADE_BLOCKS = 40
# ring_mac's shapes on the 2048-voice cascade's two stages: (F, VI, Pp)
CASCADE_2048_SHAPES = {
    "head_2048v": (BLOCK + 1, 2 * HUGE_VOICES, CAS_PP1),
    "tail_2048v": (CAS_RATIO * BLOCK + 1, 2 * HUGE_VOICES // CAS_RATIO,
                   CAS_PP2)}
# phase 29: the JAX bench's sel152 leg: 152 IRs, 64 voices, 600 blocks, a
# re-select at 300 (CC 64 -> IR 76) with a 150-block fade, a swap_bank at
# 450 (mid-fade), the golden against the new bank from 540
SEL152_IRS, SEL152_BLOCKS, SEL152_SELECT_AT, SEL152_VALUE = 152, 600, 300, 64
SEL152_SPEED, SEL152_SWAP_AT, SEL152_AFTER = 150, 450, 540
# phase 30: chunked serving, 803 blocks (not a multiple of 8) in chunks of
# 8 with a re-select at 296 and an interrupt at 304, on the chunk grid so
# the chunked run must equal the per-block run; the cascade in chunks of 16
# over 400 blocks, re-selects at 160 and 176; run_resilient in chunks with
# a checkpoint every 480 blocks and the sink failing at delivered block 500
# (it resumes from 480)
CHUNK_BLOCKS30, CHUNK30, CHUNK_SELECT_AT, CHUNK_INTERRUPT_AT = 803, 8, 296, 304
CHUNK_AFTER = 500   # the fades have decayed by then: the golden of IR 2
CAS_CHUNK, CAS_CHUNK_BLOCKS = 16, 400
CAS_CHUNK_SELECT_AT, CAS_CHUNK_INTERRUPT_AT = 160, 176
CHUNK_EVERY, CHUNK_FAIL_AT = 480, 500
# phase 31: the operational surface through the CLI: 80 blocks chunked,
# 40 blocks under the profiler, 40 per partitioned cache run
OPS_CHUNK_BLOCKS, OPS_PROFILE_BLOCKS, OPS_CACHE_BLOCKS = 80, 40, 40
# phase 32, the mesh: (a) phase 4's timeline with a checkpoint every 97
# blocks; (b) 400 blocks of roll mode, (c) 200 in bf16; (d) the bf16
# cascade at 2560 voices (the JAX package's two-chip capacity leg,
# __graft_entry__.py:140-220), 200 blocks, a re-select at 100; (e) the
# working set, 200 blocks, a new IR every 32 from block 16; (g) 10 s
# bounces
MESH_EVERY, MESH_ROLL_BLOCKS, MESH_BF16_BLOCKS = 97, 400, 200
MESH_CAS_VOICES, MESH_CAS_BLOCKS, MESH_CAS_SELECT_AT = 2560, 200, 100
MESH_WS_BLOCKS, MESH_BOUNCE_SECONDS, MESH_BOUNCE_SEGMENTS = 200, 10, 16
# phase 33: a roll session at 96 voices (VI = 192 delay-line rows, no
# multiple of 128: mac_shift's small tiles) over phase 4's 4 IRs, 400
# blocks in f32 then in bf16: a re-select at 60 (IR 1), a swap_bank
# mid-fade at 80 to phase 7's bank new[k] = 0.5 * irs[ROLL_PERM[k]], an
# interrupt at 86 (new IR 2); the golden before the re-select and from 320
# (234 blocks after the interrupt, as phase 7), on voices 0, 40, 64 and
# 95: rows 0, 80, 128 and 190, so each of the f32 form's three 64-row
# tiles and the bf16 form's two 96-row tiles is held to the golden
ROLL96_VOICES, ROLL96_BLOCKS, ROLL96_ROWS = 96, 400, (0, 40, 64, 95)
ROLL96_SELECT_AT, ROLL96_SWAP_AT, ROLL96_INTERRUPT_AT = 60, 80, 86
ROLL96_AFTER = 320
# phase 34, the host link: phase 4's ring session for 400 blocks and phase
# 28's 2048-voice bf16 cascade for 200, each per block and in batches of
# 16; host prep against device prep over 200 blocks with a re-select at
# 100; phase 12's working set for 300 blocks, a new IR every 32 from 16
LINK_BATCH, LINK_BLOCKS, LINK_HUGE_BLOCKS = 16, 400, 200
LINK_PREP_BLOCKS, LINK_PREP_SELECT_AT = 200, 100
LINK_WS_BLOCKS = 300
LINK_PACE_FROM = 32   # the sink's pace is taken from the third batch on
LINK_WS_CHURN = [(16 + 32 * j, 20 + 7 * j) for j in range(9)]
# published peaks of one H100 SXM (NVIDIA's data sheet, dense), at the full
# 700 W power limit: HBM bytes/s, and FLOP/s by operand type: f32 outside
# the tensor cores, bf16 on them (bf16 products, f32 sums)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


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


def noise_input(blocks, voices=VOICES, amplitude=0.01, rows=None):
    """Voices `rows` (the first and last by default) of NoiseSource(voices,
    BLOCK, blocks, amplitude, seed 0)."""
    noise = np.random.default_rng(0)
    rows = list(rows or (0, voices - 1))
    return np.concatenate(
        [(noise.standard_normal((voices, 2, BLOCK)) * amplitude
          ).astype(np.float32)[rows] for _ in range(blocks)],
        axis=-1)


def golden_error(out, x, i, b0, b1, ir, predelay, wet=0.7):
    """Max abs error of voice row `i` of `out` over blocks b0..b1-1 against
    the golden of IR `ir`."""
    want = golden(x[i], [ir, ir], wet=wet, dry=0.2, predelay=predelay)
    return float(np.abs(out[i, :, b0 * BLOCK: b1 * BLOCK]
                        - want[:, b0 * BLOCK: b1 * BLOCK]).max())


def check_golden(name, out, x, windows, predelay, limit=1e-4,
                 voices=VOICES, rows=None):
    """out, x [rows, 2, T]: voices `rows` of `voices` (the first and last
    by default); windows: (label, first block, end block, IR [2, L][, wet])
    (wet 0.7 unless given). Returns the largest error; raises beyond
    `limit`."""
    worst = 0.0
    for i, v in enumerate(rows or (0, voices - 1)):
        for label, b0, b1, ir, *wet in windows:
            err = golden_error(out, x, i, b0, b1, ir, predelay, *wet)
            worst = max(worst, err)
            print(f"{name} golden voice {v} blocks {b0}-{b1 - 1} ({label}): "
                  f"max_abs_err {err:.3e} (limit {limit:.0e})")
            if not err <= limit:
                raise AssertionError(f"{name}: voice {v} disagrees with the "
                                     f"golden {label}")
    return worst


def roofline_ms(nbytes, flops, dtype):
    """The least time the card could take: the larger of `nbytes` over the
    HBM rate and `flops` operations on operands of torch `dtype` over the
    card's peak for that type. Returns (ms, "bytes" or "operations")."""
    peak = PEAK_FLOPS[str(dtype).removeprefix("torch.")]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ring_mac_library(w, fdl, rhs2):
    """One PyTorch call computing ring_mac's function with a host-side ring
    slot `w`: the yardstick chip_smoke.py times beside the kernel
    (library_ms). The port never calls it. f32: an einsum over the sliced
    window. bf16: torch.bmm of the bf16 line by the gathered bf16 window
    (the reshape of the two planes' windows gathers them) with f32 out,
    exact products summed in f32 as the kernel does (an einsum on bf16
    operands would round m to bf16: ring_mac_einsum_bf16)."""
    import torch

    pp = fdl.shape[3]
    w = w % pp
    window = rhs2[:, :, pp - w: 2 * pp - w]
    if fdl.dtype == torch.bfloat16:
        f, vi = fdl.shape[:2]
        return torch.bmm(fdl.reshape(f, vi, 2 * pp),
                         window.reshape(f, 2 * pp, rhs2.shape[3]),
                         out_dtype=torch.float32)
    return torch.einsum("fvcs,fcsk->fvk", fdl, window)


def ring_mac_einsum_bf16(w, fdl, rhs2):
    """torch.einsum of the bf16 line by the sliced bf16 window: m rounded
    to bf16, so not ring_mac's function; a yardstick printed on its own
    line."""
    import torch

    pp = fdl.shape[3]
    w = w % pp
    return torch.einsum("fvcs,fcsk->fvk", fdl, rhs2[:, :, pp - w: 2 * pp - w])


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


def step_times(step, state, bank, params, x, n=520, skip=20):
    """p50/p99 device ms of `n` back-to-back calls of one engine step (CUDA
    events around each call, the first `skip` dropped). Returns (p50, p99,
    state)."""
    import torch

    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        s.record()
        state, _ = step(state, bank, params, x)
        e.record()
    torch.cuda.synchronize()
    times = np.array([s.elapsed_time(e) for s, e in zip(starts, ends)])[skip:]
    return (float(np.percentile(times, 50)), float(np.percentile(times, 99)),
            state)


def run_working_set(bank, async_paging, configure, select, keep_sink, dev,
                    x, irs, hit_ir, reset_counts, rm, ms):
    """Phase 12, one run: build the 16-slot working-set model over the
    152-IR bank with device prep, stream the churn timeline, check it and
    time its faults. Returns the run's figures."""
    import torch

    from tpu_audio_torch.engine import device_prep
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    mode = "async" if async_paging else "sync"
    name = f"working set ({mode})"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, max_predelay=8192,
                              bank_capacity=WS_CAPACITY,
                              async_paging=async_paging, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ws, cp, engine = model.working_set, model.control, model.engine
    kod = model.spectra.rhs2.shape[3]
    if (not engine.ring_mode or engine.mac_strategy != "allk"
            or kod != 4 * WS_CAPACITY or ws.full_size != WS_IRS):
        raise AssertionError(f"{name}: ring {engine.ring_mode}, "
                             f"{engine.mac_strategy}, KOD {kod}, full size "
                             f"{ws.full_size}")
    configure(cp)

    class TimedSource(NoiseSource):
        """Stamps the start of every session iteration (MIDI included)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.stamps = []

        def read(self):
            self.stamps.append(time.perf_counter())
            return super().read()

    source = TimedSource(VOICES, BLOCK, WS_BLOCKS, amplitude=0.01, seed=0)
    sink = keep_sink()
    session = model.session(source, sink)
    first = {}

    def timed_warmup():
        """The session's warm-up is the fault path's first use."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        start.record()
        ws.warmup()
        end.record()
        torch.cuda.synchronize()
        first["wall_ms"] = (time.perf_counter() - t1) * 1e3
        first["ms"] = start.elapsed_time(end)

    if session.pre_run_hooks != [ws.warmup]:
        raise AssertionError(f"{name}: pre_run_hooks {session.pre_run_hooks}")
    session.pre_run_hooks[:] = [timed_warmup]

    # host ms per iteration of the parts a select event runs: the MIDI
    # handling (the sync faults inside it), a slot's pack (on the pager's
    # thread in async mode), the collapse, the whole session block
    # (collapse, step, end_block with the pager's poll, delivery)
    parts = {}

    def timed(what, fn):
        def call(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                key = (what, len(source.stamps) - 1)
                parts[key] = (parts.get(key, 0.0)
                              + (time.perf_counter() - t1) * 1e3)
        return call

    cp.apply_midi_message = timed("midi", cp.apply_midi_message)
    ws._fault = timed("fault", ws._fault)
    engine.pack_bank_slot = timed("pack", engine.pack_bank_slot)
    session._maybe_collapse = timed("collapse", session._maybe_collapse)
    record = session.timer.record

    def timed_record(elapsed):
        parts["block", len(source.stamps) - 1] = elapsed * 1e3
        record(elapsed)

    session.timer.record = timed_record
    cp.block_hooks[:] = [timed("poll", h) if h == ws.poll else h
                         for h in cp.block_hooks]
    midi = MidiSchedule([select(b, v) for b, v in WS_CHURN]
                        + [select(WS_HIT_AT, WS_HIT_VALUE)])
    state = model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=midi)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, shifts = rm.ring_mac.launches, ms.mac_shift.launches
    if async_paging:
        ws.drain(timeout=60)
    steps = session.blocks_streamed
    final = {ws.slot_to_full[int(s)] for s in cp.select.ravel()}
    print(f"{name}: {steps} blocks in {run_s:.3f} s (model built in "
          f"{build_s:.2f} s, bank {model.bank_bytes() / 1e6:.1f} MB), "
          f"ring_mac launches {launches}, mac_shift launches {shifts}, "
          f"misses {ws.misses}, hits {ws.hits}, deferred {ws.deferred}, "
          f"starved {ws.starved}, indexed blocks {session.indexed_blocks}, "
          f"general blocks {session.general_blocks}, resident "
          f"{ws.slot_to_full}, now playing {sorted(final)}")
    if steps != WS_BLOCKS or sink.blocks != WS_BLOCKS:
        raise AssertionError(f"{name}: streamed {steps} blocks, delivered "
                             f"{sink.blocks}, wanted {WS_BLOCKS}")
    if launches != steps or shifts:
        raise AssertionError(f"{name}: ring_mac launched {launches} times "
                             f"and mac_shift {shifts} in {steps} steps")
    if ws.misses < 12 or ws.hits < 1 or ws.warmups != 1:
        raise AssertionError(f"{name}: {ws.misses} misses, {ws.hits} hits, "
                             f"{ws.warmups} warm-ups")
    if async_paging and (not ws.deferred or ws._pending
                         or ws._deferred_target):
        raise AssertionError(f"{name}: {ws.deferred} deferred selects, "
                             f"{len(ws._deferred_target)} never applied")
    if final != {hit_ir}:
        raise AssertionError(f"{name}: voices play IRs {sorted(final)}, "
                             f"wanted {hit_ir}")
    if not sink.finite:
        raise AssertionError(f"{name}: non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError(f"{name}: the crossfades did not decay")
    out, predelay = sink.data(), int(cp.predelay[0, 0])
    golden_worst = check_golden(
        f"working set ({mode})", out, x,
        (("before the churn, IR 0", 0, WS_CHURN[0][0], irs[0]),
         (f"after the last fade, IR {hit_ir}", WS_QUIET_FROM, WS_BLOCKS,
          irs[hit_ir])),
        predelay=predelay, limit=WS_GOLDEN_LIMIT)
    # the control: the same blocks against the IR played before the hit
    stale_ir = WS_CHURN[-1][1] * WS_IRS // 128
    stale_err = min(golden_error(out, x, i, WS_QUIET_FROM, WS_BLOCKS,
                                 irs[stale_ir], predelay) for i in (0, 1))
    print(f"{name}: control, blocks {WS_QUIET_FROM}-{WS_BLOCKS - 1} against "
          f"IR {stale_ir}'s golden (a stale or misplaced slot): max_abs_err "
          f"{stale_err:.3e} (must exceed {WS_GOLDEN_LIMIT:.0e})")
    if not stale_err > WS_GOLDEN_LIMIT:
        raise AssertionError(f"{name}: the golden check cannot tell IR "
                             f"{hit_ir} from IR {stale_ir}")
    summary = session.summary()
    peak_mb = torch.cuda.max_memory_allocated() / 1e6

    # per-iteration wall time with the MIDI handling (and so the sync
    # faults) that the session's own block timer leaves out
    iters = np.diff(np.array(source.stamps)) * 1e3   # iteration i -> i+1
    over = [i for i, t in enumerate(iters) if i >= 10 and t > DEADLINE_MS]
    event_blocks = {b for b, _ in WS_CHURN} | {WS_HIT_AT}
    at_selects = [i for i in over if i in event_blocks]
    slowest = sorted((round(float(iters[b]), 3) for b in event_blocks),
                     reverse=True)[:4]
    print(f"{name}: {len(over)} iterations over the deadline after "
          f"warm-up (first {over[:8]}), {len(at_selects)} of them at select "
          f"blocks {at_selects[:8]}; slowest select-block iterations "
          f"{slowest} ms")
    names_ms = ("midi", "fault", "pack", "collapse", "poll", "block")
    for i in over:
        split = ", ".join(f"{what} {parts.get((what, i), 0.0):.3f}"
                          for what in names_ms)
        print(f"{name}: iteration {i} {iters[i]:.3f} ms host: {split}")
    churn = [b for b, _ in WS_CHURN]
    mean_ms = {what: float(np.mean([parts.get((what, b), 0.0)
                                    for b in churn])) for what in names_ms}
    print(f"{name}: mean over the 13 churn blocks, host ms: iteration "
          f"{float(np.mean(iters[churn])):.3f}, "
          + ", ".join(f"{what} {ms:.3f}" for what, ms in mean_ms.items()))

    # the resident bank against a fresh device prep of what its slots name
    names = [int(f) for f in ws.slot_to_full]
    fresh = device_prep.prepare_fmajor_bank_device(
        engine, np.stack([irs[f] for f in names]))
    bank_err = 0.0
    for leaf in ("rhs2", "spectra_rev2"):
        got, want = getattr(ws.bank, leaf), getattr(fresh, leaf)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        print(f"{name}: resident {leaf} vs a fresh device prep of slots "
              f"{names}: max_abs_err {err:.3e} (limit {1e-6 * scale:.3e})")
        if not err <= 1e-6 * scale:
            raise AssertionError(f"{name}: resident {leaf} differs from a "
                                 f"fresh prep")
        bank_err = max(bank_err, err)
    del fresh

    # warm faults: re-page slot 0's resident IR (no change to the bank)
    warm, warm_wall = [], []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        engine.update_bank_slot(ws.bank, 0, irs[names[0]])
        end.record()
        torch.cuda.synchronize()
        warm_wall.append((time.perf_counter() - t1) * 1e3)
        warm.append(start.elapsed_time(end))
    ws.close()
    out = {"build_s": build_s, "bank_mb": model.bank_bytes() / 1e6,
           "peak_mb": peak_mb, "first_ms": first["ms"],
           "first_wall_ms": first["wall_ms"],
           "warm_ms": float(np.median(warm)),
           "warm_wall_ms": float(np.median(warm_wall)),
           "summary": summary, "iter_p99_ms": float(np.percentile(
               iters[10:], 99)),
           "iter_over": len(over), "iter_over_at_selects": len(at_selects),
           "misses": ws.misses, "hits": ws.hits, "deferred": ws.deferred,
           "starved": ws.starved, "bank_err": bank_err,
           "golden_err": golden_worst, "stale_err": stale_err,
           "launches": launches}
    print(f"{name}: fault first use {first['ms']:.3f} ms (CUDA events; "
          f"{first['wall_ms']:.3f} ms wall), warm median {out['warm_ms']:.3f}"
          f" ms ({out['warm_wall_ms']:.3f} ms wall); peak allocated "
          f"{peak_mb:.1f} MB")
    del model, session, state, ws, engine
    return out


def device_busy(step, state, bank, params, x, n=30, label=None):
    """Device-busy microseconds and device operations (kernels, copies,
    fills) per call of one engine step, from torch.profiler over `n` calls
    after 5 unprofiled ones; with a `label`, also prints the eight device
    operations that took the most time. Returns (busy_us, ops, state);
    busy_us and ops are None when the profiler recorded no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        state, _ = step(state, bank, params, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, bank, params, x)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not device:
        return None, None, state
    busy = sum(e.time_range.elapsed_us() for e in device)
    if label:
        per_op = {}
        for e in device:
            per_op[e.name] = per_op.get(e.name, 0.0) + e.time_range.elapsed_us()
        for op, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{label}: {us / n:8.1f} us per step in {op[:100]}")
    return busy / n, len(device) / n, state


def time_ring_mac(rm, fdl, rhs2, w_host=5, reps=200):
    """ring_mac at one shape against its plain version and one library
    call (ring_mac_library), and in bf16 also the bf16 einsum (it rounds m
    to bf16), interleaved (plain, [einsum,] library, kernel, kernel,
    library, [einsum,] plain), with the roofline bound from the bytes each
    input is read once in its dtype and m written once in f32. Returns
    {kernel, plain, library, [einsum,] bound, bound_by, bytes} in ms (bytes
    in bytes)."""
    import torch

    wt = torch.tensor(w_host, dtype=torch.int32, device=fdl.device)
    calls = {"plain": lambda: rm.ring_mac_reference(wt, fdl, rhs2),
             "library": lambda: ring_mac_library(w_host, fdl, rhs2),
             "kernel": lambda: rm.ring_mac(wt, fdl, rhs2)}
    order = ["plain", "library", "kernel"]
    if fdl.dtype == torch.bfloat16:
        calls["einsum"] = lambda: ring_mac_einsum_bf16(w_host, fdl, rhs2)
        order.insert(1, "einsum")
    runs = {key: [] for key in calls}
    for key in order + order[::-1]:
        runs[key].append(cuda_ms(calls[key], reps))
    f, vi, _, pp = fdl.shape
    kod = rhs2.shape[3]
    nbytes = ((fdl.numel() + f * 2 * pp * kod) * fdl.element_size()
              + f * vi * kod * 4)
    bound_ms, bound_by = roofline_ms(nbytes, 2 * f * vi * 2 * pp * kod,
                                     fdl.dtype)
    out = {key: float(np.mean(v)) for key, v in runs.items()}
    out.update(bound=bound_ms, bound_by=bound_by, bytes=nbytes)
    return out


def check_ring_mac(rm, fdl, rhs2, label):
    """ring_mac on (fdl, rhs2) against the float64 plain version, and the
    library yardstick too, at w in {0, 1, Pp/2+1, Pp-1}, within 1e-5 of
    the output's scale. Returns the largest error; raises beyond it."""
    import torch

    f, vi, _, pp = fdl.shape
    kod = rhs2.shape[3]
    fdl64, rhs64 = fdl.double(), rhs2.double()
    worst = 0.0
    for w in sorted({0, 1, pp // 2 + 1, pp - 1}):
        wt = torch.tensor(w, dtype=torch.int32, device=fdl.device)
        got = rm.ring_mac(wt, fdl, rhs2)
        torch.cuda.synchronize()
        ref64 = rm.ring_mac_reference(w, fdl64, rhs64)
        scale = ref64.abs().max().item()
        err = (got.double() - ref64).abs().max().item()
        err_lib = (ring_mac_library(w, fdl, rhs2).double()
                   - ref64).abs().max().item()
        print(f"ring_mac vs plain [{label} F={f} VI={vi} Pp={pp} KOD={kod} "
              f"w={w}]: max_abs_err {err:.3e} (library {err_lib:.3e}, limit "
              f"{1e-5 * scale:.3e})")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"ring_mac kernel disagrees with the plain "
                                 f"version at {label} w={w}")
        if not err_lib <= 1e-5 * scale:
            raise AssertionError(f"the library yardstick computes another "
                                 f"function at {label} w={w}")
        worst = max(worst, err)
        del got, ref64
    return worst


def check_mac_shift(ms, fdl, xn, rhs, label):
    """mac_shift on (fdl, xn, rhs) against its plain version: the shifted
    line bit-identical to the plain shift in the operands' dtype, m within
    1e-5 of the output's scale of the float64 plain sums. Shifts a copy of
    `fdl`. Returns the error; raises beyond the limit."""
    import torch

    f, vi, _, pp = fdl.shape
    want_fdl, _ = ms.mac_shift_reference(fdl, xn, rhs)
    _, ref = ms.mac_shift_reference(fdl.double(), xn.double(), rhs.double())
    got_fdl, got = ms.mac_shift(fdl.clone(), xn, rhs)
    torch.cuda.synchronize()
    same = torch.equal(got_fdl, want_fdl)
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item()
    print(f"mac_shift vs plain [{label} F={f} VI={vi} Pp={pp} "
          f"KOD={rhs.shape[3]}]: shifted line "
          f"{'bit-identical' if same else 'DIFFERS'}, m max_abs_err "
          f"{err:.3e} (limit {1e-5 * scale:.3e})")
    if not same or not err <= 1e-5 * scale:
        raise AssertionError(f"mac_shift disagrees with the plain version at "
                             f"{label}")
    return err


class ShapeProbe:
    """Records, while ``on``, the shapes the engines call each kernel's
    wrapper at: the wrappers' names in engine/fmajor.py and
    engine/cascade.py are wrapped for the probe's life (the wrappers still
    count their launches). ``seen`` maps (kernel, F, VI, Pp, KOD) to the
    calls at that shape; ``close()`` puts the wrappers back."""

    def __init__(self):
        from tpu_audio_torch.engine import cascade, fmajor

        self.on, self.seen, self._saved = False, {}, []
        for module in (fmajor, cascade):
            for name in ("ring_mac", "mac_shift"):
                if hasattr(module, name):
                    self._wrap(module, name)

    def _wrap(self, module, name):
        import torch

        fn = getattr(module, name)

        def probe(*args):
            if self.on:
                fdl, rhs = args[1:3] if name == "ring_mac" else args[0::2]
                kernel = name + ("_bf16" if fdl.dtype == torch.bfloat16
                                 else "")
                f, vi, _, pp = fdl.shape
                key = (kernel, f, vi, pp, rhs.shape[3])
                self.seen[key] = self.seen.get(key, 0) + 1
            return fn(*args)

        setattr(module, name, probe)
        self._saved.append((module, name, fn))

    def close(self):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self._saved = []


def check_cascade_shapes(rm, dev, rng):
    """Phase 13: ring_mac at the cascade's four shapes (KOD 16) against the
    float64 plain version (check_ring_mac), then timed (time_ring_mac);
    the bf16 form too at the shapes whose rows fall below the 128-row tile
    (CASCADE_BF16_SHAPES: the 64-voice tail). Returns ({dtype: largest
    error}, {dtype: {shape: timing}}), dtype "f32" or "bf16"."""
    import torch

    worst, timed = {"f32": 0.0, "bf16": 0.0}, {"f32": {}, "bf16": {}}
    kod = 4 * NUM_IRS
    cases = [("f32", name) for name in CASCADE_SHAPES]
    cases += [("bf16", name) for name in CASCADE_BF16_SHAPES]
    for dtype, name in cases:
        f, vi, pp = CASCADE_SHAPES[name]
        fdl, rhs2 = (torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                                  device=dev)
                     for shape in ((f, vi, 2, pp), (f, 2, 2 * pp, kod)))
        if dtype == "bf16":
            fdl, rhs2 = fdl.to(torch.bfloat16), rhs2.to(torch.bfloat16)
        label = f"cascade {name}" + (" bf16" if dtype == "bf16" else "")
        worst[dtype] = max(worst[dtype],
                           check_ring_mac(rm, fdl, rhs2, label))
        t = timed[dtype][name] = time_ring_mac(rm, fdl, rhs2)
        gbps = t["bytes"] / (t["kernel"] * 1e-3) / 1e9
        print(f"ring_mac timing [{label}]: kernel "
              f"{t['kernel'] * 1e3:.2f} us ({gbps:.0f} GB/s, "
              f"{100 * t['bound'] / t['kernel']:.1f} % of "
              f"the {t['bound'] * 1e3:.2f} us bound by {t['bound_by']}), "
              f"plain {t['plain'] * 1e3:.2f} us, library "
              f"{t['library'] * 1e3:.2f} us")
        del fdl, rhs2
        torch.cuda.empty_cache()
    return worst, timed


def run_cascade_timeline(bank, irs, new_irs, side, dev, configure, select,
                         keep_sink, reset_counts, rm, ms):
    """Phase 14, one run: ConvolutionReverb(engine='cascade') at 64 voices
    through its session for 800 blocks: the re-select and interrupt of
    phase 4, a swap_bank to `new_irs` requested mid-fade (it must wait for
    the fades to decay, then apply), a predelay edit after the golden
    windows. Every block must launch ring_mac twice and mac_shift never.
    Returns the run's figures, the whole output among them."""
    import torch

    from tpu_audio_torch.engine import device_prep
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    name = f"cascade 64 voices ({side} side)"
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="cascade",
                              max_predelay=8192, cascade_ratio=CAS_RATIO,
                              predelay_side=side, device=dev)
    engine = model.engine
    new_bank = device_prep.prepare_cascade_bank_device(
        engine, np.stack(new_irs))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ((engine.ratio, engine.pp1, engine.pp2, engine.mac_strategy)
            != (CAS_RATIO, CAS_PP1, CAS_PP2, "allk")):
        raise AssertionError(f"{name}: ratio {engine.ratio}, Pp "
                             f"{engine.pp1}/{engine.pp2}, "
                             f"{engine.mac_strategy}")
    cp = model.control
    configure(cp)
    predelay = int(cp.predelay[0, 0])
    sink = keep_sink(keep_all=True)
    session = model.session(NoiseSource(VOICES, BLOCK, CAS_BLOCKS,
                                        amplitude=0.01, seed=0), sink)
    state = model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, max_blocks=CAS_SWAP_AT, midi=MidiSchedule(
        [select(SELECT_AT, 32), select(INTERRUPT_AT, 64)]))
    session.swap_bank(new_bank)
    applied = []
    apply = session._apply_pending_bank

    def watch(st):
        st = apply(st)
        applied.append(session._pending_bank is None)
        return st

    session._apply_pending_bank = watch
    state = session.run(state, midi=MidiSchedule(
        [(CAS_EDIT_AT - CAS_SWAP_AT, "",
          bytes([0xB0, PREDELAY_CC, CAS_EDIT_VALUE]))]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches, shifts = rm.ring_mac.launches, ms.mac_shift.launches
    steps = session.blocks_streamed
    swap_at = CAS_SWAP_AT + applied.index(True) if True in applied else None
    print(f"{name}: {steps} blocks in {run_s:.3f} s (model and new bank "
          f"built in {build_s:.2f} s), ring_mac launches {launches}, "
          f"mac_shift launches {shifts}, indexed blocks "
          f"{session.indexed_blocks}, general blocks "
          f"{session.general_blocks}, swap requested at {CAS_SWAP_AT} and "
          f"applied at {swap_at}, selects {cp.select[0].tolist()}, predelay "
          f"{cp.predelay[0].tolist()}")
    if steps != CAS_BLOCKS or sink.blocks != CAS_BLOCKS:
        raise AssertionError(f"{name}: streamed {steps} blocks, delivered "
                             f"{sink.blocks}, wanted {CAS_BLOCKS}")
    if launches != 2 * steps or shifts:
        raise AssertionError(f"{name}: ring_mac launched {launches} times "
                             f"and mac_shift {shifts} in {steps} steps")
    if session.indexed_blocks < 20 or session.general_blocks:
        raise AssertionError(f"{name}: {session.indexed_blocks} indexed "
                             f"blocks, {session.general_blocks} general")
    if (swap_at is None or swap_at <= INTERRUPT_AT + 50
            or session.bank is not new_bank):
        raise AssertionError(f"{name}: the swap applied at {swap_at}, not "
                             f"after the fades decayed")
    if not sink.finite:
        raise AssertionError(f"{name}: non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError(f"{name}: the crossfades did not decay")
    out = sink.data()
    golden_err = check_golden(
        name, out[[0, VOICES - 1]], noise_input(CAS_BLOCKS, VOICES),
        (("before the re-selects, IR 0", 0, SELECT_AT, irs[0]),
         (f"after the swap, new bank IR 2 = 0.5 * IR {ROLL_PERM[2]}",
          CAS_AFTER, CAS_EDIT_AT, new_irs[2])),
        predelay=predelay, voices=VOICES)
    return {"model": model, "state": state, "out": out,
            "summary": session.summary(), "launches": launches,
            "swap_at": swap_at, "golden_err": golden_err,
            "indexed": session.indexed_blocks, "run_s": run_s}


def run_cascade_1024(bank, irs, dev, configure, select, keep_sink,
                     reset_counts, rm, ms):
    """Phase 15: the cascade at 1024 voices (the JAX bench's default
    cascade leg: 4 s IRs, f32, ratio 16) through the model's session for
    300 blocks with a re-select at 100, against the golden on voices 0 and
    1023; then its steps and the fmajor ring/allk steady step at the same
    voice count, timed. Returns the figures."""
    import torch

    from tpu_audio_torch.engine import device_prep
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    name = f"cascade {BIG_VOICES} voices"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=BIG_VOICES, block=BLOCK,
                              sample_rate=RATE, engine="cascade",
                              max_predelay=8192, cascade_ratio=CAS_RATIO,
                              device=dev)
    engine, cp = model.engine, model.control
    configure(cp)
    state = model.init_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    state_mb = sum(v.numel() * v.element_size() for v in vars(state).values()
                   if isinstance(v, torch.Tensor)) / 1e6
    if (engine.ratio, engine.pp2) != (CAS_RATIO, CAS_PP2):
        raise AssertionError(f"{name}: ratio {engine.ratio}, P2p "
                             f"{engine.pp2}")
    sink = keep_sink()
    session = model.session(NoiseSource(BIG_VOICES, BLOCK, BIG_BLOCKS,
                                        amplitude=0.01, seed=0), sink)

    # host seconds of each part of a session block, per call
    parts = {}

    def timed(what, fn):
        def call(*args, **kwargs):
            t1 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                parts.setdefault(what, []).append(time.perf_counter() - t1)
        return call

    for attr, what in (("_apply_pending_bank", "swap"),
                       ("_maybe_collapse", "collapse"), ("_upload", "upload"),
                       ("_step_steady", "step"), ("_step_indexed", "step"),
                       ("_start_fetch", "fetch"), ("_deliver", "deliver")):
        setattr(session, attr, timed(what, getattr(session, attr)))
    for attr, what in (("snapshot_device", "params"),
                       ("end_block", "end_block")):
        setattr(cp, attr, timed(what, getattr(cp, attr)))
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=MidiSchedule(
        [select(BIG_SELECT_AT, 32)]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # mean host ms per block of each part after the session's warm-up
    split = {what: 1e3 * float(np.sum(t[10:BIG_BLOCKS])) / (BIG_BLOCKS - 10)
             for what, t in parts.items()}
    launches, shifts = rm.ring_mac.launches, ms.mac_shift.launches
    steps = session.blocks_streamed
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    summary = session.summary()
    print(f"{name}: {steps} blocks in {run_s:.3f} s (model built in "
          f"{build_s:.2f} s; state {state_mb:.1f} MB, bank "
          f"{model.bank_bytes() / 1e6:.1f} MB, peak allocated {peak_mb:.1f} "
          f"MB), ring_mac launches {launches}, mac_shift launches {shifts}, "
          f"indexed blocks {session.indexed_blocks}, general blocks "
          f"{session.general_blocks}, session p50 / p99 "
          f"{summary['p50_ms']:.3f} / {summary['p99_ms']:.3f} ms per block, "
          f"RTF {summary['rtf']:.3f}, missed {summary['missed_deadlines']}")
    print(f"{name}: host ms per session block after warm-up: "
          + ", ".join(f"{what} {ms:.3f}" for what, ms in split.items())
          + f" (the whole block: {summary['avg_ms']:.3f} mean)")
    if steps != BIG_BLOCKS or sink.blocks != BIG_BLOCKS:
        raise AssertionError(f"{name}: streamed {steps} blocks, delivered "
                             f"{sink.blocks}, wanted {BIG_BLOCKS}")
    if launches != 2 * steps or shifts:
        raise AssertionError(f"{name}: ring_mac launched {launches} times "
                             f"and mac_shift {shifts} in {steps} steps")
    if session.indexed_blocks < 20 or session.general_blocks:
        raise AssertionError(f"{name}: {session.indexed_blocks} indexed "
                             f"blocks, {session.general_blocks} general")
    if not sink.finite:
        raise AssertionError(f"{name}: non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError(f"{name}: the crossfade did not decay")
    golden_err = check_golden(
        name, sink.data(), noise_input(BIG_BLOCKS, BIG_VOICES),
        (("before the re-select, IR 0", 0, BIG_SELECT_AT, irs[0]),
         ("after the fade and the tail's lag, IR 1", BIG_AFTER, BIG_BLOCKS,
          irs[1])),
        predelay=int(cp.predelay[0, 0]), voices=BIG_VOICES)

    params = cp.snapshot_device()
    x = torch.randn((BIG_VOICES, 2, BLOCK), device=dev) * 0.01
    steps_ms = {}
    for step_name in ("step_coef_steady", "step_coef_indexed"):
        step = getattr(engine, step_name)
        p50, p99, state = step_times(step, state, model.spectra, params, x)
        busy, ops, state = device_busy(step, state, model.spectra, params, x,
                                       label=f"cascade1024 {step_name}")
        steps_ms[step_name] = (p50, p99, busy, ops)
    del model, session, state, engine
    torch.cuda.empty_cache()

    fm = FMajorPartitionedConvolution(
        BIG_VOICES, BLOCK, bank.max_partitions(BLOCK), max_predelay=8192,
        num_irs=NUM_IRS, swap_snapshot=False, device=dev)
    fm_bank = device_prep.prepare_fmajor_bank_device(fm, bank)
    fm_cp = ControlPlane(BIG_VOICES, NUM_IRS, 8192, device=dev)
    configure(fm_cp)
    fm_params = fm_cp.snapshot_device()
    fm_state = fm.init_converged(fm_bank, fm_params)
    p50, p99, fm_state = step_times(fm.step_coef_steady, fm_state, fm_bank,
                                    fm_params, x)
    busy, ops, fm_state = device_busy(fm.step_coef_steady, fm_state, fm_bank,
                                      fm_params, x,
                                      label="fmajor1024 step_coef_steady")
    steps_ms["fmajor_step_coef_steady"] = (p50, p99, busy, ops)
    for step_name, (p50, p99, busy, ops) in steps_ms.items():
        what = "not measured" if busy is None else (
            f"device busy {busy:.1f} us in {ops:.1f} device ops")
        print(f"{name}: {step_name} p50 / p99 {p50:.3f} / {p99:.3f} ms (CUDA "
              f"events), {what} per step")
    del fm, fm_bank, fm_state
    torch.cuda.empty_cache()
    return {"summary": summary, "launches": launches, "peak_mb": peak_mb,
            "state_mb": state_mb, "build_s": build_s, "run_s": run_s,
            "golden_err": golden_err, "steps": steps_ms, "split": split}


def voice_noise(voices, samples, seed):
    """Per-voice program material [V, 2, T] f32: noise at 0.01 from numpy
    seed `seed`."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((voices, 2, samples), dtype=np.float32)
    x *= np.float32(0.01)
    return x


class BounceStages:
    """Times the stages of render_offline calls by wrapping the renderer's
    module functions while the context is open: the host input layout
    (_block_tensor), the prime (host wall and CUDA events), the step loop
    (host wall of the enqueue, CUDA events from its first step to its last,
    the steps run) and _collect (host wall: a step chunk's staging buffer,
    its step loop and the wait). Summed over every call inside the context
    (a bounce makes one per step chunk, a chunked bounce more)."""

    NAMES = ("_block_tensor", "_prime_fast", "_step_loop", "_collect")

    def __init__(self, offline):
        self.offline = offline
        self.wall = dict.fromkeys(self.NAMES, 0.0)
        self.events = {name: [] for name in self.NAMES}
        self.steps = 0

    def __enter__(self):
        self.orig = {name: getattr(self.offline, name) for name in self.NAMES}
        for name in self.NAMES:
            setattr(self.offline, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.offline, name, fn)

    def _wrap(self, name):
        import torch

        fn = self.orig[name]

        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            try:
                return fn(*args, **kwargs)
            finally:
                end.record()
                self.wall[name] += time.perf_counter() - t0
                self.events[name].append((start, end))
                if name == "_step_loop":   # (step, state, warmup, seg_len, ..)
                    self.steps += args[2] + args[3]
        return call

    def device_ms(self, name):
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events[name])

    def report(self, label, wall_s, audio_s, voices):
        """Prints and returns the stage split of the bounces timed."""
        loop_ms = self.device_ms("_step_loop")
        out = {"wall_s": wall_s,
               "prime_wall_s": self.wall["_prime_fast"],
               "prime_device_ms": self.device_ms("_prime_fast"),
               "loop_wall_s": self.wall["_step_loop"],
               "loop_device_ms": loop_ms,
               "collect_wall_s": (self.wall["_collect"]
                                  - self.wall["_step_loop"]),
               "layout_wall_s": self.wall["_block_tensor"],
               "steps": self.steps,
               "ms_per_step": loop_ms / max(self.steps, 1),
               "x_real_time": audio_s / wall_s,
               "voice_s_per_s": voices * audio_s / wall_s}
        out["other_wall_s"] = (wall_s - out["prime_wall_s"]
                               - self.wall["_collect"]
                               - out["layout_wall_s"])
        print(f"{label}: {audio_s:.2f} s of audio x {voices} voices in "
              f"{wall_s:.3f} s wall = {out['x_real_time']:.2f}x real time, "
              f"{out['voice_s_per_s']:.1f} voice-seconds per second; input "
              f"layout {out['layout_wall_s']:.3f} s, prime "
              f"{out['prime_wall_s']:.3f} s wall ({out['prime_device_ms']:.1f}"
              f" ms device), step loop {out['loop_wall_s']:.3f} s wall for "
              f"{self.steps} steps, {out['ms_per_step']:.3f} ms per step "
              f"(CUDA events), collection {out['collect_wall_s']:.3f} s, "
              f"the rest (upload, state, step inputs, output layout) "
              f"{out['other_wall_s']:.3f} s")
        return out


def check_bounce_golden(name, out, x, rows, ir, seg_len, nseg,
                        limit=1e-4):
    """Voices `rows` of a static bounce `out` [V, 2, T'] of `x` [V, 2, T]
    against the golden of IR `ir` (the zero input past T flushing the
    tail) over four blocks around every segment boundary, the first four
    blocks, and the last four input blocks with the whole tail. Returns
    the largest error; raises beyond `limit`."""
    t_out = out.shape[-1]
    t_blocks, out_blocks = -(-x.shape[-1] // BLOCK), -(-t_out // BLOCK)
    bounds = [s * seg_len for s in range(1, nseg) if s * seg_len < out_blocks]
    windows = ([(0, 4)] + [(b - 2, b + 2) for b in bounds]
               + [(t_blocks - 4, out_blocks)])
    worst = 0.0
    for v in rows:
        xe = np.zeros((2, t_out), np.float32)
        xe[:, : x.shape[-1]] = x[v]
        want = golden(xe, [ir, ir], wet=0.7, dry=0.2, predelay=1024)
        errs = [float(np.abs(out[v, :, b0 * BLOCK: b1 * BLOCK]
                             - want[:, b0 * BLOCK: b1 * BLOCK]).max())
                for b0, b1 in windows]
        worst = max(worst, *errs)
        print(f"{name} golden voice {v}: max_abs_err {max(errs):.3e} (limit "
              f"{limit:.0e}) over {len(windows)} windows: the head, the "
              f"segment boundaries at blocks {bounds} (worst "
              f"{max(errs[1:-1], default=0.0):.3e}), the tail from block "
              f"{t_blocks - 4} ({errs[-1]:.3e})")
        if not max(errs) <= limit:
            raise AssertionError(f"{name}: voice {v} disagrees with the golden")
    return worst


def run_bounce_static(bank, irs, dev, configure, reset_counts, rm, ms, rng):
    """Phase 16: ConvolutionReverb's defaults (ring, 'allk', KOD 16) at 64
    voices bounce 30 s of per-voice noise with auto segments, which must
    resolve to 8 (512 virtual voices), twice; every step must launch
    ring_mac and none mac_shift, the output must be finite and voices 0
    and 63 must match the golden at every segment boundary and over the
    tail. Then the bounce's steady step at 512 virtual voices (device busy,
    top ops) and at 64 (the auto-segment cost model), and ring_mac at the
    bounce's shape against plain, einsum and bound. Returns the figures."""
    import torch

    from tpu_audio_torch.engine.params import VoiceParams
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime import offline

    name = "bounce (static)"
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, max_predelay=8192, device=dev)
    engine, cp = model.engine, model.control
    if not engine.ring_mode or engine.mac_strategy != "allk":
        raise AssertionError(f"{name}: ring {engine.ring_mode}, "
                             f"{engine.mac_strategy}")
    configure(cp)
    x = voice_noise(VOICES, BOUNCE_SAMPLES, seed=1)
    t_blocks = -(-BOUNCE_SAMPLES // BLOCK)
    total = t_blocks + engine.history_blocks
    warmup = engine.prime_blocks
    nseg = offline._auto_segments(total, warmup, VOICES, 512)
    seg_len = -(-total // nseg)
    print(f"{name}: {t_blocks} blocks + {engine.history_blocks} of tail, "
          f"auto segments {nseg} ({VOICES * nseg} virtual voices), "
          f"{warmup} warm-up steps + {seg_len}")
    if nseg != BOUNCE_SEGMENTS:
        raise AssertionError(f"{name}: auto segments resolved to {nseg}")
    runs, outs = [], []
    for rep in range(BOUNCE_REPS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with BounceStages(offline) as stages:
            t0 = time.perf_counter()
            out = model.render_offline(x)
            wall = time.perf_counter() - t0
        launches, shifts = rm.ring_mac.launches, ms.mac_shift.launches
        run = stages.report(f"{name} take {rep + 1}", wall,
                            BOUNCE_SAMPLES / RATE, VOICES)
        run.update(launches=launches,
                   peak_mb=torch.cuda.max_memory_allocated() / 1e6)
        print(f"{name} take {rep + 1}: ring_mac launches {launches}, "
              f"mac_shift launches {shifts}, peak allocated "
              f"{run['peak_mb']:.1f} MB, output {out.shape}")
        if launches != warmup + seg_len or shifts or stages.steps != launches:
            raise AssertionError(f"{name}: ring_mac launched {launches} "
                                 f"times and mac_shift {shifts} in "
                                 f"{stages.steps} steps")
        if out.shape != (VOICES, 2, BOUNCE_SAMPLES
                         + engine.history_blocks * BLOCK):
            raise AssertionError(f"{name}: output shape {out.shape}")
        if not np.isfinite(out).all():
            raise AssertionError(f"{name}: non-finite output")
        runs.append(run)
        outs.append(out[[0, VOICES - 1]])
        del out
    takes = float(np.abs(outs[0] - outs[1]).max())
    print(f"{name}: take 1 against take 2, voices 0 and {VOICES - 1}: "
          f"max_abs_err {takes:.3e}")
    golden_err = check_bounce_golden(name, outs[0], x[[0, -1]], (0, 1),
                                     irs[0], seg_len, nseg)
    del outs
    torch.cuda.empty_cache()

    # the bounce's steady step at 512 virtual voices and at 64 voices
    vv = VOICES * nseg
    seng = offline._virtual_engine(engine, vv)
    host = cp.snapshot()
    params = VoiceParams(**{key: np.repeat(np.asarray(arr), nseg, axis=0)
                            for key, arr in vars(host).items()}).to(dev)
    state = seng.init_converged(model.spectra, params)
    xin = torch.randn((vv, 2, BLOCK), device=dev) * 0.01
    busy, ops, state = device_busy(seng.step_coef_steady, state,
                                   model.spectra, params, xin,
                                   label=f"bounce {vv}vv step_coef_steady")
    p50_vv, p99_vv, state = step_times(seng.step_coef_steady, state,
                                       model.spectra, params, xin, n=220)
    del state, xin
    base_params = cp.snapshot_device()
    state = engine.init_converged(model.spectra, base_params)
    xin = torch.randn((VOICES, 2, BLOCK), device=dev) * 0.01
    p50_64, p99_64, state = step_times(engine.step_coef_steady, state,
                                       model.spectra, base_params, xin, n=220)
    slope = (p50_vv - p50_64) / (vv - VOICES)
    what = "not measured" if busy is None else (
        f"device busy {busy:.1f} us in {ops:.1f} device ops")
    print(f"{name}: steady step at {vv} virtual voices p50 / p99 "
          f"{p50_vv:.3f} / {p99_vv:.3f} ms (CUDA events), {what}; at "
          f"{VOICES} voices {p50_64:.3f} / {p99_64:.3f} ms; cost model "
          f"{p50_64 - slope * VOICES:.3f} ms + {slope * 1e3:.3f} us per "
          f"virtual voice")
    pp = engine.pp
    del state, xin, model, engine, seng, params
    torch.cuda.empty_cache()

    # ring_mac at the bounce's shape: VI = 2 * 512 rows
    fdl = torch.tensor(rng.standard_normal((BLOCK + 1, 2 * vv, 2, pp),
                                           dtype=np.float32), device=dev)
    rhs2 = torch.tensor(rng.standard_normal((BLOCK + 1, 2, 2 * pp,
                                             4 * NUM_IRS), dtype=np.float32),
                        device=dev)
    mac_err = check_ring_mac(rm, fdl, rhs2, f"bounce {vv}vv")
    t = time_ring_mac(rm, fdl, rhs2)
    print(f"ring_mac timing [bounce {vv}vv F={BLOCK + 1} VI={2 * vv} "
          f"Pp={pp} KOD={4 * NUM_IRS}]: kernel {t['kernel'] * 1e3:.2f} us "
          f"({t['bytes'] / (t['kernel'] * 1e-3) / 1e9:.0f} GB/s, "
          f"{100 * t['bound'] / t['kernel']:.1f} % of the "
          f"{t['bound'] * 1e3:.2f} us bound by {t['bound_by']} on "
          f"{t['bytes'] / 1e9:.3f} GB), plain {t['plain'] * 1e3:.2f} us, "
          f"library {t['library'] * 1e3:.2f} us")
    del fdl, rhs2
    torch.cuda.empty_cache()
    return {"runs": runs, "golden_err": golden_err, "takes_err": takes,
            "nseg": nseg, "seg_len": seg_len, "warmup": warmup,
            "busy_us": busy, "ops": ops, "step_vv": (p50_vv, p99_vv),
            "step_64": (p50_64, p99_64), "mac_err": mac_err, "mac_ms": t,
            "launches": sum(r["launches"] for r in runs)}


def run_bounce_automated(bank, dev, configure, select, keep_sink,
                         reset_counts, rm, ms):
    """Phase 17: ConvolutionReverb's defaults at 64 voices bounce phase 4's
    re-select and interrupt and a mid-fade wet change, as a MidiSchedule
    over 800 blocks of per-voice noise (NoiseSource's, seed 0), whole and
    in chunks of 256 blocks; then the model's session streams the same
    timeline on the card. Both bounces must launch ring_mac once per step,
    equal the stream within 2e-5 of scale on every block and voice, and
    each other. Returns the figures."""
    import torch

    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime import offline
    from tpu_audio_torch.runtime.backends import WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    name = "bounce (automated)"
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, max_predelay=8192, device=dev)
    engine, cp = model.engine, model.control
    configure(cp)
    for v in range(VOICES):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=SELECT_CC,
                                            predelay=PREDELAY_CC,
                                            wet=AUTO_WET_CC))

    def timeline():
        return MidiSchedule([select(SELECT_AT, 32), select(INTERRUPT_AT, 64),
                             (AUTO_WET_AT, "",
                              bytes([0xB0, AUTO_WET_CC, AUTO_WET_VALUE]))])

    noise = np.random.default_rng(0)
    x = np.concatenate([(noise.standard_normal((VOICES, 2, BLOCK)) * 0.01
                         ).astype(np.float32) for _ in range(BLOCKS)],
                       axis=-1)
    total = BLOCKS + engine.history_blocks
    _, warmup, nseg, seg_len = offline._plan(
        engine, total, segments=None, warmup_blocks=None,
        max_virtual_voices=512)
    hist = engine.history_blocks
    _, c_warmup, c_nseg, c_seg_len = offline._plan(
        engine, hist + AUTO_CHUNK, segments=None, warmup_blocks=None,
        max_virtual_voices=512)
    chunks = -(-total // AUTO_CHUNK)
    figures = {}
    outs = {}
    for label, kwargs, want in (
            ("whole", {}, warmup + seg_len),
            (f"chunks of {AUTO_CHUNK}", {"track_chunk_blocks": AUTO_CHUNK},
             chunks * (c_warmup + c_seg_len))):
        reset_counts()
        with BounceStages(offline) as stages:
            t0 = time.perf_counter()
            outs[label] = model.render_offline(x, schedule=timeline(),
                                               **kwargs)
            wall = time.perf_counter() - t0
        launches, shifts = rm.ring_mac.launches, ms.mac_shift.launches
        figures[label] = stages.report(f"{name}, {label}", wall,
                                       BLOCKS * BLOCK / RATE, VOICES)
        figures[label]["launches"] = launches
        print(f"{name}, {label}: ring_mac launches {launches} (want {want}), "
              f"mac_shift launches {shifts}")
        if launches != want or shifts:
            raise AssertionError(f"{name}, {label}: ring_mac launched "
                                 f"{launches} times, mac_shift {shifts}")
        if not np.isfinite(outs[label]).all():
            raise AssertionError(f"{name}, {label}: non-finite output")
    print(f"{name}: whole bounce as {nseg} segments x {seg_len} + {warmup} "
          f"warm-up; chunks as {chunks} x ({c_nseg} segments x {c_seg_len} "
          f"+ {c_warmup})")

    sink = keep_sink(keep_all=True)
    session = model.session(WavSource(x, VOICES, BLOCK), sink)
    reset_counts()
    t0 = time.perf_counter()
    session.run(model.init_state(), midi=timeline())
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = rm.ring_mac.launches
    streamed = sink.data()
    print(f"{name}: the session streamed {session.blocks_streamed} blocks in "
          f"{stream_s:.3f} s (ring_mac launches {stream_launches}, indexed "
          f"blocks {session.indexed_blocks}), selects {cp.select[0].tolist()},"
          f" wet {cp.wet[0].tolist()}")
    if (session.blocks_streamed != BLOCKS or sink.blocks != BLOCKS
            or session.indexed_blocks < 20 or not sink.finite):
        raise AssertionError(f"{name}: the session streamed "
                             f"{session.blocks_streamed} blocks, "
                             f"{session.indexed_blocks} indexed")
    scale = float(np.abs(streamed).max())
    whole, chunked = outs["whole"], outs[f"chunks of {AUTO_CHUNK}"]
    err = float(np.abs(whole[..., : BLOCKS * BLOCK] - streamed).max())
    chunk_err = float(np.abs(chunked - whole).max())
    print(f"{name}: bounce against the session over {BLOCKS} blocks x "
          f"{VOICES} voices: max_abs_err {err:.3e}; chunked against whole "
          f"over {whole.shape[-1] // BLOCK} blocks: {chunk_err:.3e} (limit "
          f"{2e-5 * scale:.3e} = 2e-5 of scale {scale:.3f})")
    if not err <= 2e-5 * scale:
        raise AssertionError(f"{name}: the bounce disagrees with the session")
    if chunked.shape != whole.shape or not chunk_err <= 2e-5 * scale:
        raise AssertionError(f"{name}: the chunked bounce disagrees with "
                             f"the whole bounce")
    del model, session, sink
    torch.cuda.empty_cache()
    return {"figures": figures, "stream_err": err, "chunk_err": chunk_err,
            "stream_s": stream_s,
            "launches": sum(f["launches"] for f in figures.values())}


def run_bounce_engines(bank, irs, dev, configure, reset_counts, rm, ms,
                       rng):
    """Phase 18: the cascade (ConvolutionReverb(engine='cascade'), ratio
    16) bounces 10 s of per-voice noise at 64 voices with auto segments,
    two ring_mac launches per step, and a roll-mode engine (ring=False,
    'allk') at 4 segments, every step on mac_shift; both against the
    golden on voices 0 and 63. mac_shift is first held against its plain
    version at the roll bounce's shape, ring_mac at the cascade bounce's
    two. Returns the figures."""
    import types

    import torch

    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime import offline

    x = voice_noise(VOICES, ENGINE_SAMPLES, seed=2)
    t_blocks = -(-ENGINE_SAMPLES // BLOCK)
    out = {}

    cas = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                            sample_rate=RATE, engine="cascade",
                            max_predelay=8192, cascade_ratio=CAS_RATIO,
                            device=dev)
    roll = FMajorPartitionedConvolution(
        VOICES, BLOCK, bank.max_partitions(BLOCK), max_predelay=8192,
        ring=False, mac_strategy="allk", num_irs=NUM_IRS, device=dev)
    roll_cp = ControlPlane(VOICES, NUM_IRS, 8192, device=dev)
    roll_model = types.SimpleNamespace(
        engine=roll, spectra=roll.prepare_bank(bank.partitioned_spectra(BLOCK)),
        control=roll_cp)
    for label, model, segments, kernel in (
            ("cascade", cas, None, "ring_mac"),
            ("roll", roll_model, ROLL_SEGMENTS, "mac_shift")):
        name = f"bounce ({label})"
        engine = model.engine
        configure(model.control)
        fast = hasattr(engine, "prime_fdl")
        warmup = engine.prime_blocks if fast else engine.history_blocks
        total = t_blocks + engine.history_blocks
        nseg = segments or offline._auto_segments(total, warmup, VOICES, 512)
        seg_len = -(-total // nseg)
        vv = VOICES * nseg
        # the kernel at the shapes this bounce gives it
        if label == "cascade":
            mac_err = 0.0
            for stage, (f, vi, pp) in (
                    ("head", (BLOCK + 1, 2 * vv, CAS_PP1)),
                    ("tail", (CAS_RATIO * BLOCK + 1, 2 * vv // CAS_RATIO,
                              CAS_PP2))):
                fdl = torch.tensor(rng.standard_normal(
                    (f, vi, 2, pp), dtype=np.float32), device=dev)
                rhs2 = torch.tensor(rng.standard_normal(
                    (f, 2, 2 * pp, 4 * NUM_IRS), dtype=np.float32), device=dev)
                mac_err = max(mac_err, check_ring_mac(
                    rm, fdl, rhs2, f"cascade bounce {vv}vv {stage}"))
                del fdl, rhs2
        else:
            f, vi, pp = BLOCK + 1, 2 * vv, roll.pp
            fdl = torch.tensor(rng.standard_normal((f, vi, 2, pp),
                                                   dtype=np.float32),
                               device=dev)
            xn = torch.tensor(rng.standard_normal((f, vi, 2, 1),
                                                  dtype=np.float32),
                              device=dev)
            rhs = torch.tensor(rng.standard_normal((f, 2, pp, 4 * NUM_IRS),
                                                   dtype=np.float32),
                               device=dev)
            shift64, ref64 = ms.mac_shift_reference(fdl.double(), xn.double(),
                                                    rhs.double())
            got_fdl, got = ms.mac_shift(fdl, xn, rhs)
            torch.cuda.synchronize()
            same = torch.equal(got_fdl.double(), shift64)
            scale = ref64.abs().max().item()
            mac_err = (got.double() - ref64).abs().max().item()
            print(f"mac_shift vs plain [roll bounce {vv}vv F={f} VI={vi} "
                  f"Pp={pp} KOD={4 * NUM_IRS}]: shifted line "
                  f"{'bit-identical' if same else 'DIFFERS'}, m max_abs_err "
                  f"{mac_err:.3e} (limit {1e-5 * scale:.3e})")
            if not same or not mac_err <= 1e-5 * scale:
                raise AssertionError("mac_shift disagrees with the plain "
                                     "version at the roll bounce's shape")
            del fdl, xn, rhs, shift64, ref64, got_fdl, got
        torch.cuda.empty_cache()

        reset_counts()
        with BounceStages(offline) as stages:
            t0 = time.perf_counter()
            got = offline.render_offline(model, x, segments=segments)
            wall = time.perf_counter() - t0
        counts = {"ring_mac": rm.ring_mac.launches,
                  "mac_shift": ms.mac_shift.launches}
        figures = stages.report(name, wall, ENGINE_SAMPLES / RATE, VOICES)
        steps = warmup + seg_len
        want = {"ring_mac": 2 * steps if label == "cascade" else 0,
                "mac_shift": steps if label == "roll" else 0}
        print(f"{name}: {nseg} segments ({vv} virtual voices) x {seg_len} + "
              f"{warmup} warm-up steps; launches {counts} (want {want})")
        if counts != want or stages.steps != steps:
            raise AssertionError(f"{name}: launches {counts} in "
                                 f"{stages.steps} steps")
        if not np.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite output")
        figures.update(
            launches=counts[kernel], mac_err=mac_err, nseg=nseg,
            golden_err=check_bounce_golden(
                name, got[[0, VOICES - 1]], x[[0, -1]], (0, 1), irs[0],
                seg_len, nseg))
        out[label] = figures
        del got
        torch.cuda.empty_cache()
    del cas, roll, roll_model
    torch.cuda.empty_cache()
    return out


def _model_factory(bank, dev, configure, **kwargs):
    """A zero-arg factory of phase 19's (or, with engine='cascade', phase
    20's) model: ConvolutionReverb at 64 voices over `bank`, configured as
    phase 4, with the wet CC of phase 17 mapped too."""
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb

    def build():
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, max_predelay=8192,
                                  device=dev, **kwargs)
        configure(model.control)
        for v in range(VOICES):
            for ch in range(2):
                model.control.set_mapping(v, ch, CCMapping(
                    message=0xB0, select=SELECT_CC, predelay=PREDELAY_CC,
                    wet=AUTO_WET_CC))
        return model

    return build


def run_recovery(name, build, x, timeline, every, fails, keep_sink,
                 reset_counts, rm, per_block):
    """Stream `x` [V, 2, T] through a model of `build()` uninterrupted,
    then through run_resilient with a checkpoint every `every` blocks and a
    sink that fails once when each block index of `fails` is delivered.
    Both runs must launch ring_mac `per_block` times for every block they
    step (replays included); the recovered output must equal the
    uninterrupted one within 1e-6 of its scale. Returns the figures and
    both outputs."""
    import tempfile

    import torch

    from tpu_audio_torch.runtime.backends import WavSource
    from tpu_audio_torch.runtime.recovery import run_resilient

    class CountingSource(WavSource):
        """A seekable in-memory source that counts the blocks it hands
        out: every one of them is stepped."""

        reads = 0

        def read(self):
            blk = super().read()
            self.reads += blk is not None
            return blk

    class FailingSink(keep_sink):
        def __init__(self):
            super().__init__(keep_all=True)
            self.fails = list(fails)

        def write(self, block):
            if self.fails and self.blocks == self.fails[0]:
                self.fails.pop(0)
                raise RuntimeError(f"simulated transport failure at "
                                   f"delivered block {self.blocks}")
            super().write(block)

    blocks = x.shape[-1] // BLOCK
    src = CountingSource(x, VOICES, BLOCK)
    want = keep_sink(keep_all=True)
    model = build()
    session = model.session(src, want)
    reset_counts()
    t0 = time.perf_counter()
    session.run(model.init_state(), midi=timeline())
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = rm.ring_mac.launches
    if (plain_launches != per_block * src.reads or src.reads != blocks
            or want.blocks != blocks):
        raise AssertionError(f"{name}: uninterrupted run stepped "
                             f"{src.reads} blocks, delivered {want.blocks}, "
                             f"ring_mac launches {plain_launches}")
    del model, session
    torch.cuda.empty_cache()

    builds = []

    def counting_build():
        builds.append(1)
        return build()

    src = CountingSource(x, VOICES, BLOCK)
    sink = FailingSink()
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        _, summary = run_resilient(counting_build, src, sink,
                                   f"{tmp}/session.ckpt",
                                   checkpoint_every=every, midi=timeline())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = rm.ring_mac.launches
    resumes = [r["resume_block"] for r in summary["recoveries"]]
    saves = summary["checkpoint_saves"]
    print(f"{name}: uninterrupted {blocks} blocks in {plain_s:.3f} s; "
          f"resilient run {wall:.3f} s wall, {summary['restarts']} restarts "
          f"(resumed from {resumes}), {len(builds)} model builds, "
          f"{src.reads} blocks stepped, ring_mac launches {launches} (want "
          f"{per_block} x {src.reads}), delivered "
          f"{summary['blocks_delivered']}")
    for r in summary["recoveries"]:
        print(f"{name}: failure at delivered block {r['delivered']}: "
              f"rebuild {r['rebuild_s']:.3f} s, load {r['load_s']:.3f} s, "
              f"resume from block {r['resume_block']}")
    missed = 0
    for s in saves:
        late = s["block_s"] > BLOCK / RATE
        missed += late
        print(f"{name}: save at block {s['block_index']}: "
              f"{s['bytes'] / 1e6:.1f} MB, device-to-host "
              f"{s['d2h_s'] * 1e3:.1f} ms, file write "
              f"{s['write_s'] * 1e3:.1f} ms, its block "
              f"{s['block_s'] * 1e3:.1f} ms ({'missed' if late else 'met'} "
              f"the {DEADLINE_MS:.3f} ms deadline)")
    got, ref = sink.data(), want.data()
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) if got.shape == ref.shape else 1e9
    print(f"{name}: recovered against uninterrupted over {blocks} blocks x "
          f"{VOICES} voices: max_abs_err {err:.3e} (limit {1e-6 * scale:.3e} "
          f"= 1e-6 of scale {scale:.3f}); bit-identical: {err == 0.0}")
    want_resumes = [(f - 1) // every * every for f in fails]
    if (summary["restarts"] != len(fails) or len(builds) != len(fails) + 1
            or resumes != want_resumes or sink.blocks != blocks
            or summary["blocks_delivered"] != blocks):
        raise AssertionError(f"{name}: restarts {summary['restarts']}, "
                             f"resumes {resumes} (want {want_resumes}), "
                             f"delivered {sink.blocks}")
    if launches != per_block * src.reads or src.reads <= blocks:
        raise AssertionError(f"{name}: ring_mac launched {launches} times in "
                             f"{src.reads} stepped blocks")
    if not sink.finite or not err <= 1e-6 * scale:
        raise AssertionError(f"{name}: the recovered output disagrees with "
                             f"the uninterrupted run")
    figures = {"launches": plain_launches + launches, "err": err,
               "exact": err == 0.0, "restarts": summary["restarts"],
               "stepped": src.reads, "wall_s": wall, "plain_s": plain_s,
               "save_MB": saves[0]["bytes"] / 1e6,
               "save_d2h_ms": [s["d2h_s"] * 1e3 for s in saves],
               "save_write_ms": [s["write_s"] * 1e3 for s in saves],
               "save_block_ms": [s["block_s"] * 1e3 for s in saves],
               "saves_missed": missed,
               "rebuild_s": [r["rebuild_s"] for r in summary["recoveries"]],
               "load_s": [r["load_s"] for r in summary["recoveries"]]}
    return figures, got


def run_checkpoint_phases(bank, irs, dev, configure, select, keep_sink,
                          reset_counts, rm, ms):
    """Phases 19 and 20: run_resilient at full width against the
    uninterrupted run, fmajor ring/allk (two failures) then the cascade
    (one). Returns the figures."""
    from tpu_audio_torch.runtime.stream import MidiSchedule

    x = voice_noise(VOICES, BLOCKS * BLOCK, seed=0)
    wet = AUTO_WET_VALUE / 128

    def timeline():
        return MidiSchedule([select(SELECT_AT, 32), select(INTERRUPT_AT, 64),
                             (REC_WET_AT, "",
                              bytes([0xB0, AUTO_WET_CC, AUTO_WET_VALUE]))])

    out = {}
    build = _model_factory(bank, dev, configure)
    out["ring"], got = run_recovery(
        "recovery (ring)", build, x, timeline, REC_EVERY, REC_FAILS,
        keep_sink, reset_counts, rm, 1)
    out["ring"]["golden_err"] = check_golden(
        "recovery (ring)", got[[0, VOICES - 1]], x[[0, -1]],
        (("before the re-selects, IR 0", 0, SELECT_AT, irs[0]),
         (f"after the fades and the wet change, IR 2, wet {wet}", 500,
          BLOCKS, irs[2], wet)),
        predelay=1024)
    if ms.mac_shift.launches:
        raise AssertionError("recovery: mac_shift launched")
    del got

    def cas_timeline():
        return MidiSchedule([select(b, v) for b, v in CAS_REC_SELECTS])

    build = _model_factory(bank, dev, configure, engine="cascade",
                              cascade_ratio=CAS_RATIO)
    out["cascade"], _ = run_recovery(
        "recovery (cascade)", build, x[..., :CAS_REC_BLOCKS * BLOCK],
        cas_timeline, CAS_REC_EVERY, (CAS_REC_FAIL,), keep_sink,
        reset_counts, rm, 2)
    return out


def run_live_path(bank, irs, dev, configure, select, reset_counts, rm):
    """Phase 21: the live path in one process at full width. A producer
    thread writes LIVE_BLOCKS blocks of per-voice noise into a shm
    NativeRing, paced by a NativeBlockClock at the block period; the
    session reads it through RingSource (blocking, underruns silenced),
    realtime on the native clock, and writes through RingSink into a second
    ring that a consumer thread drains; MIDI arrives through a FIFO read by
    MidiByteStream. Returns the figures."""
    import os
    import tempfile
    import threading

    import torch

    from tpu_audio_torch.runtime import native
    from tpu_audio_torch.runtime.midi_transport import MidiByteStream

    if not native.native_available():
        raise AssertionError("live path: the native library did not build")
    period = BLOCK / RATE
    n = VOICES * 2 * BLOCK
    noise = np.random.default_rng(5)
    blocks = (noise.standard_normal((LIVE_BLOCKS, VOICES, 2, BLOCK),
                                    dtype=np.float32) * 0.01)
    tag = f"{os.getpid()}_{time.monotonic_ns() % 10 ** 9}"
    ring_in = native.NativeRing(LIVE_RING_BLOCKS * n,
                                shm_name=f"/tpuaudio_smoke_in_{tag}")
    ring_out = native.NativeRing(LIVE_RING_BLOCKS * n,
                                 shm_name=f"/tpuaudio_smoke_out_{tag}")
    t_write, t_read, consumed = [], [], []
    produced = [0]

    done = threading.Event()

    # the producer and the consumer stand in for other processes: they
    # poll the rings' fill levels (one C call, no allocation) every 0.5 ms
    # and take the GIL only to move a block
    def produce():
        clock = native.NativeBlockClock(period)
        for blk in blocks:
            while not ring_in.write(blk):
                if done.is_set():
                    return
                time.sleep(0.0005)
            t_write.append(time.perf_counter())
            produced[0] += 1
            clock.wait()
        clock.close()

    def consume():
        while len(consumed) < LIVE_BLOCKS and not done.is_set():
            data = ring_out.read(n)
            if data is None:
                time.sleep(0.0005)
                continue
            t_read.append(time.perf_counter())
            consumed.append(data.reshape(VOICES, 2, BLOCK)[[0, -1]].copy())

    class RecordingSource(native.RingSource):
        """Keeps voices 0 and 63 of every block the session read (a
        silenced underrun is read as None and recorded as zeros) and which
        producer block each session block carried."""

        def __init__(self):
            super().__init__(ring_in, VOICES, BLOCK, blocking=True)
            self.rows, self.carried, self.real = [], [], 0

        def read(self):
            blk = super().read()
            if blk is None:
                self.rows.append(np.zeros((2, 2, BLOCK), np.float32))
                self.carried.append(None)
            else:
                self.rows.append(blk[[0, -1]].copy())
                self.carried.append(self.real)
                self.real += 1
            return blk

    class RecordingSink(native.RingSink):
        """Keeps voices 0 and 63 of every block the session delivered."""

        def __init__(self):
            super().__init__(ring_out)
            self.rows = []

        def write(self, block):
            self.rows.append(block[[0, -1]].copy())
            super().write(block)

    class RecordingMidi:
        def __init__(self, stream):
            self.stream, self.polls, self.applied = stream, 0, []

        def poll(self):
            events = self.stream.poll()
            if events:
                self.applied.append((self.polls, events))
            self.polls += 1
            return events

    build = _model_factory(bank, dev, configure)
    model = build()
    source, sink = RecordingSource(), RecordingSink()
    with tempfile.TemporaryDirectory() as tmp:
        fifo = f"{tmp}/midi.fifo"
        os.mkfifo(fifo)
        stream = MidiByteStream(fifo)
        midi = RecordingMidi(stream)
        sent = {}

        def send_midi():
            fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            for near, message in (
                    (LIVE_SELECT_NEAR, select(0, 32)[2]),
                    (LIVE_WET_NEAR, bytes([0xB0, AUTO_WET_CC,
                                           AUTO_WET_VALUE]))):
                while produced[0] < near and not done.is_set():
                    time.sleep(0.001)
                os.write(fd, message)
                sent[near] = produced[0]
            os.close(fd)

        threads = [threading.Thread(target=f, daemon=True)
                   for f in (produce, consume, send_midi)]
        session = model.session(source, sink, realtime=True, clock="native",
                                underrun_policy="silence")
        # host seconds of each part of a live block, per call
        parts = {}

        def timed(what, fn):
            def call(*args, **kwargs):
                t1 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    parts.setdefault(what, []).append(
                        time.perf_counter() - t1)
            return call

        for obj, attr, what in (
                (source, "read", "ring read"), (midi, "poll", "midi poll"),
                (session, "_maybe_collapse", "collapse"),
                (session, "_upload", "upload"),
                (session, "_step_steady", "step"),
                (session, "_step_indexed", "step"),
                (session, "_start_fetch", "fetch"),
                (session, "_deliver", "deliver"),
                (model.control, "snapshot_device", "params"),
                (model.control, "end_block", "end_block")):
            setattr(obj, attr, timed(what, getattr(obj, attr)))
        open_clock = session._open_clock

        def timed_clock():
            clock = open_clock()
            if clock is not None:
                clock.wait = timed("clock wait", clock.wait)
            return clock

        session._open_clock = timed_clock
        # the producer starts with the session's first block
        session.pre_run_hooks.append(lambda: [t.start() for t in threads])
        reset_counts()
        t0 = time.perf_counter()
        try:
            session.run(model.init_state(), max_blocks=LIVE_BLOCKS,
                        live_midi=midi)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            deadline = time.time() + 30
            while len(consumed) < LIVE_BLOCKS and time.time() < deadline:
                time.sleep(0.01)
        finally:
            done.set()
            for t in threads:
                t.join(timeout=30)
            stream.close()
            ring_in.close(unlink=True)
            ring_out.close(unlink=True)
    launches = rm.ring_mac.launches
    s = session.summary()
    native_framer = isinstance(stream.framer, native.NativeMidiFramer)
    print(f"live path: {session.blocks_streamed} blocks in {wall:.3f} s, "
          f"consumer got {len(consumed)}, ring_mac launches {launches}, "
          f"underruns {session.underruns}, dropped {sink.dropped}, clock "
          f"{session.clock_used} (ticks {session.clock_ticks}, missed "
          f"{session.clock_missed}), framer "
          f"{type(stream.framer).__name__}, MIDI sent near {sent}, applied "
          f"at {[(b, len(e)) for b, e in midi.applied]}")
    if (session.blocks_streamed != LIVE_BLOCKS or len(consumed) != LIVE_BLOCKS
            or launches != LIVE_BLOCKS or sink.dropped):
        raise AssertionError("live path: blocks lost or a block without "
                             "ring_mac")
    if session.clock_used != "native" or not native_framer:
        raise AssertionError("live path: the native clock or framer was not "
                             "the one in use")
    if not all(np.array_equal(a, b) for a, b in zip(consumed, sink.rows)):
        raise AssertionError("live path: the consumer's blocks differ from "
                             "the session's, or came out of order")
    if len(midi.applied) != 2:
        raise AssertionError(f"live path: MIDI applied {midi.applied}")
    sel_at, wet_at = (b for b, _ in midi.applied)
    x = np.concatenate(source.rows, axis=-1)
    out = np.concatenate(consumed, axis=-1)
    golden_err = check_golden(
        "live path", out, x,
        (("before the select, IR 0", 0, sel_at, irs[0]),
         ("after its fade, IR 1", sel_at + 150, wet_at, irs[1])),
        predelay=1024)
    split = {what: 1e3 * float(np.sum(t[10:])) / (len(t) - 10)
             for what, t in parts.items()}
    print("live path: host ms per block after warm-up: "
          + ", ".join(f"{what} {v:.3f}" for what, v in split.items()))
    # latency: producer write of a block -> consumer read of its output
    lat = np.array([t_read[b] - t_write[k]
                    for b, k in enumerate(source.carried) if k is not None])
    print(f"live path: p50 {s['p50_ms']:.3f} ms, p99 {s['p99_ms']:.3f} ms "
          f"per block, rtf {s['rtf']:.2f}, missed deadlines "
          f"{s['missed_deadlines']}; producer write -> consumer read p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms "
          f"({np.percentile(lat, 50) / period:.2f} blocks), p99 "
          f"{np.percentile(lat, 99) * 1e3:.3f} ms "
          f"({np.percentile(lat, 99) / period:.2f} blocks)")
    figures = {"launches": launches, "summary": s, "wall_s": wall,
               "golden_err": golden_err, "underruns": session.underruns,
               "split": split,
               "clock_ticks": session.clock_ticks,
               "clock_missed": session.clock_missed,
               "select_applied_block": sel_at, "wet_applied_block": wet_at,
               "latency_p50_ms": float(np.percentile(lat, 50)) * 1e3,
               "latency_p99_ms": float(np.percentile(lat, 99)) * 1e3,
               "latency_p50_blocks": float(np.percentile(lat, 50)) / period,
               "latency_p99_blocks": float(np.percentile(lat, 99)) / period}
    del model, session
    torch.cuda.empty_cache()
    return figures


def run_cli_bridge(irs):
    """Phase 22: the CLI behind the C JACK bridge. The stub jackd
    (csrc/jackstub.cpp) and the C bridge (csrc/jackbridge.cpp) are built
    into tpu_audio_torch/_build; `python -m tpu_audio_torch.app --voices 1`
    serves a 4 s IR from shm rings, realtime on the native clock, with a
    live MIDI FIFO, while the bridge moves the stub's capture periods in
    and its playback periods out. The app warms its steps up before it
    creates the rings and queues its default --output-latency of 4 silent
    blocks ahead of the first output block. Returns the figures."""
    import os
    import re
    import tempfile
    import threading

    from tpu_audio_torch.io.wav import write_wav
    from tpu_audio_torch.runtime import native

    stub, bridge = native.jack_stub_path(), native.bridge_path()
    if stub is None or bridge is None:
        raise AssertionError("CLI bridge: the stub jackd or the C bridge "
                             "did not build")
    tag = f"{os.getpid()}_{time.monotonic_ns() % 10 ** 9}"
    in_name, out_name = f"/tpuaudio_cli_in_{tag}", f"/tpuaudio_cli_out_{tag}"
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = []
    # (seconds, output ring fill, input ring backlog), in blocks, sampled
    # every millisecond from a second mapping of the app's rings
    samples, sampling = [], threading.Event()

    def sample_rings():
        rings = [native.NativeRing.open(name) for name in (out_name, in_name)]
        try:
            while not sampling.is_set():
                samples.append((time.perf_counter(),
                                rings[0].readable // (2 * BLOCK),
                                rings[1].readable // (2 * BLOCK)))
                time.sleep(0.001)
        finally:
            for ring in rings:
                ring.close()

    sampler = threading.Thread(target=sample_rings, daemon=True)
    with tempfile.TemporaryDirectory() as tmp:
        write_wav(f"{tmp}/ir.wav", irs[0].T, RATE, bits=32)
        with open(f"{tmp}/bank.index", "w") as fh:
            fh.write("ir.wav\n")
        with open(f"{tmp}/settings.txt", "w") as fh:
            fh.write("conv.count 2\n" + "".join(
                f"conv[{i}].index bank.index\nconv[{i}].cc.message 176\n"
                f"conv[{i}].cc.wet {AUTO_WET_CC}\nconv[{i}].value.wet 0.7\n"
                f"conv[{i}].value.dry 0.2\n" for i in range(2)))
        fifo, dump = f"{tmp}/midi.fifo", f"{tmp}/playback.f32"
        os.mkfifo(fifo)
        # the debug level logs each block that missed its deadline (the
        # session's "missed deadline at block N" line), so a gap in the
        # playback can be matched to the block that emptied the ring
        env = dict(os.environ, TPU_AUDIO_LOG="debug",
                   PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        t0 = time.perf_counter()
        try:
            app = subprocess.Popen(
                [sys.executable, "-m", "tpu_audio_torch.app", "--settings",
                 f"{tmp}/settings.txt", "--root", tmp, "--voices", "1",
                 "--input-ring", in_name, "--output-ring", out_name,
                 "--realtime", "--clock", "native", "--midi-fifo", fifo,
                 "--blocks", str(CLI_BLOCKS), "--max-dry-blocks", "50",
                 "--block-size", str(BLOCK),
                 "--sample-rate", str(RATE)],
                env=env, cwd=tmp, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            procs.append(app)
            deadline = time.time() + 600
            while True:   # the app creates both rings, then opens the FIFO
                try:
                    fd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
                    break
                except OSError:
                    if app.poll() is not None or time.time() > deadline:
                        raise AssertionError(f"CLI bridge: the app never "
                                             f"opened its FIFO: "
                                             f"{app.communicate()}")
                    time.sleep(0.02)
            ready_s = time.perf_counter() - t0
            sampler.start()
            jack = subprocess.Popen(
                [bridge, "--in-ring", in_name, "--out-ring", out_name,
                 "--expect-block", str(BLOCK), "--expect-rate", str(RATE),
                 "--max-seconds", "120"],
                env=dict(os.environ, TPU_AUDIO_LIBJACK=stub,
                         JACK_STUB_BLOCK=str(BLOCK), JACK_STUB_RATE=str(RATE),
                         JACK_STUB_PERIODS=str(STUB_PERIODS),
                         JACK_STUB_PERIOD_US=str(STUB_PERIOD_US),
                         JACK_STUB_DUMP=dump, JACK_STUB_RAISE_ON_DONE="1"),
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            procs.append(jack)
            time.sleep(1.0)
            os.write(fd, bytes([0xB0, AUTO_WET_CC, 40]))
            os.close(fd)
            app_out, app_err = app.communicate(timeout=300)
            app_s = time.perf_counter() - t0
            jack_out, jack_err = jack.communicate(timeout=120)
        finally:
            sampling.set()
            if sampler.is_alive():
                sampler.join()
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        played = np.fromfile(dump, np.float32)
    summary = re.search(r"streamed (\d+) blocks.*", app_out)
    late = [(int(b), float(t)) for b, t in re.findall(
        r"missed deadline at block (\d+): ([\d.]+) ms", app_out)]
    warm = re.search(r"warmed up in ([\d.]+) s", app_out)
    print(f"CLI bridge: app warmed up in "
          f"{float(warm.group(1)) if warm else float('nan'):.3f} s")
    print(f"CLI bridge: app ready (rings and FIFO) after {ready_s:.2f} s, "
          f"exited {app.returncode} after {app_s:.2f} s: "
          f"{summary.group(0) if summary else app_out.strip()[-400:]} "
          f"{app_err.strip()[-400:]}")
    print(f"CLI bridge: C bridge exited {jack.returncode}: "
          f"{jack_out.strip()} {jack_err.strip()[-300:]}")
    stats = re.search(r"periods=(\d+) underruns=(\d+) overruns=(\d+)",
                      jack_out)
    if (app.returncode != 0 or not summary
            or int(summary.group(1)) != CLI_BLOCKS):
        raise AssertionError("CLI bridge: the app failed")
    if jack.returncode != 0 or not stats:
        raise AssertionError("CLI bridge: the C bridge failed")
    periods, underruns, overruns = map(int, stats.groups())
    played = played[: periods * 2 * BLOCK].reshape(periods, 2, BLOCK)
    peak = np.abs(played).max(axis=(1, 2))
    sounding = np.flatnonzero(peak > 1e-3)
    first = int(sounding[0]) if sounding.size else periods
    # from the app's first output period on, its blocks play without a gap
    body = peak[first: first + CLI_BLOCKS - 100]
    print(f"CLI bridge: {periods} periods played, {underruns} underruns, "
          f"{overruns} overruns; playback finite "
          f"{bool(np.isfinite(played).all())}, first sounding period "
          f"{first}, the next {body.size} periods non-silent "
          f"{int((body > 1e-3).sum())}, peak {float(peak.max()):.3f}")
    silent = (first + np.flatnonzero(body <= 1e-3)).tolist()
    # the fill over the 900 periods after the app's first output block:
    # the consumer's blocks in hand, what keeps a late block from a gap
    ring_fill = None
    at = np.array(samples, np.float64).reshape(-1, 3)
    queued = np.flatnonzero(at[:, 1] > 0)
    if queued.size:
        t1 = at[queued[0], 0]
        win = at[(at[:, 0] >= t1)
                 & (at[:, 0] < t1 + (CLI_BLOCKS - 100) * BLOCK / RATE)]
        ring_fill = {"out_min": int(win[:, 1].min()),
                     "out_median": float(np.median(win[:, 1])),
                     "out_max": int(win[:, 1].max()),
                     "in_max": int(win[:, 2].max()), "samples": len(win)}
    print(f"CLI bridge: rings over the 900 periods after the first output "
          f"block (blocks, {len(samples)} samples ~1 ms apart): {ring_fill}")
    print(f"CLI bridge: {len(late)} blocks missed their deadline (block, ms): "
          f"{[(b, round(t, 2)) for b, t in late][:40]}")
    if silent:
        # a silent period p plays app block ~p - first: the late blocks
        # just before it emptied the output ring
        print(f"CLI bridge: silent periods {silent[:40]} (app block ~ "
              f"period - {first}: {[p - first for p in silent[:40]]})")
    if (not np.isfinite(played).all() or first > 300
            or body.size != CLI_BLOCKS - 100 or not (body > 1e-3).all()):
        raise AssertionError("CLI bridge: the playback is not finite or has "
                             "silent periods")
    return {"periods": periods, "underruns": underruns, "overruns": overruns,
            "first_sounding_period": first, "app_s": app_s,
            "ready_s": ready_s, "summary": summary.group(0),
            "warm_up_s": float(warm.group(1)) if warm else None,
            "ring_fill": ring_fill,
            "late_blocks": len(late)}


def slew_weights(blocks, events, num_irs, wet, speed):
    """The share of each IR in the monolithic engine's active spectra at
    every block, [blocks, K] in float64, wet included: the reference's slew
    (src/conv.cu:15-32) replayed on the host from a settled IR 0, with
    `events` {block: new IR} reloading the countdown to `speed`."""
    g = np.zeros(num_irs)
    g[0] = wet
    sel, vsteps = 0, 0
    out = np.zeros((blocks, num_irs))
    for t in range(blocks):
        if t in events:
            sel, vsteps = events[t], speed
        target = np.zeros(num_irs)
        target[sel] = wet
        g = g + (target - g) / (vsteps + 5.0)
        out[t] = g
        vsteps = max(vsteps - 1, 0)
    return out


def golden_mixed(x, irs, weights, dry, predelay):
    """float64 golden of an input-synchronous engine whose IR changes: each
    input block convolves with the mix sum_k weights[block, k] * irs[k] it
    met on arrival (wet folded into the weights), the wet sum delayed by
    `predelay` and clamped, the dry mix added after (centre pans, unit
    level)."""
    from scipy.signal import fftconvolve

    t = x.shape[-1]
    w = np.repeat(weights, BLOCK, axis=0)[:t]                  # [T, K]
    out = np.zeros((2, t))
    for o in range(2):
        acc = np.zeros(t)
        for k, ir in enumerate(irs):
            if not w[:, k].any():
                continue
            for i in range(2):
                conv = fftconvolve(x[i].astype(np.float64) * w[:, k],
                                   ir[o].astype(np.float64))[:t]
                acc[predelay:] += conv[: t - predelay]
        out[o] = np.clip(acc, -1.0, 1.0) + (x[0] + x[1]) * dry
    return out


def engine_timings(name, steps, state, bank, params, xt):
    """CUDA-event p50/p99 ms and device busy per call of each of `steps`
    ({label: step}), threaded through one state. Returns ({label: (p50,
    p99, busy_us, ops)}, state)."""
    out = {}
    for label, step in steps.items():
        p50, p99, state = step_times(step, state, bank, params, xt, n=220)
        busy, ops, state = device_busy(step, state, bank, params, xt,
                                       label=f"{name} {label}")
        out[label] = (p50, p99, busy, ops)
        what = ("device busy not measured" if busy is None else
                f"device busy {busy:.1f} us in {ops:.1f} device ops")
        print(f"{name} {label} step: p50 / p99 {p50:.3f} / {p99:.3f} ms "
              f"(CUDA events), {what}")
    return out, state


def run_engine_session(name, model, configure, select, keep_sink,
                       reset_counts, rm, ms, amplitude, keep_all=False):
    """One ENG_BLOCKS-block session of phases 23-24 at 64 voices: phase 4's
    re-select and interrupt over NoiseSource noise at `amplitude`. Neither
    MAC kernel may launch; every block must be delivered and finite.
    Returns (session, sink, state, run seconds, peak MB)."""
    import torch

    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    configure(model.control)
    sink = keep_sink(keep_all=keep_all)
    session = model.session(NoiseSource(VOICES, BLOCK, ENG_BLOCKS,
                                        amplitude=amplitude, seed=0), sink)
    state = model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=MidiSchedule([select(SELECT_AT, 32),
                                                  select(INTERRUPT_AT, 64)]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    s = session.summary()
    print(f"{name}: {session.blocks_streamed} blocks in {run_s:.3f} s, p50 / "
          f"p99 {s['p50_ms']:.3f} / {s['p99_ms']:.3f} ms per block, RTF "
          f"{s['rtf']:.2f}, missed {s['missed_deadlines']} of {s['blocks']}, "
          f"general blocks {session.general_blocks}, ring_mac / mac_shift "
          f"launches {rm.ring_mac.launches} / {ms.mac_shift.launches}, peak "
          f"allocated {peak_mb:.1f} MB, selects "
          f"{model.control.select[0].tolist()}")
    if session.blocks_streamed != ENG_BLOCKS or sink.blocks != ENG_BLOCKS:
        raise AssertionError(f"{name}: streamed {session.blocks_streamed}, "
                             f"delivered {sink.blocks}")
    if rm.ring_mac.launches or ms.mac_shift.launches:
        raise AssertionError(f"{name}: a MAC kernel launched")
    if not sink.finite:
        raise AssertionError(f"{name}: non-finite output")
    return session, sink, state, run_s, peak_mb


def monolithic_clamped(eng, state, bank, params, dev):
    """Phase 23's clamped stretch: MONO_CLAMP_BLOCKS blocks of noise at
    phase 4's amplitude (0.01) through the card's engine from `state`,
    where the overlap-add clamps its partial sums (which no golden here
    models): voices 0 and 63 against the same engine on the CPU from the
    same state, within 1e-4 of the output's scale; some output sample must
    have been clamped. Returns (max abs error, scale, clamped samples)."""
    from dataclasses import fields

    import torch

    from tpu_audio_torch.engine.monolithic import (
        MonolithicConvolution, MonolithicState)
    from tpu_audio_torch.engine.params import VoiceParams

    rows = [0, eng.num_voices - 1]
    host = MonolithicConvolution(2, eng.fft_size, eng.block,
                                 max_predelay=eng.max_predelay, device="cpu")
    hstate = MonolithicState(active=state.active[rows].cpu(),
                             residual=state.residual[rows].cpu())
    hparams = VoiceParams(**{f.name: getattr(params, f.name)[rows].cpu()
                             for f in fields(params)})
    hbank = bank.cpu()
    rng = np.random.default_rng(2)
    err = scale = 0.0
    clamped = 0
    for _ in range(MONO_CLAMP_BLOCKS):
        x = (rng.standard_normal((eng.num_voices, 2, eng.block)) * 0.01
             ).astype(np.float32)
        state, out = eng.step(state, bank, params,
                              torch.tensor(x, device=dev))
        hstate, want = host.step(hstate, hbank, hparams,
                                 torch.tensor(x[rows]))
        want = want.numpy()
        err = max(err, float(np.abs(out[rows].cpu().numpy() - want).max()))
        scale = max(scale, float(np.abs(want).max()))
        # the wet part (the dry mix at centre pans and unit level removed)
        wet = want - 0.2 * (x[rows, 0] + x[rows, 1])[:, None]
        clamped += int((np.abs(wet) >= 1.0 - 1e-6).sum())
    print(f"monolithic clamped stretch: {MONO_CLAMP_BLOCKS} blocks of noise "
          f"at 0.01 from the session's state, voices 0 and "
          f"{eng.num_voices - 1} on the card against the CPU: max_abs_err "
          f"{err:.3e} (limit {1e-4 * scale:.3e}, scale {scale:.3f}), "
          f"{clamped} output samples clamped")
    if not err <= 1e-4 * scale:
        raise AssertionError("monolithic: the card disagrees with the CPU "
                             "where the overlap-add clamps")
    if not clamped:
        raise AssertionError("monolithic: the clamped stretch never reached "
                             "the clamp")
    return err, scale, clamped


def run_monolithic(bank, irs, dev, configure, select, keep_sink,
                   reset_counts, rm, ms):
    """Phase 23: ConvolutionReverb(engine='monolithic', fft_size=131072)
    at 64 voices over phase 4's IRs (truncated to 130048 samples, the
    reference's cap) through its session for 600 blocks of noise at 0.001
    with phase 4's re-select and interrupt: voices 0 and 63 against the
    golden of the truncated IR 0 before the re-select, and against the
    exact input-synchronous golden (each input block convolved with the IR
    mix it met, slew_weights) through the fades, each within 1e-4 of the
    output's scale; then the step's CUDA-event ms and device busy, and the
    clamped stretch (monolithic_clamped). Returns the figures."""
    import torch

    from tpu_audio_torch.models.reverb import ConvolutionReverb

    name = "monolithic"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="monolithic",
                              fft_size=MONO_FFT, max_predelay=8192,
                              device=dev)
    build_s = time.perf_counter() - t0
    session, sink, state, run_s, peak_mb = run_engine_session(
        name, model, configure, select, keep_sink, reset_counts, rm, ms,
        MONO_AMPLITUDE)
    cp = model.control
    x = noise_input(ENG_BLOCKS, amplitude=MONO_AMPLITUDE)
    keep = MONO_FFT - max(BLOCK, min(1024, MONO_FFT // 8))
    cut = [ir[:, :keep] for ir in irs]
    out = sink.data()
    scale = float(np.abs(out).max())
    limit = 1e-4 * scale
    before = check_golden(name, out, x, (("before the re-select, IR 0 cut "
                                          f"to {keep} samples", 0, SELECT_AT,
                                          cut[0]),),
                          predelay=1024, limit=limit)
    weights = slew_weights(ENG_BLOCKS, {SELECT_AT: 32 * NUM_IRS // 128,
                                        INTERRUPT_AT: 64 * NUM_IRS // 128},
                           NUM_IRS, 0.7, int(cp.speed[0, 0]))
    fade = 0.0
    for i, v in enumerate((0, VOICES - 1)):
        want = golden_mixed(x[i], cut, weights, dry=0.2, predelay=1024)
        err = float(np.abs(out[i, :, SELECT_AT * BLOCK:]
                           - want[:, SELECT_AT * BLOCK:]).max())
        fade = max(fade, err)
        print(f"{name} golden voice {v} blocks {SELECT_AT}-{ENG_BLOCKS - 1} "
              f"(through the fades, each input block with the IR mix it "
              f"met): max_abs_err {err:.3e} (limit {limit:.3e})")
        if not err <= limit:
            raise AssertionError(f"{name}: voice {v} disagrees with the "
                                 f"input-synchronous golden")
    params = cp.snapshot_device()
    xt = torch.tensor(np.repeat(x[:, :, :BLOCK], VOICES // 2, axis=0),
                      device=dev)
    steps, state = engine_timings(name, {"step": model.engine.step}, state,
                                  model.spectra, params, xt)
    clamp_err, clamp_scale, clamped = monolithic_clamped(
        model.engine, state, model.spectra, params, dev)
    out_fig = {"build_s": build_s, "run_s": run_s, "peak_mb": peak_mb,
               "summary": session.summary(), "scale": scale,
               "golden_err": before, "fade_golden_err": fade,
               "clamp_err": clamp_err, "clamp_scale": clamp_scale,
               "clamped": clamped,
               "steps": steps, "bank_mb": model.bank_bytes() / 1e6}
    del model, session, state, sink, xt
    torch.cuda.empty_cache()
    return out_fig


def run_partitioned(bank, irs, dev, configure, select, keep_sink,
                    reset_counts, rm, ms):
    """Phase 24: ConvolutionReverb(engine='partitioned') at 64 voices over
    phase 4's full 4 s IRs, 600 blocks of phase 4's input and timeline,
    variant 'coef' (steady and general fade steps) then 'materialized';
    each against the golden before the re-select and after the fades decay,
    coef against materialized on every block and voice within 2e-5 of
    scale; each step's CUDA-event ms and device busy. Then the coef model
    bounces 10 s of per-voice noise statically at auto segments (warm-up
    history_blocks), the golden held at every segment boundary. Returns the
    figures."""
    import torch

    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime import offline

    x = noise_input(ENG_BLOCKS)
    xt = torch.tensor(np.repeat(x[:, :, :BLOCK], VOICES // 2, axis=0),
                      device=dev)
    runs, outs = {}, {}
    for variant in ("coef", "materialized"):
        name = f"partitioned {variant}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, engine="partitioned",
                                  variant=variant, max_predelay=8192,
                                  device=dev)
        build_s = time.perf_counter() - t0
        session, sink, state, run_s, peak_mb = run_engine_session(
            name, model, configure, select, keep_sink, reset_counts, rm, ms,
            0.01, keep_all=True)
        if (variant == "coef") != (session.general_blocks > 0):
            raise AssertionError(f"{name}: {session.general_blocks} general "
                                 f"fade blocks")
        outs[variant] = sink.data()
        err = check_golden(
            name, outs[variant][[0, VOICES - 1]], x,
            (("before the re-select, IR 0", 0, SELECT_AT, irs[0]),
             ("after the fades decay, IR 2", ENG_AFTER, ENG_BLOCKS,
              irs[2])),
            predelay=1024)
        eng = model.engine
        steps = ({"steady": eng.step_coef_steady, "general": eng.step_coef}
                 if variant == "coef" else {"materialized": eng.step})
        timed, state = engine_timings(name, steps, state, model.spectra,
                                      model.control.snapshot_device(), xt)
        runs[variant] = {"build_s": build_s, "run_s": run_s,
                         "peak_mb": peak_mb, "summary": session.summary(),
                         "golden_err": err, "steps": timed,
                         "general_blocks": session.general_blocks,
                         "bank_mb": model.bank_bytes() / 1e6,
                         "partitions": eng.partitions}
        del model, session, state, sink, eng
        torch.cuda.empty_cache()
    scale = float(np.abs(outs["materialized"]).max())
    agree = float(np.abs(outs["coef"] - outs["materialized"]).max())
    print(f"partitioned: coef against materialized over all {ENG_BLOCKS} "
          f"blocks and {VOICES} voices: max_abs_err {agree:.3e} (limit "
          f"{2e-5 * scale:.3e})")
    if not agree <= 2e-5 * scale:
        raise AssertionError("partitioned: the variants disagree")
    del outs, xt

    name = "bounce (partitioned coef)"
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="partitioned",
                              max_predelay=8192, device=dev)
    configure(model.control)
    xb = voice_noise(VOICES, ENGINE_SAMPLES, seed=1)
    t_blocks = -(-ENGINE_SAMPLES // BLOCK)
    warmup = model.engine.history_blocks
    total = t_blocks + warmup
    nseg = min(offline._auto_segments(total, warmup, VOICES, 512), total)
    seg_len = -(-total // nseg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with BounceStages(offline) as stages:
        t0 = time.perf_counter()
        out = model.render_offline(xb)
        wall = time.perf_counter() - t0
    bounce = stages.report(name, wall, ENGINE_SAMPLES / RATE, VOICES)
    bounce.update(nseg=nseg, seg_len=seg_len, warmup=warmup,
                  peak_mb=torch.cuda.max_memory_allocated() / 1e6)
    print(f"{name}: {nseg} segments ({VOICES * nseg} virtual voices) x "
          f"{seg_len} + {warmup} warm-up steps, peak allocated "
          f"{bounce['peak_mb']:.1f} MB, ring_mac / mac_shift launches "
          f"{rm.ring_mac.launches} / {ms.mac_shift.launches}")
    if (stages.steps != warmup + seg_len or rm.ring_mac.launches
            or ms.mac_shift.launches or not np.isfinite(out).all()
            or out.shape != (VOICES, 2, ENGINE_SAMPLES + warmup * BLOCK)):
        raise AssertionError(f"{name}: {stages.steps} steps, output "
                             f"{out.shape}")
    bounce["golden_err"] = check_bounce_golden(
        name, out[[0, VOICES - 1]], xb[[0, -1]], (0, 1), irs[0], seg_len,
        nseg)
    del model, out, xb
    torch.cuda.empty_cache()
    return {"runs": runs, "agree_err": agree, "scale": scale,
            "bounce": bounce}


def run_cli_groups(irs):
    """Phase 25: a settings file whose conv pairs differ (fftSize 131072
    and 65536, each over its own 2-IR bank of 4 s IRs written as float
    WAVs) through `python -m tpu_audio_torch.app --engine monolithic`,
    streamed and then with --offline: the streamed WAV against the sum of
    the two groups' goldens (each IR cut to its pair's fftSize - 1024)
    within 1 LSB, the bounced WAV against the streamed one within 1 LSB.
    Returns the figures."""
    import os
    import tempfile

    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.io.wav import read_wav, write_wav

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_AUDIO_LOG="warn",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    banks = {"a": irs[:2], "b": [ir * np.float32(0.5) for ir in irs[2:4]]}
    rng = np.random.default_rng(25)
    x = (rng.standard_normal((HET_BLOCKS * BLOCK, 2)) * HET_AMPLITUDE
         ).astype(np.float32)
    figures = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, bank_irs in banks.items():
            for k, ir in enumerate(bank_irs):
                write_wav(f"{tmp}/{name}{k}.wav", ir.T, RATE, bits=32)
            with open(f"{tmp}/{name}.index", "w") as fh:
                fh.write("".join(f"{name}{k}.wav\n"
                                 for k in range(len(bank_irs))))
        lines = [f"conv.count {2 * len(HET_FFTS)}"]
        for n, (fft, name) in enumerate(zip(HET_FFTS, banks)):
            for ch in range(2):
                c = 2 * n + ch
                lines += [f"conv[{c}].fftSize {fft}",
                          f"conv[{c}].maxPredelay 8192",
                          f"conv[{c}].index {name}.index",
                          f"conv[{c}].value.select {ch}",
                          f"conv[{c}].value.predelay 1024",
                          f"conv[{c}].value.wet 0.7",
                          f"conv[{c}].value.dry 0.2"]
        with open(f"{tmp}/het.txt", "w") as fh:
            fh.write("\n".join(lines) + "\n")
        write_wav(f"{tmp}/in.wav", x, RATE)
        # the bounce reads back f32: on the default pcm16 wire each group
        # is rounded before the sum, which may move the mix by 2 LSB
        for mode, extra in (("streamed", []),
                            ("bounced", ["--offline", "--offline-wire",
                                         "f32"])):
            t0 = time.perf_counter()
            run = subprocess.run(
                [sys.executable, "-m", "tpu_audio_torch.app", "--settings",
                 f"{tmp}/het.txt", "--root", tmp, "--input", f"{tmp}/in.wav",
                 "--output", f"{tmp}/{mode}.wav", "--engine", "monolithic",
                 "--block-size", str(BLOCK), "--quiet", *extra],
                env=env, cwd=tmp, capture_output=True, text=True,
                timeout=600)
            figures[f"{mode}_wall_s"] = time.perf_counter() - t0
            print(f"CLI groups ({mode}): exited {run.returncode} after "
                  f"{figures[f'{mode}_wall_s']:.2f} s: {run.stdout.strip()} "
                  f"{run.stderr.strip()[-600:]}")
            if run.returncode != 0:
                raise AssertionError(f"CLI groups: the {mode} app failed")
        loaded = {name: IRBank.from_index(f"{tmp}/{name}.index",
                                          verbose=False)
                  for name in banks}
        program = read_wav(f"{tmp}/in.wav", verbose=False).stereo().T
        wavs = {mode: np.round(read_wav(f"{tmp}/{mode}.wav", scale="full",
                                        verbose=False).stereo().T * 32768.0)
                for mode in ("streamed", "bounced")}
    want = 0.0
    for fft, name in zip(HET_FFTS, banks):
        keep = fft - max(BLOCK, min(1024, fft // 8))
        pair = [loaded[name].ir(ch)[:, :keep] for ch in range(2)]
        want = want + golden(program, pair, wet=0.7, dry=0.2, predelay=1024)
    streamed, bounced = wavs["streamed"], wavs["bounced"]
    t = streamed.shape[-1]
    if t != HET_BLOCKS * BLOCK or bounced.shape[-1] < t:
        raise AssertionError(f"CLI groups: streamed {streamed.shape}, "
                             f"bounced {bounced.shape}")
    golden_lsb = float(np.abs(streamed - want * 32768.0).max())
    bounce_lsb = float(np.abs(bounced[:, :t] - streamed).max())
    print(f"CLI groups: streamed WAV against the summed goldens of the "
          f"{len(HET_FFTS)} groups: {golden_lsb:.3f} LSB (limit 1, peak "
          f"{float(np.abs(want).max()):.3f}); bounced against streamed over "
          f"{t} samples: {bounce_lsb:.0f} LSB (limit 1)")
    if not golden_lsb <= 1.0 or not bounce_lsb <= 1.0:
        raise AssertionError("CLI groups: the output disagrees")
    figures.update(golden_lsb=golden_lsb, bounce_lsb=bounce_lsb)
    return figures


def snr_db(got, want):
    """10 log10 of the reference's power over the error's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(((got - want) ** 2).sum())
    return float("inf") if err == 0 else 10.0 * np.log10(
        float((want ** 2).sum()) / err)


def time_mac_shift(ms, fdl, xn, rhs, reps=200):
    """mac_shift at one shape against its plain version and one torch.einsum
    of the unshifted line on the same operands (a yardstick, not the
    function: no one call shifts the line; in bf16 it rounds m to bf16),
    interleaved (plain, einsum, kernel, kernel, einsum, plain), with the
    bound from the line read and written back, x_new and rhs read in their
    dtype and m written in f32. Returns {kernel, plain, einsum, bound,
    bound_by, bytes} in ms (bytes in bytes)."""
    import torch

    f, vi, _, pp = fdl.shape
    kod = rhs.shape[3]
    calls = {"plain": lambda: ms.mac_shift_reference(fdl, xn, rhs),
             "einsum": lambda: torch.einsum(
                 "fvq,fqk->fvk", fdl.reshape(f, vi, 2 * pp),
                 rhs.reshape(f, 2 * pp, kod)),
             "kernel": lambda: ms.mac_shift(fdl, xn, rhs)}
    runs = {key: [] for key in calls}
    for key in ("plain", "einsum", "kernel", "kernel", "einsum", "plain"):
        runs[key].append(cuda_ms(calls[key], reps))
    nbytes = ((2 * fdl.numel() + xn.numel() + rhs.numel())
              * fdl.element_size() + f * vi * kod * 4)
    bound_ms, bound_by = roofline_ms(nbytes, 2 * f * vi * 2 * pp * kod,
                                     fdl.dtype)
    out = {key: float(np.mean(v)) for key, v in runs.items()}
    out.update(bound=bound_ms, bound_by=bound_by, bytes=nbytes)
    return out


def run_bf16_kernels(dev, rng, pp):
    """Phase 26: both bf16 kernels against their plain versions (bf16
    operands upcast, float64 sums) within 1e-5 of scale at the 64-voice
    shapes (F=257, VI=128, Pp=696) of KOD 16, 36 and 64, and ring_mac at
    the 2048-voice cascade's head [257, 4096, 2, 32] and tail [4097, 256,
    2, 48] shapes (KOD 16), ring_mac's bmm yardstick too; each timed
    against its plain version, that yardstick, one bf16 einsum and its
    bound; `pp` is the 4 s IRs' padded partition count. Returns (largest
    error per kernel, timings per kernel and shape)."""
    import torch

    from tpu_audio_torch.ops import mac_shift as ms
    from tpu_audio_torch.ops import ring_mac as rm

    def bf16(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev).to(torch.bfloat16)

    f, vi = BLOCK + 1, 2 * VOICES
    shapes = [("ring_mac", f"kod{kod}", (f, vi, pp, kod)) for kod in RING_KODS]
    shapes += [("ring_mac", name, (fs, vis, pps, 4 * NUM_IRS))
               for name, (fs, vis, pps) in CASCADE_2048_SHAPES.items()]
    shapes += [("mac_shift", f"kod{kod}", (f, vi, pp, kod))
               for kod in RING_KODS]
    worst = {"ring_mac": 0.0, "mac_shift": 0.0}
    timed = {"ring_mac": {}, "mac_shift": {}}
    for kernel, name, (fs, vis, pps, kod) in shapes:
        fdl = bf16(fs, vis, 2, pps)
        label = f"{kernel} bf16 vs plain [{name} F={fs} VI={vis} Pp={pps} " \
                f"KOD={kod}]"
        if kernel == "ring_mac":
            rhs2 = bf16(fs, 2, 2 * pps, kod)
            inputs = (fdl, rhs2)
            for w in sorted({0, 1, pps // 2 + 1, pps - 1}):
                wt = torch.tensor(w, dtype=torch.int32, device=dev)
                got = rm.ring_mac(wt, fdl, rhs2)
                torch.cuda.synchronize()
                ref = rm.ring_mac_reference(w, fdl.double(), rhs2.double())
                scale = ref.abs().max().item()
                err = (got.double() - ref).abs().max().item()
                err_lib = (ring_mac_library(w, fdl, rhs2).double()
                           - ref).abs().max().item()
                print(f"{label} w={w}: max_abs_err {err:.3e} (library bmm "
                      f"{err_lib:.3e}, limit {1e-5 * scale:.3e})")
                if not err <= 1e-5 * scale:
                    raise AssertionError(f"bf16 ring_mac disagrees at "
                                         f"{name} w={w}")
                if not err_lib <= 1e-5 * scale:
                    raise AssertionError(f"the bf16 library yardstick "
                                         f"computes another function at "
                                         f"{name} w={w}")
                worst[kernel] = max(worst[kernel], err)
                del got, ref
        else:
            xn, rhs = bf16(fs, vis, 2, 1), bf16(fs, 2, pps, kod)
            inputs = (fdl, xn, rhs)
            want_fdl, _ = ms.mac_shift_reference(fdl, xn, rhs)
            _, ref = ms.mac_shift_reference(fdl.double(), xn.double(),
                                            rhs.double())
            got_fdl, got = ms.mac_shift(fdl, xn, rhs)
            torch.cuda.synchronize()
            same = torch.equal(got_fdl.view(torch.int16),
                               want_fdl.view(torch.int16))
            scale = ref.abs().max().item()
            err = (got.double() - ref).abs().max().item()
            print(f"{label}: shifted line "
                  f"{'bit-identical' if same else 'DIFFERS'}, m max_abs_err "
                  f"{err:.3e} (limit {1e-5 * scale:.3e})")
            if not same or not err <= 1e-5 * scale:
                raise AssertionError(f"bf16 mac_shift disagrees at {name}")
            worst[kernel] = max(worst[kernel], err)
            del want_fdl, ref, got
        t = timed[kernel][name] = (
            time_ring_mac(rm, *inputs) if kernel == "ring_mac"
            else time_mac_shift(ms, *inputs))
        gbps = t["bytes"] / (t["kernel"] * 1e-3) / 1e9
        library = (f", library (bmm, f32 out) {t['library'] * 1e3:.2f} us "
                   f"({t['library'] / t['kernel']:.2f}x the kernel's time)"
                   if "library" in t else "")
        print(f"{kernel} bf16 timing [{name}]: kernel {t['kernel'] * 1e3:.2f} "
              f"us ({gbps:.0f} GB/s, {100 * t['bound'] / t['kernel']:.1f} % of "
              f"the {t['bound'] * 1e3:.2f} us bound by {t['bound_by']}), "
              f"plain {t['plain'] * 1e3:.2f} us{library}")
        print(f"{kernel} bf16 einsum [{name}] (rounds m to bf16"
              f"{'; no shift' if kernel == 'mac_shift' else ''}): "
              f"{t['einsum'] * 1e3:.2f} us")
        del fdl, inputs
        torch.cuda.empty_cache()
    return worst, timed


def session_figures(name, session, run_s, build_s, peak_mb, step, state, x,
                    label):
    """Print and return a session's figures: ms per block p50 / p99, RTF,
    missed deadlines, build s, peak memory, and its steady step's CUDA-event
    p50 / p99, device busy and device ops (the top ops under `label`)."""
    summary = session.summary()
    params = session.control.snapshot_device()
    p50, p99, state = step_times(step, state, session.bank, params, x, n=200)
    busy, ops, state = device_busy(step, state, session.bank, params, x,
                                   label=label)
    what = "not measured" if busy is None else (
        f"device busy {busy:.1f} us in {ops:.1f} device ops")
    print(f"{name}: {session.blocks_streamed} blocks in {run_s:.3f} s (built "
          f"in {build_s:.2f} s, peak allocated {peak_mb:.1f} MB), session p50 "
          f"/ p99 {summary['p50_ms']:.3f} / {summary['p99_ms']:.3f} ms per "
          f"block, RTF {summary['rtf']:.3f}, missed "
          f"{summary['missed_deadlines']}; steady step p50 / p99 {p50:.3f} / "
          f"{p99:.3f} ms (CUDA events), {what}")
    return {"summary": summary, "build_s": build_s, "peak_mb": peak_mb,
            "run_s": run_s, "step": (p50, p99, busy, ops)}


def run_fmajor_bf16(bank, dev, configure, select, keep_sink, reset_counts,
                    rm, ms, ring_f32_out):
    """Phase 27: mac_dtype='bf16' on the fmajor engine at 64 voices over
    phase 4's 4 IRs. (a) ConvolutionReverb(mac_dtype='bf16') through its
    session on phase 4's timeline (800 blocks, a re-select at 300, an
    interrupt at 306): every block must launch the bf16 ring_mac, and
    voices 0 and 63 must track phase 4's f32 session above 40 dB SNR.
    (b) roll mode in bf16 and in f32 through StreamSession, 600 blocks of
    the same timeline: every bf16 block on the bf16 mac_shift, the two
    above 40 dB SNR. (c) a static bounce of 10 s of per-voice noise by the
    bf16 model against the f32 model's, above 40 dB SNR, every step on the
    bf16 ring_mac. (d) the 'selected' steps, whose per-voice products
    take bf16 operands with no f32 copy: fmajor ring and the cascade,
    steady and general, f32 beside bf16. Returns the figures."""
    import torch

    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.offline import render_offline
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    figures = {}
    timeline = [select(SELECT_AT, 32), select(INTERRUPT_AT, 64)]
    xt = torch.randn((VOICES, 2, BLOCK), device=dev) * 0.01

    # (a) ring mode through the model's session
    name = "fmajor ring bf16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="fmajor",
                              max_predelay=8192, mac_dtype="bf16",
                              device=dev)
    build_s = time.perf_counter() - t0
    eng = model.engine
    if (eng.mac_strategy != "allk" or not eng.ring_mode
            or model.spectra.rhs2.dtype != torch.bfloat16):
        raise AssertionError(f"{name}: {eng.mac_strategy}, ring "
                             f"{eng.ring_mode}, rhs2 {model.spectra.rhs2.dtype}")
    configure(model.control)
    sink = keep_sink()
    session = model.session(NoiseSource(VOICES, BLOCK, BLOCKS, amplitude=0.01,
                                        seed=0), sink)
    state = model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=MidiSchedule(list(timeline)))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (rm.ring_mac.launches, rm.ring_mac.launches_bf16,
                ms.mac_shift.launches)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    steps = session.blocks_streamed
    print(f"{name}: ring_mac launches {launches[0]} ({launches[1]} bf16), "
          f"mac_shift {launches[2]}, indexed blocks {session.indexed_blocks},"
          f" general {session.general_blocks}, line {state.fdl.dtype}")
    if steps != BLOCKS or sink.blocks != BLOCKS or not sink.finite:
        raise AssertionError(f"{name}: {steps} blocks streamed, "
                             f"{sink.blocks} delivered, finite {sink.finite}")
    if launches != (steps, steps, 0) or state.fdl.dtype != torch.bfloat16:
        raise AssertionError(f"{name}: launches {launches} in {steps} steps")
    if session.indexed_blocks < 20 or session.general_blocks:
        raise AssertionError(f"{name}: {session.indexed_blocks} indexed, "
                             f"{session.general_blocks} general blocks")
    snr = snr_db(sink.data(), ring_f32_out)
    print(f"{name}: voices 0 and {VOICES - 1} against phase 4's f32 session, "
          f"all {BLOCKS} blocks: SNR {snr:.2f} dB (limit 40)")
    if not snr > 40.0:
        raise AssertionError(f"{name}: SNR {snr:.2f} dB against f32")
    figures["ring"] = session_figures(
        name, session, run_s, build_s, peak_mb, eng.step_coef_steady, state,
        xt, "fmajor ring bf16 step_coef_steady")
    figures["ring"].update(snr=snr, launches=launches[1])
    del session, state

    # (c) the static bounce, bf16 against f32
    xb = voice_noise(VOICES, ENGINE_SAMPLES, seed=27)
    f32_model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, engine="fmajor",
                                  max_predelay=8192, device=dev)
    configure(f32_model.control)
    f32_model.control.select[:] = model.control.select   # after the session
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = render_offline(model, xb, wire="f32")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bounce_launches = (rm.ring_mac.launches, rm.ring_mac.launches_bf16)
    want = render_offline(f32_model, xb, wire="f32")
    bsnr = snr_db(got, want)
    x_rt = ENGINE_SAMPLES / RATE / wall
    print(f"{name} bounce: 10 s of {VOICES} per-voice voices in {wall:.3f} s "
          f"({x_rt:.2f}x real time), ring_mac launches {bounce_launches[0]} "
          f"({bounce_launches[1]} bf16); against the f32 model's bounce: SNR "
          f"{bsnr:.2f} dB (limit 40)")
    if (not np.isfinite(got).all() or not bounce_launches[1]
            or bounce_launches[0] != bounce_launches[1]):
        raise AssertionError(f"{name} bounce: launches {bounce_launches}")
    if not bsnr > 40.0:
        raise AssertionError(f"{name} bounce: SNR {bsnr:.2f} dB")
    figures["bounce"] = {"wall_s": wall, "x_real_time": x_rt, "snr": bsnr,
                         "launches": bounce_launches[1]}
    del model, f32_model, got, want
    torch.cuda.empty_cache()

    # (b) roll mode, bf16 and f32
    outs = {}
    for dtype in ("f32", "bf16"):
        rname = f"fmajor roll {dtype}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        roll = FMajorPartitionedConvolution(
            VOICES, BLOCK, bank.max_partitions(BLOCK), max_predelay=8192,
            ring=False, mac_strategy="allk", num_irs=NUM_IRS,
            mac_dtype=dtype, device=dev)
        roll_bank = roll.prepare_bank(bank.partitioned_spectra(BLOCK))
        build_s = time.perf_counter() - t0
        cp = ControlPlane(VOICES, NUM_IRS, 8192, device=dev)
        configure(cp)
        rsink = keep_sink()
        rsession = StreamSession(
            roll, roll_bank, cp,
            NoiseSource(VOICES, BLOCK, ROLL27_BLOCKS, amplitude=0.01, seed=0),
            rsink, sample_rate=RATE)
        state = roll.init_converged(roll_bank, cp.snapshot_device())
        reset_counts()
        t0 = time.perf_counter()
        state = rsession.run(state, midi=MidiSchedule(list(timeline)))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (ms.mac_shift.launches, ms.mac_shift.launches_bf16,
                    rm.ring_mac.launches)
        steps = rsession.blocks_streamed
        print(f"{rname}: mac_shift launches {launches[0]} ({launches[1]} "
              f"bf16), ring_mac {launches[2]}, indexed blocks "
              f"{rsession.indexed_blocks}")
        want_bf16 = steps if dtype == "bf16" else 0
        if (steps != ROLL27_BLOCKS or launches != (steps, want_bf16, 0)
                or not rsink.finite or rsession.indexed_blocks < 20):
            raise AssertionError(f"{rname}: {steps} blocks, launches "
                                 f"{launches}, finite {rsink.finite}")
        outs[dtype] = rsink.data()
        if dtype == "bf16":
            peak_mb = torch.cuda.max_memory_allocated() / 1e6
            figures["roll"] = session_figures(
                rname, rsession, run_s, build_s, peak_mb,
                roll.step_coef_steady, state, xt,
                "fmajor roll bf16 step_coef_steady")
            figures["roll"]["launches"] = launches[1]
        del roll, roll_bank, rsession, state
        torch.cuda.empty_cache()
    rsnr = snr_db(outs["bf16"], outs["f32"])
    print(f"fmajor roll bf16: voices 0 and {VOICES - 1} against the f32 roll "
          f"session, all {ROLL27_BLOCKS} blocks: SNR {rsnr:.2f} dB (limit 40)")
    if not rsnr > 40.0:
        raise AssertionError(f"fmajor roll bf16: SNR {rsnr:.2f} dB")
    figures["roll"]["snr"] = rsnr

    # (d) the steps of the per-voice product ('selected', fmajor ring and
    # the cascade), steady and general, in f32 and in bf16
    figures["selected"] = {}
    for engine in ("fmajor", "cascade"):
        for dtype in ("f32", "bf16"):
            smodel = ConvolutionReverb(
                bank, num_voices=VOICES, block=BLOCK, sample_rate=RATE,
                engine=engine, max_predelay=8192, mac_strategy="selected",
                mac_dtype=dtype, device=dev)
            configure(smodel.control)
            params = smodel.control.snapshot_device()
            state = smodel.engine.init_converged(smodel.spectra, params)
            for kind, step in (("steady", smodel.engine.step_coef_steady),
                               ("general", smodel.engine.step_coef)):
                label = f"{engine} 'selected' {dtype} {kind} step"
                p50, p99, state = step_times(step, state, smodel.spectra,
                                             params, xt, n=120)
                busy, ops, state = device_busy(
                    step, state, smodel.spectra, params, xt,
                    label=label if kind == "general" else None)
                figures["selected"][(engine, dtype, kind)] = (p50, p99, busy,
                                                              ops)
                what = "not measured" if busy is None else (
                    f"device busy {busy:.1f} us in {ops:.1f} device ops")
                print(f"{label}: p50 / p99 {p50:.3f} / {p99:.3f} ms (CUDA "
                      f"events), {what}")
            del smodel, state
            torch.cuda.empty_cache()
    return figures


def wet_snr(out, x, windows, predelay, voices):
    """SNR of the wet path of voice rows 0 and 1 of `out` (voices 0 and
    voices - 1; the dry mix taken off) against the float64 golden of each
    (label, first block, end block, IR) window, over all windows."""
    sig = err = 0.0
    for i in range(2):
        dry = (x[i][0] + x[i][1]) * 0.2
        for _, b0, b1, ir in windows:
            want = golden(x[i], [ir, ir], wet=0.7, dry=0.0,
                          predelay=predelay)[:, b0 * BLOCK: b1 * BLOCK]
            got = (out[i] - dry)[:, b0 * BLOCK: b1 * BLOCK]
            sig += float((want ** 2).sum())
            err += float(((got - want) ** 2).sum())
    return 10.0 * np.log10(sig / err)


def write_settings(tmp, irs, name, voices_note=""):
    """A settings file `tmp`/`name`.txt over an index of `irs` written as
    float WAVs (one conv pair, maxPredelay 8192, wet 0.7, dry 0.2,
    predelay 1024, a select CC 21)."""
    from tpu_audio_torch.io.wav import write_wav

    for k, ir in enumerate(irs):
        write_wav(f"{tmp}/{name}{k}.wav", ir.T, RATE, bits=32)
    with open(f"{tmp}/{name}.index", "w") as fh:
        fh.write("".join(f"{name}{k}.wav\n" for k in range(len(irs))))
    lines = ["conv.count 2"]
    for c in range(2):
        lines += [f"conv[{c}].maxPredelay 8192",
                  f"conv[{c}].index {name}.index",
                  f"conv[{c}].cc.message 176",
                  f"conv[{c}].cc.select {SELECT_CC}",
                  f"conv[{c}].value.predelay 1024",
                  f"conv[{c}].value.wet 0.7",
                  f"conv[{c}].value.dry 0.2"]
    path = f"{tmp}/{name}.txt"
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def run_cli(args, tmp, label, rm, ms, reset_counts):
    """`python -m tpu_audio_torch.app ARGS` in this process (the CLI's own
    main, as __main__ calls it): returns (exit code, wall s, ring_mac
    launches, of them bf16, mac_shift launches)."""
    from tpu_audio_torch.app.main import main as app_main

    reset_counts()
    t0 = time.perf_counter()
    rc = app_main([*args, "--root", tmp, "--block-size", str(BLOCK),
                   "--device", "cuda", "--quiet"])
    wall = time.perf_counter() - t0
    counts = (rm.ring_mac.launches, rm.ring_mac.launches_bf16,
              ms.mac_shift.launches)
    print(f"CLI {label}: exited {rc} after {wall:.2f} s, ring_mac launches "
          f"{counts[0]} ({counts[1]} bf16), mac_shift {counts[2]}")
    return rc, wall, counts


def run_cascade_2048(bank, irs, dev, configure, select, keep_sink,
                     reset_counts, rm, ms):
    """Phase 28: the JAX bench's cascade_2048 (bench.py:804-811): 2048
    voices, bf16, ratio 16, read-side predelay, 4 s IRs, through the
    model's session for 300 blocks with a re-select at 100. Every block
    launches the bf16 ring_mac twice; voices 0 and 2047's wet path must
    track the float64 golden above 40 dB SNR before the re-select and
    after the fade; then the steps are timed with their top device ops,
    and the CLI runs the same configuration for a few blocks. Returns the
    figures."""
    import tempfile

    import torch

    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    name = f"cascade {HUGE_VOICES} voices bf16"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=HUGE_VOICES, block=BLOCK,
                              sample_rate=RATE, engine="cascade",
                              max_predelay=8192, cascade_ratio=CAS_RATIO,
                              predelay_side="read", mac_dtype="bf16",
                              device=dev)
    engine, cp = model.engine, model.control
    configure(cp)
    state = model.init_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if ((engine.ratio, engine.pp2, engine.predelay_side) != (
            CAS_RATIO, CAS_PP2, "read") or state.fdl2.dtype != torch.bfloat16
            or model.spectra.tail_rhs2.dtype != torch.bfloat16):
        raise AssertionError(f"{name}: ratio {engine.ratio}, P2p "
                             f"{engine.pp2}, {state.fdl2.dtype}")
    state_mb = sum(v.numel() * v.element_size() for v in vars(state).values()
                   if isinstance(v, torch.Tensor)) / 1e6
    sink = keep_sink()
    session = model.session(NoiseSource(HUGE_VOICES, BLOCK, HUGE_BLOCKS,
                                        amplitude=0.01, seed=0), sink)
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=MidiSchedule(
        [select(HUGE_SELECT_AT, 32)]))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (rm.ring_mac.launches, rm.ring_mac.launches_bf16,
                ms.mac_shift.launches)
    steps = session.blocks_streamed
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    print(f"{name}: state {state_mb:.1f} MB, bank "
          f"{model.bank_bytes() / 1e6:.1f} MB, ring_mac launches "
          f"{launches[0]} ({launches[1]} bf16), mac_shift {launches[2]}, "
          f"indexed blocks {session.indexed_blocks}, general "
          f"{session.general_blocks}")
    if steps != HUGE_BLOCKS or sink.blocks != HUGE_BLOCKS or not sink.finite:
        raise AssertionError(f"{name}: {steps} blocks streamed, "
                             f"{sink.blocks} delivered, finite {sink.finite}")
    if launches != (2 * steps, 2 * steps, 0):
        raise AssertionError(f"{name}: launches {launches} in {steps} steps")
    if session.indexed_blocks < 20 or session.general_blocks:
        raise AssertionError(f"{name}: {session.indexed_blocks} indexed, "
                             f"{session.general_blocks} general blocks")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError(f"{name}: the crossfade did not decay")
    snr = wet_snr(sink.data(), noise_input(HUGE_BLOCKS, HUGE_VOICES),
                  (("before the re-select, IR 0", 0, HUGE_SELECT_AT, irs[0]),
                   ("after the fade and the tail's lag, IR 1", BIG_AFTER,
                    HUGE_BLOCKS, irs[1])),
                  int(cp.predelay[0, 0]), HUGE_VOICES)
    print(f"{name}: voices 0 and {HUGE_VOICES - 1}, wet path against the "
          f"float64 golden over blocks 0-{HUGE_SELECT_AT - 1} and "
          f"{BIG_AFTER}-{HUGE_BLOCKS - 1}: SNR {snr:.2f} dB (limit 40)")
    if not snr > 40.0:
        raise AssertionError(f"{name}: SNR {snr:.2f} dB against the golden")
    x = torch.randn((HUGE_VOICES, 2, BLOCK), device=dev) * 0.01
    figures = session_figures(name, session, run_s, build_s, peak_mb,
                              engine.step_coef_steady, state, x,
                              "cascade2048 bf16 step_coef_steady")
    params = cp.snapshot_device()
    p50, p99, state = step_times(engine.step_coef_indexed, state,
                                 model.spectra, params, x, n=200)
    busy, ops, state = device_busy(engine.step_coef_indexed, state,
                                   model.spectra, params, x)
    print(f"{name}: step_coef_indexed p50 / p99 {p50:.3f} / {p99:.3f} ms "
          f"(CUDA events), device busy {busy} us in {ops} device ops")
    figures.update(snr=snr, launches=launches[1], state_mb=state_mb,
                   indexed=(p50, p99, busy, ops))
    del model, session, state, engine
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        settings = write_settings(tmp, irs, "cas")
        rc, wall, counts = run_cli(
            ["--settings", settings, "--engine", "cascade", "--mac-dtype",
             "bf16", "--predelay-side", "read", "--voices",
             str(HUGE_VOICES), "--signal", "noise", "--blocks",
             str(CLI_CASCADE_BLOCKS)], tmp, f"--engine cascade --mac-dtype "
            f"bf16 --voices {HUGE_VOICES}", rm, ms, reset_counts)
    if rc != 0 or counts[1] != 2 * CLI_CASCADE_BLOCKS or counts[1] != counts[0]:
        raise AssertionError(f"CLI cascade bf16: exit {rc}, launches {counts}")
    figures.update(cli_wall_s=wall, cli_launches=counts[1])
    torch.cuda.empty_cache()
    return figures


def run_sel152(dev, configure, select, keep_sink, reset_counts, rm, ms):
    """Phase 29: the JAX bench's sel152 leg (benchlib/legs.py:356-393): 152
    synthetic 4 s IRs through the cascade's 'selected' strategy (ratio 16,
    f32, no residency manager), 64 voices, 600 blocks; at 300 every voice
    re-selects and the fade runs the general step; at 450, mid-fade, a
    swap_bank to new[k] = 0.5 * irs[(k + 1) % 152] (regather_selection;
    the snapshot the collapse materialized keeps the old bank's fade-out). No MAC kernel launches on this path. Voices 0 and
    63 against the golden before the re-select and after the swap's fades
    and the tail's lag, within 2e-5 of scale (the fade speed is 150 blocks,
    so the swap lands mid-fade and the fade is over before the last
    window); collapse, materialize_base and
    regather_selection timed at first use (in the session) and warm; then
    the CLI serves the bank written as 152 WAVs for a few blocks. Returns
    the figures."""
    import tempfile

    import torch

    from tpu_audio_torch.engine import device_prep
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    name = f"sel{SEL152_IRS} cascade 'selected'"
    irs = synthetic_bank(SEL152_IRS, IR_SECONDS, RATE)
    bank, new_bank = IRBank(sample_rate=RATE), IRBank(sample_rate=RATE)
    new_irs = [irs[(k + 1) % SEL152_IRS] * np.float32(0.5)
               for k in range(SEL152_IRS)]
    for ir, new in zip(irs, new_irs):
        bank.append(ir)
        new_bank.append(new)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="cascade",
                              max_predelay=8192, cascade_ratio=CAS_RATIO,
                              device=dev)
    engine, cp = model.engine, model.control
    configure(cp)
    cp.speed[:] = SEL152_SPEED
    state = model.init_state()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if engine.mac_strategy != "selected" or engine.ratio != CAS_RATIO:
        raise AssertionError(f"{name}: {engine.mac_strategy}, ratio "
                             f"{engine.ratio}")
    swap_to = device_prep.prepare_cascade_bank_device(engine, new_bank)
    calls = {}

    def timed(what, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            calls.setdefault(what, []).append(
                1e3 * (time.perf_counter() - t1))
            return out
        return call

    for what in ("collapse", "materialize_base", "regather_selection"):
        setattr(engine, what, timed(what, getattr(engine, what)))
    sink = keep_sink()
    session = model.session(NoiseSource(VOICES, BLOCK, SEL152_BLOCKS,
                                        amplitude=0.01, seed=0), sink)
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, max_blocks=SEL152_SWAP_AT, midi=MidiSchedule(
        [select(SEL152_SELECT_AT, 64)]))
    session.swap_bank(swap_to)
    state = session.run(state)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = (rm.ring_mac.launches, ms.mac_shift.launches)
    steps = session.blocks_streamed
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    print(f"{name}: general blocks {session.general_blocks}, indexed "
          f"{session.indexed_blocks}, ring_mac / mac_shift launches "
          f"{launches}, selects {cp.select[0].tolist()}, swap applied "
          f"{session.bank is swap_to}; first use ms: "
          + ", ".join(f"{w} {t[0]:.2f}" for w, t in calls.items()))
    if steps != SEL152_BLOCKS or sink.blocks != SEL152_BLOCKS \
            or not sink.finite:
        raise AssertionError(f"{name}: {steps} blocks streamed, "
                             f"{sink.blocks} delivered, finite {sink.finite}")
    if launches != (0, 0) or session.indexed_blocks \
            or session.general_blocks < 60 or session.bank is not swap_to:
        raise AssertionError(f"{name}: launches {launches}, step mix or swap")
    if {"collapse", "regather_selection"} - set(calls):
        raise AssertionError(f"{name}: rare paths run {sorted(calls)}")
    sel = SEL152_VALUE * SEL152_IRS // 128
    x = noise_input(SEL152_BLOCKS, VOICES)
    out = sink.data()
    worst = 0.0
    for i, v in enumerate((0, VOICES - 1)):
        for label, b0, b1, ir in (
                ("before the re-select, IR 0", 0, SEL152_SELECT_AT, irs[0]),
                (f"after the swap's fades, new IR {sel}", SEL152_AFTER,
                 SEL152_BLOCKS, new_irs[sel])):
            want = golden(x[i], [ir, ir], wet=0.7, dry=0.2,
                          predelay=int(cp.predelay[0, 0]))
            want = want[:, b0 * BLOCK: b1 * BLOCK]
            err = float(np.abs(out[i, :, b0 * BLOCK: b1 * BLOCK]
                               - want).max())
            limit = 2e-5 * float(np.abs(want).max())
            print(f"{name} golden voice {v} blocks {b0}-{b1 - 1} ({label}): "
                  f"max_abs_err {err:.3e} (limit {limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"{name}: voice {v} {label}")
            worst = max(worst, err)
    xt = torch.randn((VOICES, 2, BLOCK), device=dev) * 0.01
    figures = session_figures(name, session, run_s, build_s, peak_mb,
                              engine.step_coef_steady, state, xt,
                              "sel152 step_coef_steady")
    params = cp.snapshot_device()
    p50, p99, state = step_times(engine.step_coef, state, model.spectra,
                                 params, xt, n=200)
    busy, ops, state = device_busy(engine.step_coef, state, model.spectra,
                                   params, xt, label="sel152 step_coef")
    changed = torch.ones((VOICES, 2), dtype=torch.bool, device=dev)
    sel_t = torch.tensor(cp.select, device=dev)
    for _ in range(3):
        state = engine.collapse(state, swap_to, sel_t, changed, sel_t, params)
        state = engine.regather_selection(state, swap_to, sel_t)
        state = engine.materialize_base(state, swap_to)
    warm = {what: float(np.median(t[1:])) for what, t in calls.items()
            if len(t) > 1}
    print(f"{name}: general step p50 / p99 {p50:.3f} / {p99:.3f} ms, device "
          f"busy {busy} us in {ops} ops; warm ms: "
          + ", ".join(f"{w} {t:.2f}" for w, t in warm.items()))
    figures.update(golden_err=worst, general=(p50, p99, busy, ops),
                   first_ms={w: t[0] for w, t in calls.items()}, warm_ms=warm)
    del model, session, state, engine, swap_to
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        settings = write_settings(tmp, irs, "sel")
        rc, wall, counts = run_cli(
            ["--settings", settings, "--engine", "cascade", "--voices",
             str(VOICES), "--signal", "noise", "--blocks",
             str(CLI_CASCADE_BLOCKS)], tmp,
            f"--engine cascade over the {SEL152_IRS}-IR index", rm, ms,
            reset_counts)
    if rc != 0 or counts != (0, 0, 0):
        raise AssertionError(f"CLI sel152: exit {rc}, launches {counts}")
    figures["cli_wall_s"] = wall
    torch.cuda.empty_cache()
    return figures


def run_chunked(bank, irs, dev, configure, select, keep_sink, reset_counts,
                rm, ms):
    """Phase 30: chunked serving at full width. 64 voices over phase 4's IRs
    stream CHUNK_BLOCKS30 blocks of per-voice noise (not a multiple of the
    chunk: the last chunk is partial) with a re-select and an interrupt on
    the chunk grid, per block and in chunks of CHUNK30: (a) ring 'allk'
    f32 (the CLI's default), every block on ring_mac, against the per-block
    run within 2e-5 of scale and against the golden; (b) roll 'allk' f32,
    every block on mac_shift, against per-block; (c) ring in bf16 against
    its per-block run; (d) the 'allk' cascade (ratio 16) in chunks of 16,
    two ring_mac launches per block, against per-block; (e) run_resilient
    in chunks with one sink failure, to the bit against (a)'s chunked run.
    Host ms per block, RTF, missed and the steady step's device busy at
    chunk 1 and chunk 8; a monolithic session refuses chunks. Returns the
    figures."""
    import tempfile

    import torch

    from tpu_audio_torch.engine.fmajor import (
        FMajorPartitionedConvolution, make_chunk_step,
    )
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import WavSource
    from tpu_audio_torch.runtime.recovery import run_resilient
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    rng = np.random.default_rng(0)
    n = CHUNK_BLOCKS30
    x = np.concatenate([(rng.standard_normal((VOICES, 2, BLOCK)) * 0.01
                         ).astype(np.float32) for _ in range(n)], axis=-1)

    def timeline():
        return MidiSchedule([select(CHUNK_SELECT_AT, 32),
                             select(CHUNK_INTERRUPT_AT, 64)])

    class Roll:
        """Roll mode (no model flag): the engine, its bank and a control
        plane, as phase 7 builds them."""

        working_set = None

        def __init__(self):
            self.engine = FMajorPartitionedConvolution(
                VOICES, BLOCK, bank.max_partitions(BLOCK), max_predelay=8192,
                ring=False, mac_strategy="allk", num_irs=NUM_IRS, device=dev)
            self.spectra = self.engine.prepare_bank(
                bank.partitioned_spectra(BLOCK))
            self.control = ControlPlane(VOICES, NUM_IRS, 8192, device=dev)
            configure(self.control)

        def init_state(self):
            return self.engine.init_converged(self.spectra,
                                              self.control.snapshot_device())

        def session(self, source, sink, **kwargs):
            return StreamSession(self.engine, self.spectra, self.control,
                                 source, sink, sample_rate=RATE, **kwargs)

    def build(kind):
        if kind == "roll":
            return Roll()
        kwargs = {"ring_bf16": {"mac_dtype": "bf16"},
                  "cascade": {"engine": "cascade",
                              "cascade_ratio": CAS_RATIO}}.get(kind, {})
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, max_predelay=8192,
                                  device=dev, **kwargs)
        configure(model.control)
        return model

    def stream(kind, chunk, blocks, events):
        model = build(kind)
        sink = keep_sink(keep_all=True)
        session = model.session(WavSource(x[..., :blocks * BLOCK], VOICES,
                                          BLOCK), sink, chunk_blocks=chunk)
        state = model.init_state()
        reset_counts()
        t0 = time.perf_counter()
        state = session.run(state, midi=events())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {
            "ring_mac": rm.ring_mac.launches - rm.ring_mac.launches_bf16,
            "ring_mac_bf16": rm.ring_mac.launches_bf16,
            "mac_shift": ms.mac_shift.launches - ms.mac_shift.launches_bf16,
            "mac_shift_bf16": ms.mac_shift.launches_bf16}
        s = session.summary()
        print(f"chunked {kind} chunk {chunk}: {session.blocks_streamed} "
              f"blocks in {wall:.3f} s, host ms per block p50 "
              f"{s['p50_ms']:.3f} p99 {s['p99_ms']:.3f}, RTF {s['rtf']:.2f}, "
              f"missed {s['missed_deadlines']} of {s['blocks']}, indexed "
              f"blocks {session.indexed_blocks}, general "
              f"{session.general_blocks}, launches {launches}")
        if (session.blocks_streamed != blocks or sink.blocks != blocks
                or not sink.finite):
            raise AssertionError(f"chunked {kind} chunk {chunk}: streamed "
                                 f"{session.blocks_streamed}, delivered "
                                 f"{sink.blocks} of {blocks}")
        return {"out": sink.data(), "summary": s, "launches": launches,
                "wall_s": wall, "model": model, "state": state}

    def compare(kind, got, want, counter, per_block):
        """Chunked against per-block: the same kernel launches, one (two)
        per block, and the output within 2e-5 of scale (bf16: its own
        per-block run, the same limit)."""
        blocks = got["out"].shape[-1] // BLOCK
        scale = float(np.abs(want["out"]).max())
        err = float(np.abs(got["out"] - want["out"]).max())
        print(f"chunked {kind}: chunk {got['chunk']} against per block over "
              f"{blocks} blocks x {VOICES} voices: max_abs_err {err:.3e} "
              f"(limit {2e-5 * scale:.3e}), bit-identical {err == 0.0}; "
              f"{counter} launches {got['launches'][counter]} and "
              f"{want['launches'][counter]} (want {per_block} x {blocks})")
        for run in (got, want):
            launched = run["launches"]
            if (launched[counter] != per_block * blocks
                    or sum(launched.values()) != launched[counter]):
                raise AssertionError(f"chunked {kind}: launches {launched} "
                                     f"in {blocks} blocks")
        if not err <= 2e-5 * scale:
            raise AssertionError(f"chunked {kind}: the chunked run disagrees "
                                 f"with the per-block run")
        return err

    out = {"runs": {}, "errs": {}, "busy": {}}
    # (a) ring 'allk' f32, the CLI's default path
    runs = {}
    for chunk in (1, CHUNK30):
        runs[chunk] = stream("ring", chunk, n, timeline)
        runs[chunk]["chunk"] = chunk
        out["runs"][f"ring_chunk{chunk}"] = runs[chunk]
    out["errs"]["ring"] = compare("ring", runs[CHUNK30], runs[1],
                                  "ring_mac", 1)
    ring8 = runs[CHUNK30]
    out["golden_err"] = check_golden(
        "chunked ring", ring8["out"][[0, VOICES - 1]], x[[0, VOICES - 1]],
        (("before the re-selects, IR 0", 0, CHUNK_SELECT_AT, irs[0]),
         ("after the fades decay, IR 2", CHUNK_AFTER, n, irs[2])),
        predelay=int(ring8["model"].control.predelay[0, 0]))
    # steady device busy per block, per block and in chunks of 8
    model, state = ring8.pop("model"), ring8.pop("state")
    engine, spectra = model.engine, model.spectra
    params = model.control.snapshot_device()
    xs = torch.tensor(x[..., :CHUNK30 * BLOCK].reshape(
        VOICES, 2, CHUNK30, BLOCK).transpose(2, 0, 1, 3).copy(), device=dev)
    busy1, ops1, state = device_busy(engine.step_coef_steady, state, spectra,
                                     params, xs[0])
    busy8, ops8, state = device_busy(make_chunk_step(engine, steady=True),
                                     state, spectra, params, xs, n=8)
    if busy1 is None or busy8 is None:
        raise AssertionError("chunked: the profiler saw no device activity")
    out["busy"] = {1: (busy1, ops1), CHUNK30: (busy8 / CHUNK30,
                                               ops8 / CHUNK30)}
    for chunk, (busy, ops) in out["busy"].items():
        print(f"chunked ring chunk {chunk}: steady device busy {busy:.1f} us "
              f"and {ops:.1f} device ops per block")
    del model, state, engine, spectra, runs[1]["model"], runs[1]["state"]
    torch.cuda.empty_cache()

    # (b) roll 'allk' f32; (c) ring in bf16
    for kind, counter in (("roll", "mac_shift"), ("ring_bf16",
                                                   "ring_mac_bf16")):
        pair = {}
        for chunk in (1, CHUNK30):
            pair[chunk] = stream(kind, chunk, n, timeline)
            pair[chunk]["chunk"] = chunk
            del pair[chunk]["model"], pair[chunk]["state"]
            out["runs"][f"{kind}_chunk{chunk}"] = pair[chunk]
        out["errs"][kind] = compare(kind, pair[CHUNK30], pair[1], counter, 1)
        for run in pair.values():
            del run["out"]
        torch.cuda.empty_cache()

    # (d) the 'allk' cascade in chunks of 16
    def cascade_timeline():
        return MidiSchedule([select(CAS_CHUNK_SELECT_AT, 32),
                             select(CAS_CHUNK_INTERRUPT_AT, 64)])

    pair = {}
    for chunk in (1, CAS_CHUNK):
        pair[chunk] = stream("cascade", chunk, CAS_CHUNK_BLOCKS,
                             cascade_timeline)
        pair[chunk]["chunk"] = chunk
        del pair[chunk]["model"], pair[chunk]["state"]
        out["runs"][f"cascade_chunk{chunk}"] = pair[chunk]
    out["errs"]["cascade"] = compare("cascade", pair[CAS_CHUNK], pair[1],
                                     "ring_mac", 2)
    for run in pair.values():
        del run["out"]
    torch.cuda.empty_cache()

    # (e) run_resilient in chunks: one sink failure, to the bit
    class CountingSource(WavSource):
        """A seekable in-memory source counting the blocks it hands out:
        a chunked session steps every block it reads."""

        reads = 0

        def read(self):
            blk = super().read()
            self.reads += blk is not None
            return blk

    class FailingSink(keep_sink):
        def __init__(self):
            super().__init__(keep_all=True)
            self.failed = False

        def write(self, block):
            if not self.failed and self.blocks == CHUNK_FAIL_AT:
                self.failed = True
                raise RuntimeError("simulated transport failure at "
                                   f"delivered block {self.blocks}")
            super().write(block)

    def build_ring():
        return build("ring")

    sink = FailingSink()
    source = CountingSource(x, VOICES, BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        t0 = time.perf_counter()
        _, summary = run_resilient(
            build_ring, source, sink,
            f"{tmp}/chunked.ckpt", checkpoint_every=CHUNK_EVERY,
            midi=timeline(), session_kwargs={"chunk_blocks": CHUNK30})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    resumes = [r["resume_block"] for r in summary["recoveries"]]
    want_resume = CHUNK_FAIL_AT // CHUNK_EVERY * CHUNK_EVERY
    stepped = source.reads    # replays included
    launches = rm.ring_mac.launches
    err = float(np.abs(sink.data() - ring8["out"]).max())
    print(f"chunked resilient: {wall:.3f} s wall, {summary['restarts']} "
          f"restart (resumed from {resumes}), saves at "
          f"{[s['block_index'] for s in summary['checkpoint_saves']]}, "
          f"ring_mac launches {launches} (want {stepped}), delivered "
          f"{summary['blocks_delivered']}; against the uninterrupted chunked "
          f"run: max_abs_err {err:.3e}, bit-identical {err == 0.0}")
    if (summary["restarts"] != 1 or resumes != [want_resume]
            or summary["blocks_delivered"] != n or sink.blocks != n
            or launches != stepped or stepped <= n):
        raise AssertionError("chunked resilient: the recovery went wrong")
    if err != 0.0:
        raise AssertionError("chunked resilient: the recovered output is not "
                             "the uninterrupted chunked run's")
    out["resilient"] = {"wall_s": wall, "launches": launches,
                        "resume_block": want_resume}
    del ring8["out"]

    # a 'slew' engine has no chunk step
    mono = ConvolutionReverb(bank, num_voices=1, block=BLOCK,
                             sample_rate=RATE, engine="monolithic",
                             fft_size=MONO_FFT, device=dev)
    try:
        mono.session(WavSource(x[:1, :, :BLOCK], 1, BLOCK), keep_sink(),
                     chunk_blocks=CHUNK30)
    except ValueError as exc:
        print(f"chunked monolithic: refused ({exc})")
    else:
        raise AssertionError("a monolithic session took chunk_blocks=8")
    del mono
    torch.cuda.empty_cache()
    return out


def run_ops_surface(irs, dev, reset_counts, rm, ms):
    """Phase 31: the operational surface through the CLI. Phase 4's IRs are
    written as WAVs; `python -m tpu_audio_torch.app.tools` makeindex, then
    bank-info and prebuild-cache, run as subprocesses. The CLI (its main,
    in this process) builds `--engine partitioned --cache-dir` twice: the
    first build computes the spectra and writes the cache, the second reads
    it and computes nothing, and the two output WAVs are equal to the bit.
    Then the CLI's default fmajor route serves 64 voices with
    `--chunk-blocks 8` and under `--profile`, one ring_mac launch per
    block; `tools profile` must list ring_mac among the trace's kernel
    events, and `tools inspect-checkpoint` reads a checkpoint saved here.
    Returns the figures."""
    import contextlib
    import io
    import os
    import re
    import tempfile

    from tpu_audio_torch.app.main import main as app_main
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.io.wav import write_wav
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.checkpoint import save_checkpoint
    from tpu_audio_torch.utils.log import Log

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TPU_AUDIO_LOG="warn",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = []

    def tools(*args):
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_audio_torch.app.tools", *args],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        procs.append(proc)
        return proc

    def finish(proc, label):
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"tools {label} exited {proc.returncode}: "
                                 f"{out[-400:]} {err[-400:]}")
        return out

    spectra_calls = []
    compute = IRBank.partitioned_spectra

    def counted(self, *args, **kwargs):
        spectra_calls.append(1)
        return compute(self, *args, **kwargs)

    def cli(args, label):
        """The CLI's main with its info log captured; returns (log, wall
        s, ring_mac launches)."""
        log, level = io.StringIO(), Log.level
        reset_counts()
        t0 = time.perf_counter()
        try:
            Log.level = 3
            with contextlib.redirect_stdout(log):
                rc = app_main([*args, "--block-size", str(BLOCK),
                               "--sample-rate", str(RATE), "--device",
                               dev.type])
        finally:
            Log.level = level
        wall = time.perf_counter() - t0
        text = log.getvalue()
        summary = re.search(r"streamed \d+ blocks.*", text)
        print(f"CLI {label}: exited {rc} after {wall:.2f} s, ring_mac "
              f"launches {rm.ring_mac.launches}, mac_shift "
              f"{ms.mac_shift.launches}: "
              f"{summary.group(0) if summary else text[-400:]}")
        if rc != 0 or not summary:
            raise AssertionError(f"CLI {label} failed")
        return text, wall, rm.ring_mac.launches

    t_phase = time.perf_counter()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.makedirs(f"{tmp}/irs")
            for k, ir in enumerate(irs):
                write_wav(f"{tmp}/irs/ir{k}.wav", ir.T, RATE, bits=32)
            index = f"{tmp}/all.index"
            finish(tools("makeindex", f"{tmp}/irs", "-o", index), "makeindex")
            with open(index) as fh:
                entries = fh.read().split()
            # the tools run while this process drives the CLI: bank-info
            # and prebuild-cache now, inspect-checkpoint once the
            # checkpoint is saved, profile once the trace is written
            info = tools("bank-info", index)
            pre = tools("prebuild-cache", index, "--cache-dir",
                        f"{tmp}/prebuilt", "--quiet")
            model = ConvolutionReverb(IRBank.from_index(index, verbose=False),
                                      block=BLOCK, sample_rate=RATE,
                                      device=dev)
            save_checkpoint(f"{tmp}/ops.ckpt", model.init_state(),
                            model.control, meta={"block_index": 0})
            del model
            inspect = tools("inspect-checkpoint", f"{tmp}/ops.ckpt")
            settings = f"{tmp}/settings.txt"
            with open(settings, "w") as fh:
                fh.write("conv.count 2\n" + "".join(
                    f"conv[{c}].index {index}\nconv[{c}].maxPredelay 8192\n"
                    f"conv[{c}].cc.message 176\n"
                    f"conv[{c}].cc.select {SELECT_CC}\n"
                    f"conv[{c}].value.predelay 1024\n"
                    f"conv[{c}].value.wet 0.7\nconv[{c}].value.dry 0.2\n"
                    for c in range(2)))
            common = ["--settings", settings, "--signal", "noise"]

            # the partitioned engine's spectra cache: a miss, then a hit
            IRBank.partitioned_spectra = counted
            builds, calls = [], []
            try:
                for run in range(2):
                    text, _, _ = cli(common + [
                        "--engine", "partitioned", "--cache-dir",
                        f"{tmp}/cache", "--blocks", str(OPS_CACHE_BLOCKS),
                        "--output", f"{tmp}/part{run}.wav"],
                        f"partitioned --cache-dir, run {run + 1}")
                    built = re.search(r"model built in (\S+) s", text)
                    cache_line = re.search(r"spectra cache (hit|write)", text)
                    builds.append(float(built.group(1)))
                    calls.append((len(spectra_calls),
                                  cache_line.group(1) if cache_line
                                  else None))
            finally:
                IRBank.partitioned_spectra = compute
            with open(f"{tmp}/part0.wav", "rb") as a, \
                    open(f"{tmp}/part1.wav", "rb") as b:
                same = a.read() == b.read()
            print(f"CLI partitioned --cache-dir: build {builds[0]:.3f} s "
                  f"({calls[0][1]}, spectra computed {calls[0][0]} time), "
                  f"then {builds[1]:.3f} s ({calls[1][1]}, computed "
                  f"{calls[1][0] - calls[0][0]} more); output WAVs equal to "
                  f"the bit: {same}")
            if (calls != [(1, "write"), (1, "hit")] or not same
                    or len(os.listdir(f"{tmp}/cache")) != 1):
                raise AssertionError("CLI --cache-dir: the second build did "
                                     "not hit the cache, or the outputs "
                                     "differ")

            # the default fmajor route at full width, chunked and profiled
            voices = ["--voices", str(VOICES)]
            _, chunk_s, chunk_launches = cli(
                common + voices + ["--chunk-blocks", str(CHUNK30),
                                   "--blocks", str(OPS_CHUNK_BLOCKS)],
                f"fmajor --chunk-blocks {CHUNK30}")
            _, prof_s, prof_launches = cli(
                common + voices + ["--profile", f"{tmp}/prof", "--blocks",
                                   str(OPS_PROFILE_BLOCKS)],
                "fmajor --profile")
            if (chunk_launches != OPS_CHUNK_BLOCKS
                    or prof_launches != OPS_PROFILE_BLOCKS):
                raise AssertionError(f"CLI fmajor: ring_mac launches "
                                     f"{chunk_launches} / {prof_launches}")
            prof = tools("profile", f"{tmp}/prof", "--top", "40")
            info_out = finish(info, "bank-info")
            finish(pre, "prebuild-cache")
            prebuilt = os.listdir(f"{tmp}/prebuilt")
            print(f"tools makeindex: {len(entries)} entries; bank-info: "
                  f"{info_out.splitlines()[0]}; prebuild-cache: {prebuilt}")
            if (entries != sorted(entries) or len(entries) != NUM_IRS
                    or f"{NUM_IRS} IRs" not in info_out
                    or len(prebuilt) != 1
                    or not prebuilt[0].startswith("bank_")):
                raise AssertionError("tools makeindex / bank-info / "
                                     "prebuild-cache went wrong")
            prof_out = finish(prof, "profile")
            inspect_out = finish(inspect, "inspect-checkpoint")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    kernel = prof_out.split("\ncategory 'kernel'")
    kernel = kernel[1].split("\ncategory ")[0] if len(kernel) > 1 else ""
    ring_rows = [line for line in kernel.splitlines() if "ring_mac" in line]
    print(f"tools profile: {prof_out.splitlines()[0]}; its kernel events"
          f"{kernel.splitlines()[0] if kernel else ': none'}")
    for line in kernel.splitlines()[1:12]:
        print(f"  {line.strip()}")
    print(f"tools inspect-checkpoint: {len(inspect_out.splitlines())} lines, "
          f"state fields "
          f"{sum(line.startswith('state.') for line in inspect_out.splitlines())}")
    if not ring_rows:
        raise AssertionError("tools profile: no ring_mac among the trace's "
                             "kernel events")
    if ('"block_index": 0' not in inspect_out
            or "state.fdl: shape=" not in inspect_out):
        raise AssertionError("tools inspect-checkpoint went wrong")
    ring_row = ring_rows[0].split()
    return {"launches": chunk_launches + prof_launches,
            "build_miss_s": builds[0], "build_hit_s": builds[1],
            "chunk_cli_s": chunk_s, "profile_cli_s": prof_s,
            "profile_ring_mac_count": int(ring_row[1]),
            "profile_ring_mac_p50_ms": float(ring_row[2]),
            "wall_s": time.perf_counter() - t_phase}


def hold_mesh_shapes(seen, launches, rm, ms, dev):
    """Phase 32 (h): each kernel at each shape the mesh runs called it at
    (`seen`, a ShapeProbe's), on random operands of the run's dtype,
    against its plain version (check_ring_mac, check_mac_shift), then timed
    beside its bound (time_ring_mac, time_mac_shift, 100 calls a run). A
    kernel the mesh runs launched (`launches`) with no shape recorded
    fails. Returns ({kernel: largest error}, {kernel: {shape: timing}})."""
    import torch

    missing = [k for k, n in launches.items()
               if n and not any(key[0] == k for key in seen)]
    if missing:
        raise AssertionError(f"phase 32 (h): no shape recorded for {missing}")
    gen = torch.Generator(device=dev).manual_seed(32)
    errs, timed = {}, {}
    for (kernel, f, vi, pp, kod), calls in sorted(seen.items()):
        dtype = torch.bfloat16 if kernel.endswith("_bf16") else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        label = f"{kernel} mesh shard, {calls} calls"
        fdl = randn(f, vi, 2, pp)
        if kernel.startswith("ring_mac"):
            rhs2 = randn(f, 2, 2 * pp, kod)
            err = check_ring_mac(rm, fdl, rhs2, label)
            t = time_ring_mac(rm, fdl, rhs2, reps=100)
            del rhs2
        else:
            xn, rhs = randn(f, vi, 2, 1), randn(f, 2, pp, kod)
            err = check_mac_shift(ms, fdl, xn, rhs, label)
            t = time_mac_shift(ms, fdl, xn, rhs, reps=100)
            del xn, rhs
        errs[kernel] = max(errs.get(kernel, 0.0), err)
        timed.setdefault(kernel, {})[f"f{f}_vi{vi}_pp{pp}_kod{kod}"] = t
        library = (f", library {t['library'] * 1e3:.2f} us"
                   if "library" in t else "")
        print(f"{kernel} timing [mesh shard F={f} VI={vi} Pp={pp} KOD={kod}]"
              f": kernel {t['kernel'] * 1e3:.2f} us "
              f"({100 * t['bound'] / t['kernel']:.1f} % of the "
              f"{t['bound'] * 1e3:.2f} us bound by {t['bound_by']}), plain "
              f"{t['plain'] * 1e3:.2f} us{library}")
        del fdl
        torch.cuda.empty_cache()
    return errs, timed


def run_mesh(bank, irs, ws_bank, dev, configure, select, reset_counts, rm,
             ms):
    """Phase 32: the device mesh (tpu_audio_torch/parallel/mesh.py). Every
    CUDA device when the machine has two or more, else virtual shards on
    `dev` (shard i on card i mod the card count). Each run is held against
    the same run on one device: (a) ring 'allk' f32, 64 voices, voice=2
    (and 4 with four cards), 800 blocks of phase 4's timeline, to 2e-6
    abs, phase 4's golden, a checkpoint every 97 blocks; (b) roll 'allk'
    f32, voice=1 x part=2, 400 blocks, a re-select, a swap_bank mid-fade
    and an interrupt (the general step), to 2e-5 of scale; (c) roll bf16,
    voice=2 x part=2, 200 blocks, SNR >= 40 dB against (b)'s f32 run on one
    device; (d) the cascade in bf16, read side, 2560 voices, voice=2, 200
    blocks, a re-select at 100, to 2e-6 abs; (e) the working set, 152 IRs
    through 16 slots, voice=2, 200 blocks, a new IR every 32 blocks: the
    same faults and hits, to 2e-6 abs; (f) a resume on the mesh from (a)'s
    last checkpoint against (a)'s tail, and the same file resumed on one
    device; (g) render_offline over voice=2, fmajor ring and the cascade,
    10 s in 16 segments (whole stagger groups per lane, so the same steps
    as on one device, twice the launches), to 3e-5; (h) every kernel at
    every shape the mesh runs gave it (a ShapeProbe records them) against
    its plain version, and timed beside its bound (hold_mesh_shapes).
    Each run prints host ms per block p50 / p99, RTF, missed deadlines,
    launches per block and, for a session, the device busy time of its
    sharded steady step per block (all shards). Returns the figures."""
    import tempfile

    import torch

    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.parallel import make_mesh
    from tpu_audio_torch.runtime.backends import (
        BlockSink, BlockSource, WavSource,
    )
    from tpu_audio_torch.runtime.checkpoint import load_checkpoint
    from tpu_audio_torch.runtime.offline import render_offline
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    # the shapes the mesh runs give each kernel, held at the end
    probe = ShapeProbe()

    def mesh_of(voice, part=1):
        n = voice * part
        devices = ([dev] * n if cards < 2 else
                   [torch.device("cuda", i % cards) for i in range(n)])
        mesh = make_mesh(devices=devices, part=part)
        print(f"mesh: voice={voice} x part={part}, "
              f"{'real' if cards >= 2 else 'virtual'} shards over "
              f"{len(mesh.distinct)} distinct device(s) "
              f"({', '.join(map(str, mesh.distinct))})")
        return mesh

    class Keep(BlockSink):
        """Keeps the rows `rows` of every block (all with None)."""

        def __init__(self, rows=None):
            self.rows, self.kept, self.finite, self.blocks = rows, [], True, 0

        def write(self, block):
            self.finite &= bool(np.isfinite(block).all())
            self.kept.append((block if self.rows is None
                              else block[self.rows]).copy())
            self.blocks += 1

        def data(self):
            return np.concatenate(self.kept, axis=-1)

    def noise(voices, blocks, seed=0):
        """NoiseSource(voices, BLOCK, blocks, 0.01, seed)'s blocks as one
        per-voice array, so that a resume can start anywhere in it."""
        rng = np.random.default_rng(seed)
        return np.concatenate(
            [(rng.standard_normal((voices, 2, BLOCK)) * 0.01
              ).astype(np.float32) for _ in range(blocks)], axis=-1)

    def launches():
        return {"ring_mac": rm.ring_mac.launches - rm.ring_mac.launches_bf16,
                "ring_mac_bf16": rm.ring_mac.launches_bf16,
                "mac_shift": ms.mac_shift.launches
                - ms.mac_shift.launches_bf16,
                "mac_shift_bf16": ms.mac_shift.launches_bf16}

    def serve(label, session, state, **run_kwargs):
        reset_counts()
        probe.on = session.mesh is not None
        t0 = time.perf_counter()
        state = session.run(state, **run_kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        probe.on = False
        s = session.summary()
        n = launches()
        print(f"{label}: {session.blocks_streamed} blocks in {wall:.3f} s, "
              f"p50 / p99 {s['p50_ms']:.3f} / {s['p99_ms']:.3f} ms per "
              f"block, RTF {s['rtf']:.3f}, missed {s['missed_deadlines']}, "
              f"launches {n}")
        return state, {"summary": s, "wall_s": wall, "launches": n}

    def busy(label, session, state, voices):
        """Device busy per block of the session's (sharded) steady step,
        summed over the shards."""
        x = torch.randn((voices, 2, BLOCK), device=dev) * 0.01
        probe.on = True
        us, ops, _ = device_busy(session._eng.step_coef_steady, state,
                                 session._eng.place_bank(session.bank),
                                 session.control.snapshot_device(), x, n=10)
        probe.on = False
        print(f"{label}: steady step device busy "
              + ("not measured" if us is None else
                 f"{us:.1f} us in {ops:.1f} device ops per block, all "
                 f"shards"))
        return us, ops

    def compare(label, got, want, limit, relative=False):
        err = float(np.abs(got.astype(np.float64) - want).max())
        scale = float(np.abs(want).max())
        bound = limit * scale if relative else limit
        exact = bool(np.array_equal(got, want))
        print(f"{label}: max_abs_err {err:.3e} (limit {bound:.3e}"
              f"{' = %g of scale %.3e' % (limit, scale) if relative else ''})"
              f", bit-identical {exact}")
        if not (err <= bound and scale > 1e-3):
            raise AssertionError(f"{label}: {err:.3e} against one device")
        return err, exact

    def lap(what):
        print(f"phase 32: {what} done at {time.perf_counter() - t_phase:.1f}"
              f" s")

    def expect(label, got, want):
        if got != want:
            raise AssertionError(f"{label}: launches {got}, wanted {want}")

    out = {"runs": {}, "errs": {}, "exact": {}, "busy": {}}
    timeline = [select(SELECT_AT, 32), select(INTERRUPT_AT, 64)]

    # (a) ring 'allk' f32, voice=2, checkpoints every 97 blocks; (f) resume
    x_a = noise(VOICES, BLOCKS)

    def ring_model():
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, engine="fmajor",
                                  max_predelay=8192, device=dev)
        configure(model.control)
        return model

    single = ring_model()
    sink1 = Keep()
    sess1 = single.session(WavSource(x_a, VOICES, BLOCK), sink1)
    _, fig = serve("mesh (a) ring f32, one device", sess1,
                   single.init_state(), midi=MidiSchedule(list(timeline)))
    want_a = sink1.data()
    out["runs"]["a_single"] = fig
    tmp = tempfile.mkdtemp(prefix="mesh32_")
    ckpt = f"{tmp}/ring.ckpt"
    voices_a = (2, 4) if cards >= 4 else (2,)
    for voice in voices_a:
        mesh = mesh_of(voice)
        model = ring_model()
        sink = Keep()
        session = model.session(WavSource(x_a, VOICES, BLOCK), sink,
                                mesh=mesh)
        kwargs = ({"checkpoint_path": ckpt, "checkpoint_every": MESH_EVERY}
                  if voice == 2 else {})
        state, fig = serve(f"mesh (a) ring f32, voice={voice}", session,
                           model.init_state(),
                           midi=MidiSchedule(list(timeline)), **kwargs)
        expect(f"(a) voice={voice}", fig["launches"],
               {"ring_mac": voice * BLOCKS, "ring_mac_bf16": 0,
                "mac_shift": 0, "mac_shift_bf16": 0})
        if session.indexed_blocks < 20 or session.general_blocks:
            raise AssertionError(f"(a): {session.indexed_blocks} indexed, "
                                 f"{session.general_blocks} general blocks")
        if not sink.finite or sink.blocks != BLOCKS:
            raise AssertionError(f"(a): {sink.blocks} blocks, finite "
                                 f"{sink.finite}")
        got_a = sink.data()
        key = f"a_voice{voice}"
        out["errs"][key], out["exact"][key] = compare(
            f"mesh (a) voice={voice} against one device", got_a, want_a,
            2e-6)
        out["golden_err"] = check_golden(
            f"mesh (a) voice={voice}", got_a[[0, VOICES - 1]],
            x_a[[0, VOICES - 1]],
            (("before the re-selects, IR 0", 0, SELECT_AT, irs[0]),
             ("after the fades decay, IR 2", 500, BLOCKS, irs[2])),
            predelay=int(model.control.predelay[0, 0]), voices=VOICES)
        out["busy"][key] = busy(f"mesh (a) voice={voice}", session, state,
                                VOICES)
        out["runs"][key] = fig
        if voice == 2:
            saves = session.checkpoint_saves
            fig["saves"] = len(saves)
            fig["save_block_ms_max"] = max(s["block_s"] for s in saves) * 1e3
            got_full = got_a
        del model, session, state

    # (f) resume on the mesh from the last save, and on one device
    resumed = {}
    for where in ("mesh", "one device"):
        model = ring_model()
        state, meta = load_checkpoint(ckpt, model.init_state(),
                                      model.control)
        start = meta["block_index"]
        sink = Keep()
        midi = MidiSchedule(list(timeline))
        midi.rewind_to(start)
        session = model.session(
            WavSource(x_a[..., start * BLOCK:], VOICES, BLOCK), sink,
            mesh=mesh_of(2) if where == "mesh" else None)
        state, fig = serve(f"mesh (f) resume at {start} on {where}", session,
                           state, midi=midi, start_block=start)
        resumed[where] = sink.data()
        ref = got_full if where == "mesh" else want_a
        key = "f_mesh" if where == "mesh" else "f_single"
        out["errs"][key], out["exact"][key] = compare(
            f"mesh (f) resumed on {where} against the uninterrupted run",
            resumed[where], ref[..., start * BLOCK:], 2e-6)
        out["runs"][key] = fig
        out["resume_block"] = start
        del model, session, state

    lap("(a) and (f)")

    # (b) roll 'allk' f32, voice=1 x part=2; (c) roll bf16, voice=2 x part=2
    partitions = bank.max_partitions(BLOCK)
    swapped = IRBank(sample_rate=RATE)
    for k in ROLL_PERM:
        swapped.append(irs[k] * np.float32(0.5))
    x_b = x_a[..., :MESH_ROLL_BLOCKS * BLOCK]

    def roll_run(label, key, mac_dtype, blocks, mesh, events=True):
        eng = FMajorPartitionedConvolution(
            VOICES, BLOCK, partitions, max_predelay=8192, ring=False,
            mac_strategy="allk", num_irs=NUM_IRS, mac_dtype=mac_dtype,
            device=dev)
        spectra = bank.partitioned_spectra(BLOCK)
        roll_bank = eng.prepare_bank(spectra)
        cp = ControlPlane(VOICES, NUM_IRS, 8192, device=dev)
        configure(cp)
        sink = Keep()
        session = StreamSession(eng, roll_bank, cp,
                                WavSource(x_b[..., :blocks * BLOCK], VOICES,
                                          BLOCK), sink, sample_rate=RATE,
                                mesh=mesh)
        state = eng.init_converged(roll_bank, cp.snapshot_device())
        exchanges = mesh.exchanges if mesh is not None else 0
        if events:
            state, fig = serve(label + " (to the swap)", session, state,
                               max_blocks=ROLL_SWAP_AT,
                               midi=MidiSchedule([select(SELECT_AT, 32)]))
            n = fig["launches"]
            session.swap_bank(eng.prepare_bank(
                swapped.partitioned_spectra(BLOCK)))
            state, fig = serve(label, session, state, midi=MidiSchedule(
                [select(ROLL_INTERRUPT_AT - ROLL_SWAP_AT, 64)]))
            fig["launches"] = {k: v + n[k] for k, v in fig["launches"].items()}
            if session.general_blocks < 60 or session.indexed_blocks < 15:
                raise AssertionError(f"{label}: {session.indexed_blocks} "
                                     f"indexed, {session.general_blocks} "
                                     f"general blocks")
        else:
            state, fig = serve(label, session, state)
        if not sink.finite or session.blocks_streamed != blocks:
            raise AssertionError(f"{label}: {session.blocks_streamed} blocks,"
                                 f" finite {sink.finite}")
        if mesh is not None:
            fig["exchanges_per_block"] = (mesh.exchanges - exchanges) / blocks
            print(f"{label}: {fig['exchanges_per_block']:.2f} part-axis "
                  f"exchanges per block")
            out["busy"][key] = busy(label, session, state, VOICES)
        return sink.data(), fig

    want_b, out["runs"]["b_single"] = roll_run(
        "mesh (b) roll f32, one device", "b_single", "f32", MESH_ROLL_BLOCKS,
        None)
    got_b, fig = roll_run("mesh (b) roll f32, voice=1 x part=2", "b", "f32",
                          MESH_ROLL_BLOCKS, mesh_of(1, 2))
    expect("(b)", fig["launches"], {"ring_mac": 0, "ring_mac_bf16": 0,
                                     "mac_shift": 2 * MESH_ROLL_BLOCKS,
                                     "mac_shift_bf16": 0})
    out["runs"]["b"] = fig
    out["errs"]["b"], out["exact"]["b"] = compare(
        "mesh (b) roll voice=1 x part=2 against one device", got_b, want_b,
        2e-5, relative=True)
    got_c, fig = roll_run("mesh (c) roll bf16, voice=2 x part=2", "c",
                          "bf16", MESH_BF16_BLOCKS, mesh_of(2, 2),
                          events=False)
    expect("(c)", fig["launches"], {"ring_mac": 0, "ring_mac_bf16": 0,
                                     "mac_shift": 0,
                                     "mac_shift_bf16": 4 * MESH_BF16_BLOCKS})
    out["runs"]["c"] = fig
    out["c_snr"] = snr_db(got_c, want_b[..., :MESH_BF16_BLOCKS * BLOCK])
    print(f"mesh (c) roll bf16 voice=2 x part=2 against roll f32 on one "
          f"device: SNR {out['c_snr']:.2f} dB (limit 40)")
    if not out["c_snr"] >= 40.0:
        raise AssertionError(f"(c): SNR {out['c_snr']:.2f} dB")

    lap("(b) and (c)")

    # (d) the cascade, bf16, read side, 2560 voices, voice=2
    cas_voices, cas_blocks = MESH_CAS_VOICES, MESH_CAS_BLOCKS
    rng = np.random.default_rng(5)
    cycle = [(rng.standard_normal((cas_voices, 2, BLOCK)) * 0.01
              ).astype(np.float32) for _ in range(16)]

    class Cycle(BlockSource):
        """16 noise blocks of 2560 voices, cycled."""

        def __init__(self):
            self.i = 0

        def read(self):
            if self.i >= cas_blocks:
                return None
            self.i += 1
            return cycle[(self.i - 1) % 16]

    rows = np.r_[0:cas_voices:16, cas_voices // 2 - 1, cas_voices // 2,
                 cas_voices - 1]
    cas = {}
    for where in ("one device", "voice=2"):
        torch.cuda.synchronize()
        for d in range(cards):
            torch.cuda.reset_peak_memory_stats(d)
        model = ConvolutionReverb(bank, num_voices=cas_voices, block=BLOCK,
                                  sample_rate=RATE, engine="cascade",
                                  max_predelay=8192, cascade_ratio=CAS_RATIO,
                                  predelay_side="read", mac_dtype="bf16",
                                  device=dev)
        configure(model.control)
        sink = Keep(rows)
        mesh = mesh_of(2) if where != "one device" else None
        session = model.session(Cycle(), sink, mesh=mesh)
        state, fig = serve(f"mesh (d) cascade bf16 {cas_voices} voices, "
                           f"{where}", session, model.init_state(),
                           midi=MidiSchedule([select(MESH_CAS_SELECT_AT,
                                                     32)]))
        shards = 1 if mesh is None else 2
        expect(f"(d) {where}", fig["launches"],
               {"ring_mac": 0, "ring_mac_bf16": 2 * shards * cas_blocks,
                "mac_shift": 0, "mac_shift_bf16": 0})
        if not sink.finite or session.indexed_blocks < 20:
            raise AssertionError(f"(d) {where}: finite {sink.finite}, "
                                 f"{session.indexed_blocks} indexed blocks")
        fig["peak_mb"] = {str(torch.device("cuda", d)):
                          torch.cuda.max_memory_allocated(d) / 1e6
                          for d in range(cards)}
        print(f"mesh (d) {where}: peak allocated per device "
              f"{fig['peak_mb']} MB")
        if mesh is not None:
            out["busy"]["d"] = busy(f"mesh (d) cascade {cas_voices} voices, "
                                    f"voice=2", session, state, cas_voices)
        cas[where] = sink.data()
        out["runs"]["d_single" if mesh is None else "d"] = fig
        del model, session, state
        torch.cuda.empty_cache()
    out["errs"]["d"], out["exact"]["d"] = compare(
        f"mesh (d) cascade {cas_voices} voices voice=2 against one device",
        cas["voice=2"], cas["one device"], 2e-6)

    lap("(d)")

    # (e) the working set: 152 IRs through 16 slots, voice=2
    churn = [select(16 + 32 * j, 20 + 7 * j) for j in range(6)]
    x_e = x_a[..., :MESH_WS_BLOCKS * BLOCK]
    ws_out = {}
    for where in ("one device", "voice=2"):
        model = ConvolutionReverb(ws_bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, max_predelay=8192,
                                  bank_capacity=WS_CAPACITY, device=dev)
        configure(model.control)
        sink = Keep()
        mesh = mesh_of(2) if where != "one device" else None
        session = model.session(WavSource(x_e, VOICES, BLOCK), sink,
                                mesh=mesh)
        state, fig = serve(f"mesh (e) working set, {where}", session,
                           model.init_state(), midi=MidiSchedule(list(churn)))
        ws = model.working_set
        fig["misses"], fig["hits"] = ws.misses, ws.hits
        print(f"mesh (e) {where}: misses {ws.misses}, hits {ws.hits}")
        expect(f"(e) {where}", fig["launches"],
               {"ring_mac": (1 if mesh is None else 2) * MESH_WS_BLOCKS,
                "ring_mac_bf16": 0, "mac_shift": 0, "mac_shift_bf16": 0})
        if mesh is not None:
            out["busy"]["e"] = busy("mesh (e) working set, voice=2",
                                    session, state, VOICES)
        ws_out[where] = (sink.data(), ws.misses, ws.hits)
        out["runs"]["e_single" if mesh is None else "e"] = fig
        ws.close()
        del model, session, state
    if ws_out["voice=2"][1:] != ws_out["one device"][1:] or \
            ws_out["one device"][1] < 6:
        raise AssertionError(f"(e): misses and hits {ws_out['voice=2'][1:]} "
                             f"against {ws_out['one device'][1:]}")
    out["errs"]["e"], out["exact"]["e"] = compare(
        "mesh (e) working set voice=2 against one device",
        ws_out["voice=2"][0], ws_out["one device"][0], 2e-6)

    lap("(e)")

    # (g) the bounce over voice=2: fmajor ring and the cascade, 10 s
    seconds = MESH_BOUNCE_SECONDS
    program = (np.random.default_rng(7).standard_normal(
        (2, int(seconds * RATE))) * 0.01).astype(np.float32)
    for engine in ("fmajor", "cascade"):
        kwargs = ({"cascade_ratio": CAS_RATIO} if engine == "cascade" else {})
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, engine=engine,
                                  max_predelay=8192, device=dev, **kwargs)
        configure(model.control)
        got = {}
        for where in ("one device", "voice=2"):
            mesh = mesh_of(2) if where != "one device" else None
            reset_counts()
            probe.on = mesh is not None
            t0 = time.perf_counter()
            got[where] = render_offline(model, program, mesh=mesh,
                                        segments=MESH_BOUNCE_SEGMENTS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            probe.on = False
            n = launches()
            print(f"mesh (g) bounce {engine}, {where}: {seconds} s of "
                  f"{VOICES} voices in {wall:.3f} s = {seconds / wall:.2f}x "
                  f"real time, launches {n}")
            key = "one_device" if mesh is None else "voice2"
            out["runs"][f"g_{engine}_{key}"] = {
                "wall_s": wall, "x_real_time": seconds / wall,
                "launches": n}
        single_n = out["runs"][f"g_{engine}_one_device"]["launches"]
        expect(f"(g) {engine}", n, {k: 2 * v for k, v in single_n.items()})
        out["errs"][f"g_{engine}"], out["exact"][f"g_{engine}"] = compare(
            f"mesh (g) bounce {engine} voice=2 against one device",
            got["voice=2"], got["one device"], 3e-5)
        del model
    torch.cuda.empty_cache()
    probe.close()
    lap("(g)")

    # (h) every kernel at every shape the mesh runs gave it, against its
    # plain version on random operands, then timed beside its bound
    out["launches"] = {k: sum(r["launches"][k] for r in out["runs"].values())
                       for k in ("ring_mac", "ring_mac_bf16", "mac_shift",
                                 "mac_shift_bf16")}
    out["kernel_err"], out["kernel_ms"] = hold_mesh_shapes(
        probe.seen, out["launches"], rm, ms, dev)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 32: {out['wall_s']:.1f} s wall, launches "
          f"{out['launches']}")
    return out


def run_roll96(bank, irs, dev, configure, select, reset_counts, rm, ms):
    """Phase 33: roll mode at 96 voices, whose VI = 192 delay-line rows are
    no multiple of 128, so every step runs mac_shift's small tiles (f32:
    three 64-row tiles a bin; bf16: two tiles of 6 warp slabs). Phase 4's
    4 IRs, ring=False, 'allk', 400 blocks in f32 then in bf16 through
    StreamSession with phase 7's controls: a re-select at 60 (the indexed
    step), a swap_bank mid-fade at 80 (the general step) and an interrupt
    at 86. Every block must launch mac_shift (the bf16 form in bf16) and
    none ring_mac; f32 voices 0, 40, 64 and 95 (a row in each tile) must
    match the golden before the re-select and once the fades decay against
    the new bank, the bf16 run track the f32 one at >= 40 dB SNR. Then
    each form at the session's own shape against its plain version, timed
    beside its bound, and the steady step's device busy. Returns the
    figures."""
    import torch

    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import ControlPlane
    from tpu_audio_torch.runtime.backends import BlockSink, NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    class RowSink(BlockSink):
        """Keeps voices ROLL96_ROWS; checks every block is finite."""

        def __init__(self):
            self.kept, self.finite, self.blocks = [], True, 0

        def write(self, block):
            self.finite &= bool(np.isfinite(block).all())
            self.kept.append(block[list(ROLL96_ROWS)].copy())
            self.blocks += 1

        def data(self):
            return np.concatenate(self.kept, axis=-1)

    voices, t_phase = ROLL96_VOICES, time.perf_counter()
    new_irs = [irs[k] * np.float32(0.5) for k in ROLL_PERM]
    swapped = IRBank(sample_rate=RATE)
    for ir in new_irs:
        swapped.append(ir)
    xt = torch.randn((voices, 2, BLOCK), device=dev) * 0.01
    out = {"runs": {}, "kernel_ms": {}, "kernel_err": {}}
    outs = {}
    for dtype in ("f32", "bf16"):
        name = f"roll {voices} voices {dtype}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        roll = FMajorPartitionedConvolution(
            voices, BLOCK, bank.max_partitions(BLOCK), max_predelay=8192,
            ring=False, mac_strategy="allk", num_irs=NUM_IRS,
            swap_snapshot=True, mac_dtype=dtype, device=dev)
        roll_bank = roll.prepare_bank(bank.partitioned_spectra(BLOCK))
        roll_bank2 = roll.prepare_bank(swapped.partitioned_spectra(BLOCK))
        build_s = time.perf_counter() - t0
        cp = ControlPlane(voices, NUM_IRS, 8192, device=dev)
        configure(cp)
        sink = RowSink()
        session = StreamSession(
            roll, roll_bank, cp,
            NoiseSource(voices, BLOCK, ROLL96_BLOCKS, amplitude=0.01, seed=0),
            sink, sample_rate=RATE)
        state = roll.init_converged(roll_bank, cp.snapshot_device())
        reset_counts()
        t0 = time.perf_counter()
        state = session.run(state, max_blocks=ROLL96_SWAP_AT,
                            midi=MidiSchedule([select(ROLL96_SELECT_AT, 32)]))
        indexed_before_swap = session.indexed_blocks
        session.swap_bank(roll_bank2)
        state = session.run(state, midi=MidiSchedule(
            [select(ROLL96_INTERRUPT_AT - ROLL96_SWAP_AT, 64)]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = (ms.mac_shift.launches, ms.mac_shift.launches_bf16,
                    rm.ring_mac.launches)
        steps = session.blocks_streamed
        print(f"{name}: {steps} blocks, mac_shift launches {launches[0]} "
              f"({launches[1]} bf16), ring_mac {launches[2]}, indexed blocks "
              f"{session.indexed_blocks} ({indexed_before_swap} before the "
              f"swap), general {session.general_blocks}, line "
              f"{state.fdl.dtype} {tuple(state.fdl.shape)}")
        want = (steps, steps if dtype == "bf16" else 0, 0)
        if steps != ROLL96_BLOCKS or sink.blocks != ROLL96_BLOCKS:
            raise AssertionError(f"{name}: streamed {steps} blocks, "
                                 f"delivered {sink.blocks}")
        if launches != want or state.fdl.shape[1] != 2 * voices:
            raise AssertionError(f"{name}: launches {launches} in {steps} "
                                 f"steps, line {tuple(state.fdl.shape)}")
        if (session.bank is not roll_bank2 or indexed_before_swap < 15
                or session.indexed_blocks != indexed_before_swap
                or session.general_blocks < 60):
            raise AssertionError(f"{name}: {session.indexed_blocks} indexed "
                                 f"blocks ({indexed_before_swap} before the "
                                 f"swap), {session.general_blocks} general")
        if not sink.finite or not float(state.coef_a.max()) < 1e-6:
            raise AssertionError(f"{name}: finite {sink.finite}, the fades "
                                 f"decayed {float(state.coef_a.max()) < 1e-6}")
        outs[dtype] = sink.data()
        if dtype == "f32":
            out["golden_err"] = check_golden(
                name, outs[dtype],
                noise_input(ROLL96_BLOCKS, voices, rows=ROLL96_ROWS),
                (("before the re-select, IR 0", 0, ROLL96_SELECT_AT, irs[0]),
                 ("after the fades decay, new bank IR 2 = 0.5 * IR "
                  f"{ROLL_PERM[2]}", ROLL96_AFTER, ROLL96_BLOCKS,
                  new_irs[2])),
                predelay=int(cp.predelay[0, 0]), voices=voices,
                rows=ROLL96_ROWS)
        else:
            out["snr"] = snr_db(outs["bf16"], outs["f32"])
            print(f"{name}: voices {ROLL96_ROWS} against the f32 run, all "
                  f"{ROLL96_BLOCKS} blocks: SNR {out['snr']:.2f} dB (limit "
                  f"40)")
            if not out["snr"] >= 40.0:
                raise AssertionError(f"{name}: SNR {out['snr']:.2f} dB")
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        figures = session_figures(name, session, run_s, build_s, peak_mb,
                                  roll.step_coef_steady, state,
                                  xt,
                                  f"{name} step_coef_steady")
        figures["launches"] = launches[1] if dtype == "bf16" else launches[0]
        out["runs"][dtype] = figures

        # the kernel at the session's own shape, on random operands
        kernel = "mac_shift_bf16" if dtype == "bf16" else "mac_shift"
        f, vi, _, pp = state.fdl.shape
        kod = roll_bank.mac_rhs.shape[3]
        del session, state, roll, roll_bank, roll_bank2
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(33)
        op_dtype = torch.bfloat16 if dtype == "bf16" else torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(op_dtype)

        fdl, xn, rhs = randn(f, vi, 2, pp), randn(f, vi, 2, 1), randn(
            f, 2, pp, kod)
        label = f"{kernel} at the {voices}-voice roll session's shape"
        out["kernel_err"][kernel] = check_mac_shift(ms, fdl, xn, rhs, label)
        t = time_mac_shift(ms, fdl, xn, rhs)
        out["kernel_ms"][kernel] = {f"f{f}_vi{vi}_pp{pp}_kod{kod}": t}
        print(f"{kernel} timing [{voices}-voice roll F={f} VI={vi} Pp={pp} "
              f"KOD={kod}]: kernel {t['kernel'] * 1e3:.2f} us "
              f"({100 * t['bound'] / t['kernel']:.1f} % of the "
              f"{t['bound'] * 1e3:.2f} us bound by {t['bound_by']}), plain "
              f"{t['plain'] * 1e3:.2f} us, unshifted einsum "
              f"{t['einsum'] * 1e3:.2f} us")
        del fdl, xn, rhs
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 33: {out['wall_s']:.1f} s wall")
    return out


class CycleSource:
    """`blocks` blocks of per-voice noise at 0.01 that repeat `distinct`
    blocks drawn once from numpy seed 0: a 2048-voice source whose host
    cost is a copy, not 1 M normal draws per block."""

    def __init__(self, voices, blocks, distinct=16):
        rng = np.random.default_rng(0)
        self.pool = [(rng.standard_normal((voices, 2, BLOCK)) * 0.01
                      ).astype(np.float32) for _ in range(distinct)]
        self.remaining, self.i = blocks, 0

    def read(self):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        self.i += 1
        return self.pool[(self.i - 1) % len(self.pool)].copy()

    def backlog(self):
        return 0


def link_figures(name, session, run_s, stamps):
    """Print and return a session's host-link figures: host ms per block
    p50 / p99 (the session's timer: per block, each block's span; batched,
    the wall time between batch deliveries over their blocks), RTF, missed
    deadlines, the sink's pace (wall ms per delivered block from block
    LINK_PACE_FROM on, the same clock in both modes: `stamps` holds the
    time of each block's delivery), device-to-host copies and bytes per
    block."""
    s = session.summary()
    blocks = session.blocks_streamed
    pace = ((stamps[-1] - stamps[LINK_PACE_FROM - 1]) * 1e3
            / (len(stamps) - LINK_PACE_FROM))
    fig = {"p50_ms": s["p50_ms"], "p99_ms": s["p99_ms"], "rtf": s["rtf"],
           "missed": s["missed_deadlines"], "run_s": run_s,
           "sink_pace_ms_per_block": pace,
           "copies_per_block": session.fetch_copies / blocks,
           "d2h_bytes_per_block": session.fetch_bytes / blocks}
    print(f"{name}: {blocks} blocks in {run_s:.3f} s, host p50 / p99 "
          f"{fig['p50_ms']:.3f} / {fig['p99_ms']:.3f} ms per block, RTF "
          f"{fig['rtf']:.3f}, missed {fig['missed']}, sink pace "
          f"{pace:.3f} ms per block, device-to-host "
          f"{fig['copies_per_block']:.4f} copies and "
          f"{fig['d2h_bytes_per_block'] / 1e6:.4f} MB per block")
    return fig


def run_host_link(bank, irs, ws_bank, dev, configure, select, keep_sink,
                  reset_counts, rm, ms):
    """Phase 34, the host link: (a) phase 4's 64-voice ring session (400
    blocks, its re-select and interrupt) per block, with fetch_batch=16 in
    f32 (bit-identical) and on the pcm16 wire (within one step of the
    16-bit grid, the per-block output clipped to [-1, 1]), and per block
    again, every block on ring_mac; (b) phase 28's 2048-voice bf16 cascade
    for 200 blocks, the same four runs (a 16-block repeating input); (c) phase 12's 152-IR bank on the
    1/65536 grid uploaded over both wires (bytes, seconds, the prepared
    banks bit-identical); (d) bank_prep='host' against 'device' for fmajor
    and the cascade at 64 voices: build seconds with a packed-bank cache
    miss and hit, the sessions within 2e-5 of scale; (e) phase 12's
    16-slot working set for 300 blocks, a new IR every 32 blocks, with
    'derived' and 'td' faults in ring and roll mode: 'td' (device-prepped
    residents) within 2e-5 of scale of 'derived', one ring_mac (ring) or
    mac_shift (roll) launch per block; ms and bytes per fault; a 'derived'
    slot's device-rebuilt columns and row bit-identical to the host pack of
    both layouts (the JAX package's 'dual' upload, whose route 'dual'
    takes here). Returns the figures and the phase's kernel launches."""
    import tempfile

    import torch

    from tpu_audio_torch.engine import device_prep as dp
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import CC_MAX_SPEED, ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import BlockSink, NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession
    from tpu_audio_torch.runtime.working_set import WorkingSetBank

    def stamped(sink):
        """`sink`, with the time of each block's delivery in .stamps."""
        write, sink.stamps = sink.write, []

        def timed(block):
            write(block)
            sink.stamps.append(time.perf_counter())

        sink.write = timed
        return sink

    t_phase = time.perf_counter()
    out = {"runs": {}, "faults": {}, "launches": {
        "ring_mac": 0, "ring_mac_bf16": 0, "mac_shift": 0}}

    def count():
        """Add the launches since reset_counts() to the phase's, f32 and
        bf16 apart (.launches counts both); return (every ring_mac, bf16
        ring_mac, every mac_shift) launch."""
        out["launches"]["ring_mac"] += (rm.ring_mac.launches
                                        - rm.ring_mac.launches_bf16)
        out["launches"]["ring_mac_bf16"] += rm.ring_mac.launches_bf16
        out["launches"]["mac_shift"] += (ms.mac_shift.launches
                                         - ms.mac_shift.launches_bf16)
        return (rm.ring_mac.launches, rm.ring_mac.launches_bf16,
                ms.mac_shift.launches)

    # -- (a) the 64-voice ring session, per block and batched ----------------
    ring = {}
    # per block again last: the host's time spreads within a call too
    for label, kwargs in (("per_block", {}),
                          ("batch16_f32", {"fetch_batch": LINK_BATCH}),
                          ("batch16_pcm16", {"fetch_batch": LINK_BATCH,
                                             "wire": "pcm16"}),
                          ("per_block_again", {})):
        model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, max_predelay=8192,
                                  device=dev)
        configure(model.control)
        sink = stamped(keep_sink(keep_all=True))
        session = model.session(NoiseSource(VOICES, BLOCK, LINK_BLOCKS,
                                            amplitude=0.01, seed=0), sink,
                                **kwargs)
        state = model.init_state()
        reset_counts()
        t0 = time.perf_counter()
        session.run(state, midi=MidiSchedule([select(SELECT_AT, 32),
                                              select(INTERRUPT_AT, 64)]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = count()
        if launches != (LINK_BLOCKS, 0, 0) or sink.blocks != LINK_BLOCKS:
            raise AssertionError(f"host link ring {label}: launches "
                                 f"{launches}, {sink.blocks} blocks")
        if not sink.finite:
            raise AssertionError(f"host link ring {label}: non-finite")
        out["runs"][f"ring64_{label}"] = link_figures(
            f"host link ring {VOICES} v {label}", session, run_s,
            sink.stamps)
        ring[label] = np.concatenate(sink.kept, axis=-1)
        del model, session, state, sink
    f32_err = float(np.abs(ring["batch16_f32"] - ring["per_block"]).max())
    # the 16-bit wire holds [-1, 1], as a 16-bit WAV does: it is held to
    # the per-block output clipped there
    clipped = np.clip(ring["per_block"], -1.0, 1.0)
    pcm_err = float(np.abs(ring["batch16_pcm16"] - clipped).max())
    grid = ring["batch16_pcm16"] * 32767.0
    print(f"host link ring {VOICES} v: batched f32 against per block "
          f"max_abs_err {f32_err:.3e} (bit-identical: "
          f"{np.array_equal(ring['batch16_f32'], ring['per_block'])}); "
          f"pcm16 against per block clipped to [-1, 1] {pcm_err:.3e} (limit "
          f"{1.01 / 32767:.3e}; {int((clipped != ring['per_block']).sum())} "
          f"samples clipped)")
    if not (np.array_equal(ring["batch16_f32"], ring["per_block"])
            and np.array_equal(ring["per_block_again"], ring["per_block"])):
        raise AssertionError("host link: batched f32 differs from per block")
    if not (pcm_err <= 1.01 / 32767 and np.array_equal(grid, np.round(grid))):
        raise AssertionError(f"host link: pcm16 error {pcm_err:.3e}")
    out.update(ring_f32_err=f32_err, ring_pcm16_err=pcm_err)
    del ring
    torch.cuda.empty_cache()

    # -- (b) the 2048-voice bf16 cascade, per block and batched -----------------
    class AllSink(BlockSink):
        """Keeps a copy of every block: the same host work in every run
        (the comparison comes after the run, off its clock)."""

        def __init__(self):
            self.blocks, self.finite = [], True

        def write(self, block):
            self.finite &= bool(np.isfinite(block).all())
            self.blocks.append(block.copy())

    ref, out["cascade_errs"] = None, {}
    for label, kwargs in (("per_block", {}),
                          ("batch16_f32", {"fetch_batch": LINK_BATCH}),
                          ("batch16_pcm16", {"fetch_batch": LINK_BATCH,
                                             "wire": "pcm16"}),
                          ("per_block_again", {})):
        model = ConvolutionReverb(bank, num_voices=HUGE_VOICES, block=BLOCK,
                                  sample_rate=RATE, engine="cascade",
                                  max_predelay=8192, cascade_ratio=CAS_RATIO,
                                  predelay_side="read", mac_dtype="bf16",
                                  device=dev)
        configure(model.control)
        sink = stamped(AllSink())
        session = model.session(CycleSource(HUGE_VOICES, LINK_HUGE_BLOCKS),
                                sink, **kwargs)
        state = model.init_state()
        reset_counts()
        t0 = time.perf_counter()
        session.run(state, midi=MidiSchedule([select(HUGE_SELECT_AT, 32)]))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = count()
        if (launches != (2 * LINK_HUGE_BLOCKS, 2 * LINK_HUGE_BLOCKS, 0)
                or len(sink.blocks) != LINK_HUGE_BLOCKS or not sink.finite):
            raise AssertionError(f"host link cascade {label}: launches "
                                 f"{launches}, {len(sink.blocks)} blocks, "
                                 f"finite {sink.finite}")
        out["runs"][f"cascade2048_bf16_{label}"] = link_figures(
            f"host link cascade {HUGE_VOICES} v bf16 {label}", session,
            run_s, sink.stamps)
        if ref is None:
            ref = sink.blocks
        else:
            # f32 bit for bit; the 16-bit wire against the per-block output
            # clipped to [-1, 1], its range
            pcm16 = label.endswith("pcm16")
            err = max(float(np.abs(got - (np.clip(want, -1.0, 1.0) if pcm16
                                          else want)).max())
                      for got, want in zip(sink.blocks, ref))
            limit = 1.01 / 32767 if pcm16 else 0.0
            out["cascade_errs"][label] = err
            print(f"host link cascade {HUGE_VOICES} v bf16: {label} against "
                  f"per block, every voice: max_abs_err {err:.3e} (limit "
                  f"{limit:.3e})")
            if not err <= limit:
                raise AssertionError(f"host link cascade {label}: error "
                                     f"{err:.3e}")
        del model, session, state, sink
        torch.cuda.empty_cache()
    del ref

    # -- (c) the 152-IR bank on the 16-bit grid, over both wires --------------
    qbank = IRBank(sample_rate=RATE)
    for k in range(len(ws_bank)):
        q = np.clip(np.round(ws_bank.ir(k) * 65536.0), -32768, 32767)
        qbank.append((q / 65536.0).astype(np.float32))
    td = dp.bank_time_domain(qbank)
    upload = {}
    for wire in ("auto", "f32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_td, used = dp.upload_bank_td(td, wire, dev)
        torch.cuda.synchronize()
        upload[used] = {"s": time.perf_counter() - t0,
                        "bytes": td.size * (2 if used == "pcm16" else 4)}
        if wire == "auto":
            same = torch.equal(dev_td.cpu(), torch.from_numpy(td))
        del dev_td
    if set(upload) != {"pcm16", "f32"} or not same:
        raise AssertionError(f"host link: wires {sorted(upload)}, the pcm16 "
                             f"upload decodes to the bank: {same}")
    # the host's share of the pcm16 wire (the grid check and encode), and
    # 'auto' against 'f32' on phase 12's bank, which is off the grid
    t0 = time.perf_counter()
    dp.encode_pcm16_exact(td)
    upload["pcm16"]["encode_s"] = time.perf_counter() - t0
    off_td = dp.bank_time_domain(ws_bank)
    off = {}
    for wire in ("auto", "f32", "auto", "f32"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_td, used = dp.upload_bank_td(off_td, wire, dev)
        torch.cuda.synchronize()
        off.setdefault(wire, []).append(time.perf_counter() - t0)
        if used != "f32":
            raise AssertionError(f"host link: the off-grid bank crossed "
                                 f"over {used}")
        del dev_td
    del off_td
    print(f"host link 152-IR bank off the 16-bit grid: 'auto' upload "
          f"{[round(t * 1e3, 1) for t in off['auto']]} ms, 'f32' "
          f"{[round(t * 1e3, 1) for t in off['f32']]} ms (both f32); the "
          f"on-grid bank's pcm16 encode on the host "
          f"{upload['pcm16']['encode_s'] * 1e3:.1f} ms")
    out["upload_offgrid_s"] = off
    banks = {}
    for wire in ("pcm16", "f32"):
        engine = FMajorPartitionedConvolution(
            VOICES, BLOCK, qbank.max_partitions(BLOCK), max_predelay=8192,
            mac_strategy="auto", num_irs=len(qbank), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        banks[wire] = dp.prepare_fmajor_bank_device(engine, qbank, wire=wire)
        torch.cuda.synchronize()
        upload[wire]["prep_s"] = time.perf_counter() - t0
    same = all(torch.equal(getattr(banks["pcm16"], name),
                           getattr(banks["f32"], name))
               for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"))
    for wire, u in upload.items():
        print(f"host link 152-IR 16-bit bank over the {wire} wire: "
              f"{u['bytes'] / 1e6:.1f} MB up in {u['s'] * 1e3:.1f} ms, "
              f"device prep ({engine.mac_strategy}) {u['prep_s']:.3f} s")
    print(f"host link 152-IR bank: pcm16 and f32 uploads give the same "
          f"bank: {same}")
    if not same:
        raise AssertionError("host link: the pcm16 bank differs from f32")
    out["upload"] = upload
    del banks, td, engine
    torch.cuda.empty_cache()

    # -- (d) host prep against device prep, with the packed-bank caches --------
    with tempfile.TemporaryDirectory() as tmp:
        for kind in ("fmajor", "cascade"):
            outs, builds = {}, {}
            for label, kwargs in (("device", {}),
                                  ("host_miss", {"bank_prep": "host",
                                                 "cache_dir": tmp}),
                                  ("host_hit", {"bank_prep": "host",
                                                "cache_dir": tmp})):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model = ConvolutionReverb(
                    bank, num_voices=VOICES, block=BLOCK, sample_rate=RATE,
                    engine=kind, max_predelay=8192, cascade_ratio=CAS_RATIO,
                    device=dev, **kwargs)
                torch.cuda.synchronize()
                builds[label] = time.perf_counter() - t0
                if label == "host_miss":
                    continue
                configure(model.control)
                sink = keep_sink(keep_all=True)
                session = model.session(NoiseSource(
                    VOICES, BLOCK, LINK_PREP_BLOCKS, amplitude=0.01, seed=0),
                    sink)
                reset_counts()
                session.run(model.init_state(), midi=MidiSchedule(
                    [select(LINK_PREP_SELECT_AT, 32)]))
                torch.cuda.synchronize()
                per = 2 if kind == "cascade" else 1
                if count() != (per * LINK_PREP_BLOCKS, 0, 0):
                    raise AssertionError(f"host link {kind} {label}: "
                                         f"launches")
                outs[label] = np.concatenate(sink.kept, axis=-1)
                del model, session, sink
            entries = sorted(os.path.basename(p)
                             for p in glob.glob(os.path.join(tmp, "*.ok")))
            scale = float(np.abs(outs["device"]).max())
            err = float(np.abs(outs["host_hit"] - outs["device"]).max())
            print(f"host link {kind} {VOICES} v: build device {builds['device']:.3f}"
                  f" s, host (cache miss) {builds['host_miss']:.3f} s, host "
                  f"(cache hit) {builds['host_hit']:.3f} s; cache entries "
                  f"{entries}; host against device over {LINK_PREP_BLOCKS} "
                  f"blocks: max_abs_err {err:.3e} (limit {2e-5 * scale:.3e})")
            if not err <= 2e-5 * scale:
                raise AssertionError(f"host link: {kind} host prep differs")
            if not any(e.startswith("pack_" if kind == "fmajor"
                                    else "cascpack_") for e in entries):
                raise AssertionError(f"host link: no packed-bank entry "
                                     f"{entries}")
            out[f"prep_{kind}"] = dict(builds, err=err, scale=scale)
            torch.cuda.empty_cache()

    # -- (e) the working set's fault payloads, ring and roll -------------------
    residents = list(range(WS_CAPACITY))
    churn = [select(b, v) for b, v in LINK_WS_CHURN]
    with tempfile.TemporaryDirectory() as tmp:
        full = ws_bank.cached_partitioned_spectra(
            BLOCK, tmp, max_partitions=ws_bank.max_partitions(BLOCK))
        compact = IRBank(sample_rate=RATE)
        for k in residents:
            compact.append(ws_bank.ir(k))
        for mode in ("ring", "roll"):
            outs = {}
            for payload in ("derived", "td"):
                engine = FMajorPartitionedConvolution(
                    VOICES, BLOCK, ws_bank.max_partitions(BLOCK),
                    max_predelay=8192, ring=mode == "ring",
                    mac_strategy="allk", num_irs=WS_CAPACITY,
                    fault_upload=payload, device=dev)
                if payload == "td":
                    spectra = dp.prepare_fmajor_bank_device(engine, compact)
                    slot_payload = ws_bank.ir
                else:
                    spectra = engine.prepare_bank(full[residents],
                                                  cache_dir=tmp)

                    def slot_payload(k):
                        return full[k: k + 1]
                cp = ControlPlane(VOICES, len(ws_bank), 8192, device=dev)
                configure(cp)
                ws = WorkingSetBank(engine, cp, slot_payload, spectra,
                                    residents,
                                    min_age_blocks=CC_MAX_SPEED + 64)
                fault = {"ms": [], "bytes": []}
                pack, update = engine.pack_bank_slot, ws._update_slot

                def timed_pack(item, pack=pack, fault=fault):
                    packed = pack(item)
                    fault["bytes"].append(packed.host.numel()
                                          * packed.host.element_size())
                    return packed

                def timed_update(slot, item, update=update, fault=fault):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    result = update(slot, item)
                    torch.cuda.synchronize()
                    fault["ms"].append((time.perf_counter() - t0) * 1e3)
                    return result

                engine.pack_bank_slot = timed_pack
                ws._update_slot = timed_update
                sink = stamped(keep_sink(keep_all=True))
                session = StreamSession(
                    engine, spectra, cp, NoiseSource(
                        VOICES, BLOCK, LINK_WS_BLOCKS, amplitude=0.01,
                        seed=0), sink, sample_rate=RATE)
                ws.on_update = lambda b, session=session: setattr(
                    session, "bank", b)
                session.pre_run_hooks.append(ws.warmup)
                reset_counts()
                t0 = time.perf_counter()
                session.run(engine.init_converged(spectra,
                                                  cp.snapshot_device()),
                            midi=MidiSchedule(list(churn)))
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
                launches = count()
                want = ((LINK_WS_BLOCKS, 0, 0) if mode == "ring"
                        else (0, 0, LINK_WS_BLOCKS))
                if (launches != want or ws.misses != len(churn)
                        or not sink.finite):
                    raise AssertionError(f"host link working set {mode} "
                                         f"{payload}: launches {launches}, "
                                         f"misses {ws.misses}")
                label = f"ws_{mode}_{payload}"
                out["runs"][label] = link_figures(
                    f"host link working set {mode} {payload}", session,
                    run_s, sink.stamps)
                warm = fault["ms"][1:]   # the first is the session warm-up
                out["faults"][label] = {
                    "first_ms": fault["ms"][0],
                    "warm_median_ms": float(np.median(warm)),
                    "bytes": fault["bytes"][-1], "misses": ws.misses}
                print(f"host link working set {mode} {payload}: "
                      f"{ws.misses} faults, first use "
                      f"{fault['ms'][0]:.2f} ms, warm median "
                      f"{np.median(warm):.2f} ms, "
                      f"{fault['bytes'][-1] / 1e6:.3f} MB up per fault")
                outs[payload] = np.concatenate(sink.kept, axis=-1)
                if payload == "derived":
                    # the slot the device rebuilds against the host pack
                    # of both layouts, IR 20 (a non-resident)
                    packed = engine.pack_bank_slot(full[20:21])
                    mac_rhs, rhs2, planar, rev2 = engine._pack_bank_host(
                        full[20:21])
                    cols = rhs2 if mode == "ring" else mac_rhs
                    row = (rev2 if mode == "ring" else planar)[0]
                    slot_exact = (
                        torch.equal(packed.columns, torch.from_numpy(
                            cols).to(dev).to(packed.columns.dtype))
                        and torch.equal(packed.row, torch.from_numpy(
                            row).to(dev).to(packed.row.dtype)))
                del engine, spectra, ws, session, sink, cp
                torch.cuda.empty_cache()
            scale = float(np.abs(outs["derived"]).max())
            td_err = float(np.abs(outs["td"] - outs["derived"]).max())
            print(f"host link working set {mode}: a derived slot against "
                  f"the host pack of both layouts bit-identical: "
                  f"{slot_exact}; td (device-prepped) against derived "
                  f"max_abs_err {td_err:.3e} (limit {2e-5 * scale:.3e})")
            if not slot_exact or not td_err <= 2e-5 * scale:
                raise AssertionError(f"host link working set {mode}: "
                                     f"derived slot exact {slot_exact}, td "
                                     f"error {td_err:.3e}")
            out[f"ws_{mode}_td_err"] = td_err
        del full
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 34: {out['wall_s']:.1f} s wall, launches "
          f"{out['launches']}")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import CCMapping, ControlPlane
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.ops import mac_shift as ms
    from tpu_audio_torch.ops import ring_mac as rm
    from tpu_audio_torch.ops.cuda_build import build_all
    from tpu_audio_torch.ops.partition import num_partitions
    from tpu_audio_torch.runtime.backends import BlockSink, NoiseSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession
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
    t0 = time.perf_counter()
    built = build_all([rm.LIBRARY, ms.LIBRARY])
    print(f"build: both kernels in {time.perf_counter() - t0:.2f} s wall")
    for path, build_s, ptxas in built:
        print(f"  {path.name} compiled in {build_s:.2f} s" if build_s
              else f"  {path.name} already built")
        for line in ptxas.splitlines():
            if any(key in line for key in ("Function properties",
                                           "registers", "spill")):
                print(f"    {line.strip()}")

    def reset_counts():
        rm.ring_mac.launches = rm.ring_mac.launches_bf16 = 0
        ms.mac_shift.launches = ms.mac_shift.launches_bf16 = 0

    # -- 3. ring_mac vs plain ---------------------------------------------------------
    engine_pp = -(-num_partitions(int(IR_SECONDS * RATE), BLOCK) // 8) * 8
    f_full, vi_full, kod_full = BLOCK + 1, 2 * VOICES, 4 * NUM_IRS
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=dev)

    max_abs_err = 0.0
    fdl_full = randn(f_full, vi_full, 2, engine_pp)
    ring_inputs = {kod: (fdl_full, randn(f_full, 2, 2 * engine_pp, kod))
                   for kod in RING_KODS}
    for name, (fdl, rhs2) in [
            *(("64-voice", ring_inputs[kod]) for kod in RING_KODS),
            ("odd-small", (randn(7, 4, 2, 16), randn(7, 2, 32, 8)))]:
        f, vi, _, pp = fdl.shape
        fdl64, rhs64 = fdl.double(), rhs2.double()
        for w in sorted({0, 1, 347 % pp, pp - 1}):
            wt = torch.tensor(w, dtype=torch.int32, device=dev)
            got = rm.ring_mac(wt, fdl, rhs2)
            torch.cuda.synchronize()
            ref64 = rm.ring_mac_reference(w, fdl64, rhs64)
            scale = ref64.abs().max().item()
            err = (got.double() - ref64).abs().max().item()
            err32 = (rm.ring_mac_reference(wt, fdl, rhs2).double()
                     - ref64).abs().max().item()
            err_lib = (ring_mac_library(w, fdl, rhs2).double()
                       - ref64).abs().max().item()
            print(f"ring_mac vs plain [{name} F={f} VI={vi} Pp={pp} "
                  f"KOD={rhs2.shape[3]} w={w}]: max_abs_err {err:.3e} (plain "
                  f"f32 {err32:.3e}, library {err_lib:.3e}, limit "
                  f"{1e-5 * scale:.3e})")
            if not err <= 1e-5 * scale:
                raise AssertionError(f"ring_mac kernel disagrees with the "
                                     f"plain version at {name} w={w}")
            if not err_lib <= 1e-5 * scale:
                raise AssertionError(f"the library yardstick computes "
                                     f"another function at {name} w={w}")
            if name.startswith("64-voice"):
                max_abs_err = max(max_abs_err, err)
            del ref64
        del fdl64, rhs64

    # -- 4. ring mode at full width ---------------------------------------------------
    irs = synthetic_bank(NUM_IRS, IR_SECONDS, RATE)
    bank = IRBank(sample_rate=RATE)
    for ir in irs:
        bank.append(ir)

    def configure(cp):
        cp.wet[:] = 0.7
        cp.dry[:] = 0.2
        cp.predelay[:] = 1024
        cp.speed[:] = 50
        for v in range(cp.num_voices):
            for ch in range(2):
                cp.set_mapping(v, ch, CCMapping(message=0xB0,
                                                select=SELECT_CC,
                                                predelay=PREDELAY_CC))

    def select(block, value):
        return (block, "", bytes([0xB0, SELECT_CC, value]))

    class KeepSink(BlockSink):
        """Keeps the first and last voice (all voices with keep_all);
        checks every block is finite."""

        def __init__(self, keep_all=False):
            self.kept, self.finite, self.blocks = [], True, 0
            self.keep_all = keep_all

        def write(self, block):
            self.finite &= bool(np.isfinite(block).all())
            self.kept.append(block.copy() if self.keep_all
                             else block[[0, len(block) - 1]].copy())
            self.blocks += 1

        def data(self):
            return np.concatenate(self.kept, axis=-1)     # [2 voices, 2, T]

    model = ConvolutionReverb(bank, num_voices=VOICES, block=BLOCK,
                              sample_rate=RATE, engine="fmajor",
                              max_predelay=8192, device=dev)
    if model.engine.pp != engine_pp or model.engine.mac_strategy != "allk":
        raise AssertionError(f"engine Pp {model.engine.pp} != {engine_pp} "
                             f"or strategy {model.engine.mac_strategy}")
    cp = model.control
    configure(cp)
    midi = MidiSchedule([select(SELECT_AT, 32), select(INTERRUPT_AT, 64)])
    sink = KeepSink()
    session = model.session(NoiseSource(VOICES, BLOCK, BLOCKS,
                                        amplitude=0.01, seed=0), sink)
    state = model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = session.run(state, midi=midi)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = rm.ring_mac.launches
    steps = session.blocks_streamed
    print(f"ring slice: {steps} blocks in {run_s:.3f} s, ring_mac launches "
          f"{launches}, mac_shift launches {ms.mac_shift.launches}, indexed "
          f"blocks {session.indexed_blocks}, general blocks "
          f"{session.general_blocks}, selects {cp.select[0].tolist()}")
    if steps != BLOCKS or sink.blocks != BLOCKS:
        raise AssertionError(f"streamed {steps} blocks, delivered "
                             f"{sink.blocks}, wanted {BLOCKS}")
    if launches != steps or ms.mac_shift.launches:
        raise AssertionError(f"ring_mac launched {launches} times and "
                             f"mac_shift {ms.mac_shift.launches} in {steps} "
                             f"ring-mode steps")
    if session.indexed_blocks < 20 or session.general_blocks:
        raise AssertionError(f"{session.indexed_blocks} blocks rode "
                             f"step_coef_indexed, {session.general_blocks} "
                             f"the general step")
    if not sink.finite:
        raise AssertionError("non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError("the crossfades did not decay by the end")
    x = noise_input(BLOCKS)
    golden_err = check_golden(
        "ring", sink.data(), x,
        (("before the re-selects, IR 0", 0, SELECT_AT, irs[0]),
         ("after the fades decay, IR 2", 500, BLOCKS, irs[2])),
        predelay=int(cp.predelay[0, 0]))
    summary = session.summary()
    ring_f32_out = sink.data()      # phase 27's f32 reference

    # -- 5. ring-mode timing on the card ------------------------------------------------
    engine, bank_t = model.engine, model.spectra
    params = cp.snapshot_device()
    xt = torch.tensor(x[:, :, :BLOCK].repeat(VOICES // 2, axis=0), device=dev)
    step_ms = {}
    for name in ("step_coef_steady", "step_coef_indexed"):
        p50, p99, state = step_times(getattr(engine, name), state, bank_t,
                                     params, xt)
        step_ms[("ring", name)] = (p50, p99)
    state = engine.materialize_base(state, bank_t)
    p50, p99, state = step_times(engine.step_coef, state, bank_t, params, xt)
    step_ms[("ring", "step_coef")] = (p50, p99)
    del model, session, state, engine, bank_t
    torch.cuda.empty_cache()
    ring_ms = {}
    for kod in RING_KODS:
        fdl, rhs2 = ring_inputs[kod]
        t = ring_ms[kod] = time_ring_mac(rm, fdl, rhs2)
        k_ms = t["kernel"]
        print(f"ring_mac timing [64-voice KOD={kod}]: kernel {k_ms * 1e3:.2f} "
              f"us ({t['bytes'] / (k_ms * 1e-3) / 1e9:.0f} GB/s, "
              f"{100 * t['bound'] / k_ms:.1f} % of the {t['bound'] * 1e3:.2f} "
              f"us bound by {t['bound_by']}), plain {t['plain'] * 1e3:.2f}"
              f" us, library {t['library'] * 1e3:.2f} us")
    del ring_inputs, fdl_full, fdl, rhs2
    torch.cuda.empty_cache()

    # -- 6. mac_shift vs plain ---------------------------------------------------------
    shift_err = 0.0
    shift_tensors = {}
    for name, (f, vi, pp, kod) in (
            ("64-voice", (f_full, vi_full, engine_pp, kod_full)),
            ("64-voice KOD=36", (f_full, vi_full, engine_pp, 36)),
            ("64-voice KOD=64", (f_full, vi_full, engine_pp, 64)),
            ("odd-small", (7, 5, 24, 12))):
        fdl = torch.tensor(rng.standard_normal((f, vi, 2, pp),
                                               dtype=np.float32), device=dev)
        xn = torch.tensor(rng.standard_normal((f, vi, 2, 1),
                                              dtype=np.float32), device=dev)
        rhs = torch.tensor(rng.standard_normal((f, 2, pp, kod),
                                               dtype=np.float32), device=dev)
        shift64, ref64 = ms.mac_shift_reference(fdl.double(), xn.double(),
                                                rhs.double())
        _, ref32 = ms.mac_shift_reference(fdl, xn, rhs)
        got_fdl, got = ms.mac_shift(fdl, xn, rhs)
        torch.cuda.synchronize()
        same = got_fdl is fdl and torch.equal(got_fdl.double(), shift64)
        scale = ref64.abs().max().item()
        err = (got.double() - ref64).abs().max().item()
        err32 = (ref32.double() - ref64).abs().max().item()
        print(f"mac_shift vs plain [{name} F={f} VI={vi} Pp={pp} KOD={kod}]: "
              f"shifted line {'bit-identical' if same else 'DIFFERS'}, m "
              f"max_abs_err {err:.3e} (plain f32 {err32:.3e}, limit "
              f"{1e-5 * scale:.3e})")
        if not same:
            raise AssertionError(f"mac_shift's shifted line differs from the "
                                 f"plain version at {name}")
        if not err <= 1e-5 * scale:
            raise AssertionError(f"mac_shift kernel disagrees with the plain "
                                 f"version at {name}")
        if name.startswith("64-voice"):
            shift_err = max(shift_err, err)
        shift_tensors[name] = (fdl, xn, rhs)
        del shift64, ref64, ref32

    # -- 7. roll mode at full width -----------------------------------------------------
    partitions = bank.max_partitions(BLOCK)
    roll = FMajorPartitionedConvolution(
        VOICES, BLOCK, partitions, max_predelay=8192, ring=False,
        mac_strategy="allk", num_irs=NUM_IRS, swap_snapshot=True, device=dev)
    roll_bank = roll.prepare_bank(bank.partitioned_spectra(BLOCK))
    new_irs = [irs[k] * np.float32(0.5) for k in ROLL_PERM]
    swapped = IRBank(sample_rate=RATE)
    for ir in new_irs:
        swapped.append(ir)
    roll_bank2 = roll.prepare_bank(swapped.partitioned_spectra(BLOCK))
    roll_cp = ControlPlane(VOICES, NUM_IRS, 8192, device=dev)
    configure(roll_cp)
    roll_sink = KeepSink()
    roll_session = StreamSession(
        roll, roll_bank, roll_cp,
        NoiseSource(VOICES, BLOCK, BLOCKS, amplitude=0.01, seed=0),
        roll_sink, sample_rate=RATE)
    state = roll.init_converged(roll_bank, roll_cp.snapshot_device())
    reset_counts()
    t0 = time.perf_counter()
    state = roll_session.run(state, max_blocks=ROLL_SWAP_AT,
                             midi=MidiSchedule([select(SELECT_AT, 32)]))
    indexed_before_swap = roll_session.indexed_blocks
    roll_session.swap_bank(roll_bank2)
    state = roll_session.run(state, midi=MidiSchedule(
        [select(ROLL_INTERRUPT_AT - ROLL_SWAP_AT, 64)]))
    torch.cuda.synchronize()
    roll_s = time.perf_counter() - t0
    roll_launches = ms.mac_shift.launches
    steps = roll_session.blocks_streamed
    print(f"roll slice: {steps} blocks in {roll_s:.3f} s, mac_shift launches "
          f"{roll_launches}, ring_mac launches {rm.ring_mac.launches}, "
          f"indexed blocks {roll_session.indexed_blocks}, general blocks "
          f"{roll_session.general_blocks}, selects "
          f"{roll_cp.select[0].tolist()}")
    if steps != BLOCKS or roll_sink.blocks != BLOCKS:
        raise AssertionError(f"roll: streamed {steps} blocks, delivered "
                             f"{roll_sink.blocks}, wanted {BLOCKS}")
    if roll_launches != steps or rm.ring_mac.launches:
        raise AssertionError(f"mac_shift launched {roll_launches} times and "
                             f"ring_mac {rm.ring_mac.launches} in {steps} "
                             f"roll-mode steps")
    if roll_session.bank is not roll_bank2:
        raise AssertionError("the bank swap was not applied")
    if (indexed_before_swap < 15
            or roll_session.indexed_blocks != indexed_before_swap
            or roll_session.general_blocks < 60):
        raise AssertionError(f"roll: {roll_session.indexed_blocks} indexed "
                             f"blocks ({indexed_before_swap} before the "
                             f"swap), {roll_session.general_blocks} general")
    if not roll_sink.finite:
        raise AssertionError("roll: non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError("roll: the crossfades did not decay by the end")
    roll_err = check_golden(
        "roll", roll_sink.data(), x,
        (("before the re-select, IR 0", 0, SELECT_AT, irs[0]),
         ("after the fades decay, new bank IR 2 = 0.5 * IR "
          f"{ROLL_PERM[2]}", 560, BLOCKS, new_irs[2])),
        predelay=int(roll_cp.predelay[0, 0]))
    roll_summary = roll_session.summary()

    # -- 8. 'selected' at full width ----------------------------------------------------
    sel_irs = synthetic_bank(SEL_IRS, IR_SECONDS, RATE)
    sel_bank = IRBank(sample_rate=RATE)
    for ir in sel_irs:
        sel_bank.append(ir)
    t0 = time.perf_counter()
    sel_model = ConvolutionReverb(sel_bank, num_voices=VOICES, block=BLOCK,
                                  sample_rate=RATE, max_predelay=8192,
                                  device=dev)
    sel_build_s = time.perf_counter() - t0
    if sel_model.engine.mac_strategy != "selected":
        raise AssertionError(f"auto resolved {SEL_IRS} IRs to "
                             f"{sel_model.engine.mac_strategy}")
    sel_cp = sel_model.control
    configure(sel_cp)
    sel_sink = KeepSink()
    sel_session = sel_model.session(
        NoiseSource(VOICES, BLOCK, SEL_BLOCKS, amplitude=0.01, seed=0),
        sel_sink)
    state = sel_model.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = sel_session.run(state, midi=MidiSchedule(
        [select(SEL_SELECT_AT, 32), select(SEL_INTERRUPT_AT, 64)]))
    torch.cuda.synchronize()
    sel_s = time.perf_counter() - t0
    steps = sel_session.blocks_streamed
    print(f"selected slice: {steps} blocks in {sel_s:.3f} s (model built in "
          f"{sel_build_s:.2f} s), general blocks "
          f"{sel_session.general_blocks}, indexed blocks "
          f"{sel_session.indexed_blocks}, ring_mac/mac_shift launches "
          f"{rm.ring_mac.launches}/{ms.mac_shift.launches}, selects "
          f"{sel_cp.select[0].tolist()}")
    if steps != SEL_BLOCKS or sel_sink.blocks != SEL_BLOCKS:
        raise AssertionError(f"selected: streamed {steps} blocks, delivered "
                             f"{sel_sink.blocks}, wanted {SEL_BLOCKS}")
    if (sel_session.general_blocks < 60 or sel_session.indexed_blocks
            or rm.ring_mac.launches or ms.mac_shift.launches):
        raise AssertionError("selected: wrong step mix or an all-K kernel "
                             "launched")
    if not sel_sink.finite:
        raise AssertionError("selected: non-finite output")
    if not float(state.coef_a.max()) < 1e-6:
        raise AssertionError("selected: the crossfades did not decay")
    sel_x = noise_input(SEL_BLOCKS)
    sel_a, sel_b = (32 * SEL_IRS // 128, 64 * SEL_IRS // 128)
    if sel_cp.select[0].tolist() != [sel_b, sel_b]:
        raise AssertionError(f"selected: selection {sel_cp.select[0]}")
    sel_err = check_golden(
        "selected", sel_sink.data(), sel_x,
        (("before the re-selects, IR 0", 0, SEL_SELECT_AT, sel_irs[0]),
         (f"after the fades decay, IR {sel_b} (via IR {sel_a})", 400,
          SEL_BLOCKS, sel_irs[sel_b])),
        predelay=int(sel_cp.predelay[0, 0]))
    sel_summary = sel_session.summary()

    # -- 9. roll and 'selected' timing ------------------------------------------------
    sel_params = sel_cp.snapshot_device()
    for name in ("step_coef_steady", "step_coef"):
        p50, p99, state = step_times(getattr(sel_model.engine, name), state,
                                     sel_model.spectra, sel_params, xt)
        step_ms[("selected", name)] = (p50, p99)
    del sel_model, sel_session, state
    torch.cuda.empty_cache()
    roll_params = roll_cp.snapshot_device()
    state = roll.init_converged(roll_bank2, roll_params)
    for name in ("step_coef_steady", "step_coef_indexed"):
        p50, p99, state = step_times(getattr(roll, name), state, roll_bank2,
                                     roll_params, xt)
        step_ms[("roll", name)] = (p50, p99)
    state = roll.materialize_base(state, roll_bank2)
    p50, p99, state = step_times(roll.step_coef, state, roll_bank2,
                                 roll_params, xt)
    step_ms[("roll", "step_coef")] = (p50, p99)
    shift_ms = {}
    for name in ("64-voice", "64-voice KOD=36", "64-voice KOD=64"):
        fdl, xn, rhs = shift_tensors[name]
        shift_ms[rhs.shape[3]] = time_mac_shift(ms, fdl, xn, rhs)
    del shift_tensors, fdl, xn, rhs, roll, roll_bank, roll_bank2, state
    torch.cuda.empty_cache()

    # -- 10. roll mode at the all-K ceiling -------------------------------------------
    ceil_irs = synthetic_bank(CEIL_IRS, IR_SECONDS, RATE)
    ceil_bank = IRBank(sample_rate=RATE)
    for ir in ceil_irs:
        ceil_bank.append(ir)

    def ceil_midi():
        return MidiSchedule([select(CEIL_SELECT_AT, 32),
                             select(CEIL_INTERRUPT_AT, 64)])

    def check_ceiling(name, session, sink, state, cp, run_s, launches):
        """The checks of a 16-IR session (phases 10 and 11): every block
        launches the first kernel of `launches` ({kernel: launches}) and
        none the second, the fades ride the indexed step, the output is
        finite and its fades decay, and voices 0 and 63 match the golden
        before the re-select and after the fades decay. Returns the largest
        golden error."""
        steps = session.blocks_streamed
        (rode, n_rode), (other, n_other) = launches.items()
        print(f"{name}: {steps} blocks in {run_s:.3f} s, {rode} launches "
              f"{n_rode}, {other} launches {n_other}, indexed blocks "
              f"{session.indexed_blocks}, general blocks "
              f"{session.general_blocks}, selects {cp.select[0].tolist()}")
        if steps != CEIL_BLOCKS or sink.blocks != CEIL_BLOCKS:
            raise AssertionError(f"{name}: streamed {steps} blocks, "
                                 f"delivered {sink.blocks}, wanted "
                                 f"{CEIL_BLOCKS}")
        if n_rode != steps or n_other:
            raise AssertionError(f"{name}: {rode} launched {n_rode} times "
                                 f"and {other} {n_other} in {steps} steps")
        if session.indexed_blocks < 20 or session.general_blocks:
            raise AssertionError(f"{name}: {session.indexed_blocks} indexed "
                                 f"blocks, {session.general_blocks} general")
        if not sink.finite:
            raise AssertionError(f"{name}: non-finite output")
        if not float(state.coef_a.max()) < 1e-6:
            raise AssertionError(f"{name}: the crossfades did not decay")
        sel_a, sel_b = (32 * CEIL_IRS // 128, 64 * CEIL_IRS // 128)
        if cp.select[0].tolist() != [sel_b, sel_b]:
            raise AssertionError(f"{name}: selection {cp.select[0]}")
        return check_golden(
            name, sink.data(), noise_input(CEIL_BLOCKS),
            (("before the re-selects, IR 0", 0, CEIL_SELECT_AT, ceil_irs[0]),
             (f"after the fades decay, IR {sel_b} (via IR {sel_a})", 300,
              CEIL_BLOCKS, ceil_irs[sel_b])),
            predelay=int(cp.predelay[0, 0]))

    ceil = FMajorPartitionedConvolution(
        VOICES, BLOCK, ceil_bank.max_partitions(BLOCK), max_predelay=8192,
        ring=False, mac_strategy="auto", num_irs=CEIL_IRS, device=dev)
    ceil_spectra = ceil.prepare_bank(ceil_bank.partitioned_spectra(BLOCK))
    ceil_kod = ceil_spectra.mac_rhs.shape[3]
    if ceil.mac_strategy != "allk" or ceil_kod != 4 * CEIL_IRS:
        raise AssertionError(f"auto resolved {CEIL_IRS} IRs to "
                             f"{ceil.mac_strategy}, KOD {ceil_kod}")
    ceil_cp = ControlPlane(VOICES, CEIL_IRS, 8192, device=dev)
    configure(ceil_cp)
    ceil_sink = KeepSink()
    ceil_session = StreamSession(
        ceil, ceil_spectra, ceil_cp,
        NoiseSource(VOICES, BLOCK, CEIL_BLOCKS, amplitude=0.01, seed=0),
        ceil_sink, sample_rate=RATE)
    state = ceil.init_converged(ceil_spectra, ceil_cp.snapshot_device())
    reset_counts()
    t0 = time.perf_counter()
    state = ceil_session.run(state, midi=ceil_midi())
    torch.cuda.synchronize()
    ceil_launches = ms.mac_shift.launches
    ceil_err = check_ceiling(
        f"roll ceiling ({CEIL_IRS} IRs, KOD={ceil_kod})", ceil_session,
        ceil_sink, state, ceil_cp, time.perf_counter() - t0,
        {"mac_shift": ceil_launches, "ring_mac": rm.ring_mac.launches})
    ceil_summary = ceil_session.summary()
    p50, p99, state = step_times(ceil.step_coef_steady, state, ceil_spectra,
                                 ceil_cp.snapshot_device(), xt)
    step_ms[("roll16", "step_coef_steady")] = (p50, p99)
    del ceil, ceil_spectra, ceil_session, state
    torch.cuda.empty_cache()

    # -- 11. ring mode at the all-K ceiling -------------------------------------------
    t0 = time.perf_counter()
    ring16 = ConvolutionReverb(ceil_bank, num_voices=VOICES, block=BLOCK,
                               sample_rate=RATE, max_predelay=8192,
                               device=dev)
    ring16_build_s = time.perf_counter() - t0
    ring16_kod = ring16.spectra.rhs2.shape[3]
    if (not ring16.engine.ring_mode or ring16.engine.mac_strategy != "allk"
            or ring16_kod != 4 * CEIL_IRS):
        raise AssertionError(f"the model resolved {CEIL_IRS} IRs to ring "
                             f"{ring16.engine.ring_mode}, "
                             f"{ring16.engine.mac_strategy}, KOD {ring16_kod}")
    configure(ring16.control)
    ring16_sink = KeepSink()
    ring16_session = ring16.session(
        NoiseSource(VOICES, BLOCK, CEIL_BLOCKS, amplitude=0.01, seed=0),
        ring16_sink)
    state = ring16.init_state()
    reset_counts()
    t0 = time.perf_counter()
    state = ring16_session.run(state, midi=ceil_midi())
    torch.cuda.synchronize()
    ring16_launches = rm.ring_mac.launches
    print(f"ring ceiling: model built in {ring16_build_s:.2f} s")
    ring16_err = check_ceiling(
        f"ring ceiling ({CEIL_IRS} IRs, KOD={ring16_kod})", ring16_session,
        ring16_sink, state, ring16.control, time.perf_counter() - t0,
        {"ring_mac": ring16_launches, "mac_shift": ms.mac_shift.launches})
    ring16_summary = ring16_session.summary()
    p50, p99, state = step_times(ring16.engine.step_coef_steady, state,
                                 ring16.spectra,
                                 ring16.control.snapshot_device(), xt)
    step_ms[("ring16", "step_coef_steady")] = (p50, p99)

    del ring16, ring16_session, state
    torch.cuda.empty_cache()

    # -- 12. a working set at the reference bank's size ------------------------------
    ws_irs = synthetic_bank(WS_IRS, IR_SECONDS, RATE)
    ws_bank = IRBank(sample_rate=RATE)
    for ir in ws_irs:
        ws_bank.append(ir)
    hit_ir = WS_HIT_VALUE * WS_IRS // 128
    ws_x = noise_input(WS_BLOCKS)
    ws_runs = {}
    for mode, async_paging in (("sync", False), ("async", True)):
        ws_runs[mode] = run_working_set(
            ws_bank, async_paging, configure, select, KeepSink, dev, ws_x,
            ws_irs, hit_ir, reset_counts, rm, ms)
        torch.cuda.empty_cache()
    del ws_irs    # ws_bank serves phase 32's working set too

    # -- 13. ring_mac at the cascade's shapes ------------------------------------------
    cas_errs, cas_timed = check_cascade_shapes(rm, dev, rng)
    cas_err, cas_ms = cas_errs["f32"], cas_timed["f32"]

    # -- 14. the cascade at full width, write side then read side ----------------------
    cas_runs = {}
    for side in ("write", "read"):
        cas_runs[side] = run_cascade_timeline(
            bank, irs, new_irs, side, dev, configure, select, KeepSink,
            reset_counts, rm, ms)
        # steps of the 64-voice cascade, after its session (the read side's
        # carry its retime, computed every block)
        mode = "cascade64" if side == "write" else "cascade64_read"
        cas_model, cas_state = (cas_runs[side].pop("model"),
                                cas_runs[side].pop("state"))
        cas_params = cas_model.control.snapshot_device()
        for name in ("step_coef_steady", "step_coef_indexed"):
            step = getattr(cas_model.engine, name)
            p50, p99, cas_state = step_times(
                step, cas_state, cas_model.spectra, cas_params, xt)
            busy, ops, cas_state = device_busy(
                step, cas_state, cas_model.spectra, cas_params, xt,
                label=f"{mode} {name}")
            step_ms[(mode, name)] = (p50, p99)
            step_ms[(mode, name, "busy")] = (busy, ops)
        del cas_model, cas_state
        torch.cuda.empty_cache()
    write_out, read_out = cas_runs["write"].pop("out"), cas_runs["read"].pop(
        "out")
    cas_scale = float(np.abs(write_out).max())
    read_err = float(np.abs(read_out - write_out).max())
    print(f"cascade 64 voices: read side against write side over all "
          f"{CAS_BLOCKS} blocks and {VOICES} voices (a predelay edit at "
          f"{CAS_EDIT_AT}): max_abs_err {read_err:.3e} (limit "
          f"{2e-5 * cas_scale:.3e})")
    if not read_err <= 2e-5 * cas_scale:
        raise AssertionError("cascade: the read side disagrees with the "
                             "write side")
    del write_out, read_out

    # -- 15. the cascade at 1024 voices, and fmajor beside it --------------------------
    big = run_cascade_1024(bank, irs, dev, configure, select, KeepSink,
                           reset_counts, rm, ms)
    torch.cuda.empty_cache()

    # -- 16. the static bounce at full width, 512 virtual voices -------------------
    bounce = run_bounce_static(bank, irs, dev, configure, reset_counts, rm, ms,
                               rng)

    # -- 17. an automated bounce against the session ------------------------------------
    auto = run_bounce_automated(bank, dev, configure, select, KeepSink,
                                reset_counts, rm, ms)

    # -- 18. the cascade's and roll mode's bounces ---------------------------------------
    engines = run_bounce_engines(bank, irs, dev, configure, reset_counts, rm,
                                 ms, rng)

    # -- 19-20. checkpoint and recovery at full width -------------------------------------
    recovery = run_checkpoint_phases(bank, irs, dev, configure, select,
                                     KeepSink, reset_counts, rm, ms)

    # -- 21. the live path in one process -------------------------------------------------
    live = run_live_path(bank, irs, dev, configure, select, reset_counts, rm)

    # -- 22. the CLI behind the C JACK bridge ---------------------------------------------
    cli = run_cli_bridge(irs)

    # -- 23. the monolithic engine at fftSize 131072 --------------------------------------
    mono = run_monolithic(bank, irs, dev, configure, select, KeepSink,
                          reset_counts, rm, ms)

    # -- 24. the partitioned engine, coef and materialized, and its bounce ---------------
    part = run_partitioned(bank, irs, dev, configure, select, KeepSink,
                           reset_counts, rm, ms)

    # -- 25. a settings file whose conv pairs differ, through the CLI --------------------
    groups = run_cli_groups(irs)

    # -- 26. the bf16 kernels against their plain versions ---------------------------------
    bf16_err, bf16_ms = run_bf16_kernels(dev, rng, engine_pp)

    # -- 27. fmajor in bf16: ring and roll sessions, a bounce ------------------------------
    fm16 = run_fmajor_bf16(bank, dev, configure, select, KeepSink,
                           reset_counts, rm, ms, ring_f32_out)

    # -- 28. the JAX bench's cascade_2048: 2048 voices in bf16 -----------------------------
    huge = run_cascade_2048(bank, irs, dev, configure, select, KeepSink,
                            reset_counts, rm, ms)

    # -- 29. the JAX bench's sel152: 152 IRs on the cascade's 'selected' -------------------
    sel152 = run_sel152(dev, configure, select, KeepSink, reset_counts, rm,
                        ms)

    # -- 30. chunked serving at full width ----------------------------------------------
    t0 = time.perf_counter()
    chunked = run_chunked(bank, irs, dev, configure, select, KeepSink,
                          reset_counts, rm, ms)
    chunked_s = time.perf_counter() - t0

    # -- 31. the operational surface through the CLI --------------------------------------
    surface = run_ops_surface(irs, dev, reset_counts, rm, ms)
    print(f"phases 30-31: {chunked_s:.1f} s and {surface['wall_s']:.1f} s "
          f"wall")

    # -- 32. the device mesh ------------------------------------------------------------
    mesh = run_mesh(bank, irs, ws_bank, dev, configure, select, reset_counts,
                    rm, ms)

    # -- 33. roll mode at 96 voices: mac_shift below its 128-row tile ------------------
    roll96 = run_roll96(bank, irs, dev, configure, select, reset_counts, rm,
                        ms)

    # -- 34. the host link ------------------------------------------------------------
    link = run_host_link(bank, irs, ws_bank, dev, configure, select,
                         KeepSink, reset_counts, rm, ms)

    tag = f"[{card}]"
    lines = []
    shorts = {"step_coef_steady": "steady", "step_coef_indexed": "indexed",
              "step_coef": "general"}
    for key, (p50, p99) in step_ms.items():
        mode, short = key[0], shorts[key[1]]
        if len(key) == 3:   # (device busy us, device ops) per step
            lines += [(f"{mode}_{short}_step_device_busy_us", p50),
                      (f"{mode}_{short}_step_device_ops", p99)]
        else:
            lines += [(f"{mode}_{short}_step_p50_ms", p50),
                      (f"{mode}_{short}_step_p99_ms", p99)]
    for step_name, (p50, p99, busy, ops) in big["steps"].items():
        mode = ("fmajor1024" if step_name.startswith("fmajor")
                else "cascade1024")
        short = shorts[step_name.replace("fmajor_", "")]
        lines += [(f"{mode}_{short}_step_p50_ms", p50),
                  (f"{mode}_{short}_step_p99_ms", p99),
                  (f"{mode}_{short}_step_device_busy_us", busy),
                  (f"{mode}_{short}_step_device_ops", ops)]
    for dtype, timed in cas_timed.items():
        for shape, t in timed.items():
            key = (f"ring_mac_cascade_{shape}"
                   + ("_bf16" if dtype == "bf16" else ""))
            lines += [(f"{key}_kernel_us", t["kernel"] * 1e3),
                      (f"{key}_kernel_GBps",
                       t["bytes"] / (t["kernel"] * 1e-3) / 1e9),
                      (f"{key}_plain_us", t["plain"] * 1e3),
                      (f"{key}_library_us", t["library"] * 1e3),
                      (f"{key}_bound_us", t["bound"] * 1e3)]
    for kernel, timed in (("ring_mac", ring_ms), ("mac_shift", shift_ms)):
        for kod, t in timed.items():
            key = kernel if kod == kod_full else f"{kernel}_kod{kod}"
            lines += [(f"{key}_kernel_us", t["kernel"] * 1e3),
                      (f"{key}_kernel_GBps",
                       t["bytes"] / (t["kernel"] * 1e-3) / 1e9),
                      (f"{key}_plain_us", t["plain"] * 1e3),
                      (f"{key}_bound_us", t["bound"] * 1e3)]
            for lib in ("library", "einsum"):
                if lib in t:
                    lines.append((f"{key}_{lib}_us", t[lib] * 1e3))
    for mode, s in (("ring", summary), ("roll", roll_summary),
                    ("selected", sel_summary), ("roll16", ceil_summary),
                    ("ring16", ring16_summary),
                    ("cascade64_write", cas_runs["write"]["summary"]),
                    ("cascade64_read", cas_runs["read"]["summary"]),
                    ("cascade1024", big["summary"])):
        lines += [(f"{mode}_session_wall_avg_ms_per_block", s["avg_ms"]),
                  (f"{mode}_session_wall_p50_ms_per_block", s["p50_ms"]),
                  (f"{mode}_session_wall_p99_ms_per_block", s["p99_ms"]),
                  (f"{mode}_session_rtf", s["rtf"]),
                  (f"{mode}_session_missed_deadlines", s["missed_deadlines"])]
    for mode, r in ws_runs.items():
        s = r["summary"]
        lines += [(f"ws_{mode}_build_s", r["build_s"]),
                  (f"ws_{mode}_bank_MB", r["bank_mb"]),
                  (f"ws_{mode}_peak_allocated_MB", r["peak_mb"]),
                  (f"ws_{mode}_fault_first_use_ms", r["first_ms"]),
                  (f"ws_{mode}_fault_first_use_wall_ms", r["first_wall_ms"]),
                  (f"ws_{mode}_fault_warm_median_ms", r["warm_ms"]),
                  (f"ws_{mode}_fault_warm_median_wall_ms", r["warm_wall_ms"]),
                  (f"ws_{mode}_session_wall_avg_ms_per_block", s["avg_ms"]),
                  (f"ws_{mode}_session_wall_p50_ms_per_block", s["p50_ms"]),
                  (f"ws_{mode}_session_wall_p99_ms_per_block", s["p99_ms"]),
                  (f"ws_{mode}_session_rtf", s["rtf"]),
                  (f"ws_{mode}_session_missed_deadlines",
                   s["missed_deadlines"]),
                  (f"ws_{mode}_iteration_p99_ms", r["iter_p99_ms"]),
                  (f"ws_{mode}_iterations_over_deadline",
                   r["iter_over"]),
                  (f"ws_{mode}_iterations_over_deadline_at_selects",
                   r["iter_over_at_selects"]),
                  (f"ws_{mode}_misses", r["misses"]),
                  (f"ws_{mode}_hits", r["hits"]),
                  (f"ws_{mode}_deferred", r["deferred"]),
                  (f"ws_{mode}_starved", r["starved"]),
                  (f"ws_{mode}_bank_max_abs_err", r["bank_err"]),
                  (f"ws_{mode}_golden_max_abs_err", r["golden_err"]),
                  (f"ws_{mode}_stale_ir_golden_max_abs_err", r["stale_err"])]
    lines += [("cascade64_swap_requested_block", CAS_SWAP_AT),
              ("cascade64_swap_applied_block", cas_runs["write"]["swap_at"]),
              ("cascade64_read_vs_write_max_abs_err", read_err),
              ("cascade1024_build_s", big["build_s"]),
              ("cascade1024_state_MB", big["state_mb"]),
              ("cascade1024_peak_allocated_MB", big["peak_mb"]),
              *((f"cascade1024_session_host_{what}_ms", ms)
                for what, ms in big["split"].items()),
              ("cascade_golden_max_abs_err",
               max(big["golden_err"],
                   *(r["golden_err"] for r in cas_runs.values()))),
              ("deadline_ms", DEADLINE_MS),
              ("bounce_segments", bounce["nseg"]),
              ("bounce_virtual_voices", VOICES * bounce["nseg"]),
              ("bounce_steps", bounce["warmup"] + bounce["seg_len"]),
              ("bounce_golden_max_abs_err", bounce["golden_err"]),
              ("bounce_takes_max_abs_err", bounce["takes_err"]),
              ("bounce_steady_step_512vv_p50_ms", bounce["step_vv"][0]),
              ("bounce_steady_step_512vv_p99_ms", bounce["step_vv"][1]),
              ("bounce_steady_step_512vv_device_busy_us", bounce["busy_us"]),
              ("bounce_steady_step_512vv_device_ops", bounce["ops"]),
              ("bounce_steady_step_64v_p50_ms", bounce["step_64"][0]),
              ("ring_mac_bounce_512vv_kernel_us",
               bounce["mac_ms"]["kernel"] * 1e3),
              ("ring_mac_bounce_512vv_plain_us",
               bounce["mac_ms"]["plain"] * 1e3),
              ("ring_mac_bounce_512vv_library_us",
               bounce["mac_ms"]["library"] * 1e3),
              ("ring_mac_bounce_512vv_bound_us",
               bounce["mac_ms"]["bound"] * 1e3),
              ("bounce_automated_stream_max_abs_err", auto["stream_err"]),
              ("bounce_automated_chunked_max_abs_err", auto["chunk_err"]),
              ("bounce_automated_session_s", auto["stream_s"]),
              *((f"bounce_{label}_golden_max_abs_err", f["golden_err"])
                for label, f in engines.items()),
              *((f"bounce_{label}_segments", f["nseg"])
                for label, f in engines.items()),
              ("golden_max_abs_err",
               max(golden_err, roll_err, sel_err, ceil_err, ring16_err,
                   *(r["golden_err"] for r in ws_runs.values())))]
    for label, r in recovery.items():
        key = f"recovery_{label}"
        lines += [(f"{key}_max_abs_err", r["err"]),
                  (f"{key}_bit_identical", int(r["exact"])),
                  (f"{key}_restarts", r["restarts"]),
                  (f"{key}_blocks_stepped", r["stepped"]),
                  (f"{key}_resilient_wall_s", r["wall_s"]),
                  (f"{key}_uninterrupted_wall_s", r["plain_s"]),
                  (f"{key}_checkpoint_MB", r["save_MB"]),
                  (f"{key}_saves", len(r["save_d2h_ms"])),
                  (f"{key}_save_d2h_ms_max", max(r["save_d2h_ms"])),
                  (f"{key}_save_write_ms_max", max(r["save_write_ms"])),
                  (f"{key}_save_block_ms_max", max(r["save_block_ms"])),
                  (f"{key}_save_blocks_missed_deadline", r["saves_missed"]),
                  (f"{key}_rebuild_s_max", max(r["rebuild_s"])),
                  (f"{key}_load_s_max", max(r["load_s"]))]
    s = live["summary"]
    lines += [("recovery_ring_golden_max_abs_err",
               recovery["ring"]["golden_err"]),
              ("live_wall_s", live["wall_s"]),
              ("live_p50_ms_per_block", s["p50_ms"]),
              ("live_p99_ms_per_block", s["p99_ms"]),
              ("live_rtf", s["rtf"]),
              ("live_missed_deadlines", s["missed_deadlines"]),
              ("live_underruns", live["underruns"]),
              ("live_clock_ticks", live["clock_ticks"]),
              ("live_clock_missed", live["clock_missed"]),
              ("live_select_applied_block", live["select_applied_block"]),
              ("live_wet_applied_block", live["wet_applied_block"]),
              ("live_latency_p50_ms", live["latency_p50_ms"]),
              ("live_latency_p99_ms", live["latency_p99_ms"]),
              ("live_latency_p50_blocks", live["latency_p50_blocks"]),
              ("live_latency_p99_blocks", live["latency_p99_blocks"]),
              ("live_golden_max_abs_err", live["golden_err"]),
              ("cli_bridge_app_ready_s", cli["ready_s"]),
              ("cli_bridge_app_wall_s", cli["app_s"]),
              ("cli_bridge_periods", cli["periods"]),
              ("cli_bridge_underruns", cli["underruns"]),
              ("cli_bridge_overruns", cli["overruns"]),
              ("cli_bridge_first_sounding_period",
               cli["first_sounding_period"]),
              ("cli_bridge_blocks_missed_deadline", cli["late_blocks"])]
    for label, r in (("monolithic", mono),
                     *((f"partitioned_{variant}", r)
                       for variant, r in part["runs"].items())):
        s = r["summary"]
        lines += [(f"{label}_build_s", r["build_s"]),
                  (f"{label}_bank_MB", r["bank_mb"]),
                  (f"{label}_peak_allocated_MB", r["peak_mb"]),
                  (f"{label}_session_wall_p50_ms_per_block", s["p50_ms"]),
                  (f"{label}_session_wall_p99_ms_per_block", s["p99_ms"]),
                  (f"{label}_session_rtf", s["rtf"]),
                  (f"{label}_session_missed_deadlines", s["missed_deadlines"]),
                  (f"{label}_golden_max_abs_err", r["golden_err"])]
        for step, (p50, p99, busy, ops) in r["steps"].items():
            lines += [(f"{label}_{step}_step_p50_ms", p50),
                      (f"{label}_{step}_step_p99_ms", p99),
                      (f"{label}_{step}_step_device_busy_us", busy),
                      (f"{label}_{step}_step_device_ops", ops)]
    lines += [("monolithic_fade_golden_max_abs_err", mono["fade_golden_err"]),
              ("monolithic_output_scale", mono["scale"]),
              ("monolithic_clamped_vs_cpu_max_abs_err", mono["clamp_err"]),
              ("monolithic_clamped_output_scale", mono["clamp_scale"]),
              ("monolithic_clamped_samples", mono["clamped"]),
              ("partitioned_coef_general_blocks",
               part["runs"]["coef"]["general_blocks"]),
              ("partitioned_coef_vs_materialized_max_abs_err",
               part["agree_err"]),
              ("bounce_partitioned_segments", part["bounce"]["nseg"]),
              ("bounce_partitioned_golden_max_abs_err",
               part["bounce"]["golden_err"]),
              ("bounce_partitioned_peak_allocated_MB",
               part["bounce"]["peak_mb"]),
              ("cli_groups_streamed_wall_s", groups["streamed_wall_s"]),
              ("cli_groups_bounced_wall_s", groups["bounced_wall_s"]),
              ("cli_groups_golden_lsb", groups["golden_lsb"]),
              ("cli_groups_bounced_vs_streamed_lsb", groups["bounce_lsb"])]
    takes = [(f"bounce_take{i + 1}", r) for i, r in enumerate(bounce["runs"])]
    takes += [(f"bounce_automated_{label.split()[0]}", f)
              for label, f in auto["figures"].items()]
    takes += [(f"bounce_{label}", f) for label, f in engines.items()]
    takes += [("bounce_partitioned", dict(part["bounce"], launches=0))]
    for prefix, r in takes:
        lines += [(f"{prefix}_{key}", r[key])
                  for key in ("wall_s", "prime_wall_s", "prime_device_ms",
                              "loop_wall_s", "collect_wall_s", "layout_wall_s",
                              "other_wall_s",
                              "steps", "ms_per_step", "x_real_time",
                              "voice_s_per_s", "launches")]
    lines += [(f"bounce_take{i + 1}_peak_allocated_MB", r["peak_mb"])
              for i, r in enumerate(bounce["runs"])]
    for kernel, timed in bf16_ms.items():
        for shape, t in timed.items():
            key = f"{kernel}_bf16_{shape}"
            lines += [(f"{key}_kernel_us", t["kernel"] * 1e3),
                      (f"{key}_kernel_GBps",
                       t["bytes"] / (t["kernel"] * 1e-3) / 1e9),
                      (f"{key}_plain_us", t["plain"] * 1e3),
                      (f"{key}_einsum_bf16_us", t["einsum"] * 1e3),
                      (f"{key}_bound_us", t["bound"] * 1e3)]
            if "library" in t:
                lines.append((f"{key}_library_bmm_us", t["library"] * 1e3))
    for label, r in (("fmajor_ring_bf16", fm16["ring"]),
                     ("fmajor_roll_bf16", fm16["roll"]),
                     (f"cascade{HUGE_VOICES}_bf16", huge),
                     (f"sel{SEL152_IRS}", sel152)):
        s = r["summary"]
        p50, p99, busy, ops = r["step"]
        lines += [(f"{label}_build_s", r["build_s"]),
                  (f"{label}_peak_allocated_MB", r["peak_mb"]),
                  (f"{label}_session_wall_p50_ms_per_block", s["p50_ms"]),
                  (f"{label}_session_wall_p99_ms_per_block", s["p99_ms"]),
                  (f"{label}_session_rtf", s["rtf"]),
                  (f"{label}_session_missed_deadlines", s["missed_deadlines"]),
                  (f"{label}_steady_step_p50_ms", p50),
                  (f"{label}_steady_step_p99_ms", p99),
                  (f"{label}_steady_step_device_busy_us", busy),
                  (f"{label}_steady_step_device_ops", ops)]
    p50, p99, busy, ops = huge["indexed"]
    gp50, gp99, gbusy, gops = sel152["general"]
    for (engine, dtype, step), figs in fm16["selected"].items():
        key = f"{engine}_selected_{dtype}_{step}_step"
        lines += [(f"{key}_{what}", value) for what, value in zip(
            ("p50_ms", "p99_ms", "device_busy_us", "device_ops"), figs)]
    lines += [("fmajor_ring_bf16_snr_vs_f32_db", fm16["ring"]["snr"]),
              ("fmajor_roll_bf16_snr_vs_f32_db", fm16["roll"]["snr"]),
              ("bounce_fmajor_bf16_snr_vs_f32_db", fm16["bounce"]["snr"]),
              ("bounce_fmajor_bf16_wall_s", fm16["bounce"]["wall_s"]),
              ("bounce_fmajor_bf16_x_real_time",
               fm16["bounce"]["x_real_time"]),
              (f"cascade{HUGE_VOICES}_bf16_golden_snr_db", huge["snr"]),
              (f"cascade{HUGE_VOICES}_bf16_state_MB", huge["state_mb"]),
              (f"cascade{HUGE_VOICES}_bf16_indexed_step_p50_ms", p50),
              (f"cascade{HUGE_VOICES}_bf16_indexed_step_p99_ms", p99),
              (f"cascade{HUGE_VOICES}_bf16_indexed_step_device_busy_us",
               busy),
              (f"cascade{HUGE_VOICES}_bf16_indexed_step_device_ops", ops),
              (f"cascade{HUGE_VOICES}_bf16_cli_wall_s", huge["cli_wall_s"]),
              (f"sel{SEL152_IRS}_golden_max_abs_err", sel152["golden_err"]),
              (f"sel{SEL152_IRS}_general_step_p50_ms", gp50),
              (f"sel{SEL152_IRS}_general_step_p99_ms", gp99),
              (f"sel{SEL152_IRS}_general_step_device_busy_us", gbusy),
              (f"sel{SEL152_IRS}_general_step_device_ops", gops),
              (f"sel{SEL152_IRS}_cli_wall_s", sel152["cli_wall_s"]),
              *((f"sel{SEL152_IRS}_{what}_first_use_ms", t)
                for what, t in sel152["first_ms"].items()),
              *((f"sel{SEL152_IRS}_{what}_warm_ms", t)
                for what, t in sel152["warm_ms"].items())]
    for label, r in chunked["runs"].items():
        s = r["summary"]
        lines += [(f"chunked_{label}_session_wall_p50_ms_per_block",
                   s["p50_ms"]),
                  (f"chunked_{label}_session_wall_p99_ms_per_block",
                   s["p99_ms"]),
                  (f"chunked_{label}_session_rtf", s["rtf"]),
                  (f"chunked_{label}_session_missed_deadlines",
                   s["missed_deadlines"]),
                  (f"chunked_{label}_session_wall_s", r["wall_s"])]
    for chunk, (busy, ops_per_block) in chunked["busy"].items():
        lines += [(f"chunked_ring_chunk{chunk}_steady_device_busy_us_per_block",
                   busy),
                  (f"chunked_ring_chunk{chunk}_steady_device_ops_per_block",
                   ops_per_block)]
    lines += [*((f"chunked_{kind}_vs_per_block_max_abs_err", err)
                for kind, err in chunked["errs"].items()),
              ("chunked_ring_golden_max_abs_err", chunked["golden_err"]),
              ("chunked_resilient_wall_s", chunked["resilient"]["wall_s"]),
              ("chunked_resilient_resume_block",
               chunked["resilient"]["resume_block"]),
              ("chunked_phase_wall_s", chunked_s),
              ("ops_partitioned_build_cache_miss_s", surface["build_miss_s"]),
              ("ops_partitioned_build_cache_hit_s", surface["build_hit_s"]),
              ("ops_cli_chunked_wall_s", surface["chunk_cli_s"]),
              ("ops_cli_profiled_wall_s", surface["profile_cli_s"]),
              ("ops_profile_ring_mac_count", surface["profile_ring_mac_count"]),
              ("ops_profile_ring_mac_p50_ms", surface["profile_ring_mac_p50_ms"]),
              ("ops_phase_wall_s", surface["wall_s"])]
    lines += [("mesh_cards", torch.cuda.device_count()),
              ("mesh_phase_wall_s", mesh["wall_s"]),
              ("mesh_a_golden_max_abs_err", mesh["golden_err"]),
              ("mesh_f_resume_block", mesh["resume_block"]),
              ("mesh_c_bf16_snr_vs_f32_db", mesh["c_snr"]),
              *((f"mesh_{key}_max_abs_err", err)
                for key, err in mesh["errs"].items()),
              *((f"mesh_{key}_bit_identical", int(exact))
                for key, exact in mesh["exact"].items())]
    for kernel, shapes in mesh["kernel_ms"].items():
        for shape, t in shapes.items():
            key = f"mesh_h_{kernel}_{shape}"
            lines += [(f"{key}_ms", t["kernel"]),
                      (f"{key}_plain_ms", t["plain"]),
                      (f"{key}_bound_ms", t["bound"])]
    lines += [(f"mesh_h_{kernel}_max_abs_err", err)
              for kernel, err in mesh["kernel_err"].items()]
    for label, (us, ops) in mesh["busy"].items():
        key = f"mesh_{label}_steady"
        lines += [(f"{key}_device_busy_us_per_block", us),
                  (f"{key}_device_ops_per_block", ops)]
    for label, r in mesh["runs"].items():
        for what in ("wall_s", "x_real_time", "exchanges_per_block",
                     "saves", "save_block_ms_max", "misses", "hits"):
            if what in r:
                lines.append((f"mesh_{label}_{what}", r[what]))
        if "summary" in r:
            s = r["summary"]
            lines += [(f"mesh_{label}_session_wall_p50_ms_per_block",
                       s["p50_ms"]),
                      (f"mesh_{label}_session_wall_p99_ms_per_block",
                       s["p99_ms"]),
                      (f"mesh_{label}_session_rtf", s["rtf"]),
                      (f"mesh_{label}_session_missed_deadlines",
                       s["missed_deadlines"])]
        lines += [(f"mesh_{label}_launches_{kernel}", n)
                  for kernel, n in r["launches"].items() if n]
        lines += [(f"mesh_{label}_peak_allocated_MB_{d}", mb)
                  for d, mb in r.get("peak_mb", {}).items()]
    lines += [("roll96_phase_wall_s", roll96["wall_s"]),
              ("roll96_golden_max_abs_err", roll96["golden_err"]),
              ("roll96_bf16_snr_vs_f32_db", roll96["snr"])]
    for dtype, r in roll96["runs"].items():
        s = r["summary"]
        p50, p99, busy, ops = r["step"]
        key = f"roll96_{dtype}"
        lines += [(f"{key}_build_s", r["build_s"]),
                  (f"{key}_peak_allocated_MB", r["peak_mb"]),
                  (f"{key}_session_wall_p50_ms_per_block", s["p50_ms"]),
                  (f"{key}_session_wall_p99_ms_per_block", s["p99_ms"]),
                  (f"{key}_session_rtf", s["rtf"]),
                  (f"{key}_session_missed_deadlines", s["missed_deadlines"]),
                  (f"{key}_steady_step_p50_ms", p50),
                  (f"{key}_steady_step_p99_ms", p99),
                  (f"{key}_steady_step_device_busy_us", busy),
                  (f"{key}_steady_step_device_ops", ops),
                  (f"{key}_launches", r["launches"])]
    for kernel, shapes in roll96["kernel_ms"].items():
        for shape, t in shapes.items():
            key = f"roll96_{kernel}_{shape}"
            lines += [(f"{key}_kernel_us", t["kernel"] * 1e3),
                      (f"{key}_plain_us", t["plain"] * 1e3),
                      (f"{key}_einsum_us", t["einsum"] * 1e3),
                      (f"{key}_bound_us", t["bound"] * 1e3)]
    lines += [("link_phase_wall_s", link["wall_s"]),
              ("link_ring64_batch16_f32_max_abs_err", link["ring_f32_err"]),
              ("link_ring64_batch16_pcm16_max_abs_err",
               link["ring_pcm16_err"]),
              *((f"link_cascade2048_bf16_{label}_max_abs_err", err)
                for label, err in link["cascade_errs"].items()),
              *((f"link_{label}_{key}", value)
                for label, fig in link["runs"].items()
                for key, value in fig.items()),
              *((f"link_upload152_{wire}_{key}", value)
                for wire, u in link["upload"].items()
                for key, value in u.items()),
              *((f"link_upload152_offgrid_{wire}_s{i}", t)
                for wire, ts in link["upload_offgrid_s"].items()
                for i, t in enumerate(ts)),
              *((f"link_prep_{kind}_{key}", value)
                for kind in ("fmajor", "cascade")
                for key, value in link[f"prep_{kind}"].items()),
              *((f"link_{label}_fault_{key}", value)
                for label, f in link["faults"].items()
                for key, value in f.items()),
              ("link_ws_ring_td_max_abs_err", link["ws_ring_td_err"]),
              ("link_ws_roll_td_max_abs_err", link["ws_roll_td_err"])]
    for key, value in lines:
        print(f"{key} {value} {tag}")

    def timings(t):
        return {"ms": t["kernel"], "plain_ms": t["plain"],
                "library_ms": t.get("library"), "bound_ms": t["bound"],
                "bound_by": t["bound_by"]}

    def entry(name, replaces, launches, err, timed, source=None, **extra):
        """The kernel's line entry at the 4-IR sessions' shapes (KOD=16),
        with every timed 64-voice KOD (4, 9 and 16 IRs) under per_kod."""
        per_kod = {kod: timings(t) for kod, t in timed.items()}
        return {"name": name, "route": "cuda",
                "source": source or f"tpu_audio_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, **per_kod[kod_full], "per_kod": per_kod,
                **extra}

    def bf16_kods(kernel):
        return {kod: bf16_ms[kernel][f"kod{kod}"] for kod in RING_KODS}

    def mesh_shapes(kernel):
        """The kernel's timings at phase 32's shard shapes, and its
        largest error there."""
        return ({shape: timings(t)
                 for shape, t in mesh["kernel_ms"].get(kernel, {}).items()},
                mesh["kernel_err"].get(kernel, 0.0))

    def roll96_shapes(kernel):
        """The kernel's timings at phase 33's shape."""
        return {shape: timings(t)
                for shape, t in roll96["kernel_ms"][kernel].items()}

    print(json.dumps({"kernels": [
        entry("ring_mac", "tpu_audio/ops/pallas_mac.py:160",
              launches + ring16_launches
              + sum(r["launches"] for r in ws_runs.values())
              + sum(r["launches"] for r in cas_runs.values())
              + big["launches"] + bounce["launches"] + auto["launches"]
              + engines["cascade"]["launches"]
              + sum(r["launches"] for r in recovery.values())
              + live["launches"]
              + sum(r["launches"]["ring_mac"]
                    for r in chunked["runs"].values())
              + chunked["resilient"]["launches"] + surface["launches"]
              + mesh["launches"]["ring_mac"] + link["launches"]["ring_mac"],
              max(max_abs_err, cas_err, bounce["mac_err"],
                  engines["cascade"]["mac_err"], mesh_shapes("ring_mac")[1]),
              ring_ms,
              cascade={shape: timings(t) for shape, t in cas_ms.items()},
              bounce={f"vi{2 * VOICES * bounce['nseg']}_kod{kod_full}":
                      timings(bounce["mac_ms"])},
              mesh=mesh_shapes("ring_mac")[0]),
        entry("mac_shift", "tpu_audio/ops/pallas_mac.py:76",
              roll_launches + ceil_launches + engines["roll"]["launches"]
              + sum(r["launches"]["mac_shift"]
                    for r in chunked["runs"].values())
              + mesh["launches"]["mac_shift"]
              + roll96["runs"]["f32"]["launches"]
              + link["launches"]["mac_shift"],
              max(shift_err, engines["roll"]["mac_err"],
                  mesh_shapes("mac_shift")[1],
                  roll96["kernel_err"]["mac_shift"]), shift_ms,
              mesh=mesh_shapes("mac_shift")[0],
              roll96=roll96_shapes("mac_shift")),
        # the bf16 kernels (mac_dtype='bf16'): ring_mac's library_ms is
        # torch.bmm on the same bf16 operands with f32 out (the bf16
        # einsum, which rounds m to bf16, is printed on its own lines);
        # mac_shift has none
        entry("ring_mac_bf16", "tpu_audio/ops/pallas_mac.py:160",
              fm16["ring"]["launches"] + fm16["bounce"]["launches"]
              + huge["launches"] + huge["cli_launches"]
              + sum(r["launches"]["ring_mac_bf16"]
                    for r in chunked["runs"].values())
              + mesh["launches"]["ring_mac_bf16"]
              + link["launches"]["ring_mac_bf16"],
              max(bf16_err["ring_mac"], cas_errs["bf16"],
                  mesh_shapes("ring_mac_bf16")[1]),
              bf16_kods("ring_mac"),
              source="tpu_audio_torch/csrc/ring_mac.cu",
              cascade={**{shape: timings(t) for shape, t
                          in bf16_ms["ring_mac"].items()
                          if not shape.startswith("kod")},
                       **{shape: timings(t) for shape, t
                          in cas_timed["bf16"].items()}},
              mesh=mesh_shapes("ring_mac_bf16")[0]),
        entry("mac_shift_bf16", "tpu_audio/ops/pallas_mac.py:76",
              fm16["roll"]["launches"] + mesh["launches"]["mac_shift_bf16"]
              + roll96["runs"]["bf16"]["launches"],
              max(bf16_err["mac_shift"], mesh_shapes("mac_shift_bf16")[1],
                  roll96["kernel_err"]["mac_shift_bf16"]),
              bf16_kods("mac_shift"),
              source="tpu_audio_torch/csrc/mac_shift.cu",
              mesh=mesh_shapes("mac_shift_bf16")[0],
              roll96=roll96_shapes("mac_shift_bf16"))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
