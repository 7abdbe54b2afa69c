"""Voice parameter plane: MIDI CC -> per-voice engine parameters (port of
tpu_audio/engine/params.py).

Capability equivalent of the reference's control path (reference
src/conv.h:33-50 ``struct CC``, src/conv.cu:255-285 ``handleCC``/
``onMidiMessage``, and the settings wiring src/main.cu:54-70).

Parameters are HOST-owned numpy arrays mutated by MIDI/scripted events
between blocks; ``snapshot_device()`` uploads them as small [V, 2] tensors
only when they changed, and the ``vsteps`` crossfade countdown (decremented
once per block by the reference audio thread, src/conv.cu:345,353) advances
on the device between uploads.

CC value scalings are the reference's exactly (src/conv.cu:255-276):
  select   = v * bank_size / 128        (resets vsteps to speed)
  predelay = v * 8192 / 128
  dry/wet/level = v / 128
  panDry/panWet = v / 64 - 1
  speed    = v * 1024 / 128             (clamps vsteps down to new speed)
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from tpu_audio_torch.ops.smoother import vsteps_decrement
from tpu_audio_torch.utils.device import resolve_device
from tpu_audio_torch.utils.log import Log

CC_MAX_PREDELAY = 8192  # reference src/conv.h:26-28
CC_MAX_SPEED = 1024     # reference src/conv.h:22-24


@dataclass
class CCMapping:
    """Controller-number assignment for one engine channel
    (reference settings keys conv[i].cc.*, src/main.cu:54-62)."""

    device: str = ""
    message: int = 0xB0
    select: int = 0
    predelay: int = 0
    dry: int = 0
    wet: int = 0
    speed: int = 0
    pan_dry: int = 0
    pan_wet: int = 0
    level: int = 0

    @classmethod
    def from_settings(cls, settings, idx: int) -> "CCMapping":
        return cls(
            device=settings.str("conv[%d].cc.device", idx, default=""),
            message=settings.u8("conv[%d].cc.message", idx, default=0xB0),
            select=settings.u8("conv[%d].cc.select", idx, default=0),
            predelay=settings.u8("conv[%d].cc.predelay", idx, default=0),
            dry=settings.u8("conv[%d].cc.dry", idx, default=0),
            wet=settings.u8("conv[%d].cc.wet", idx, default=0),
            speed=settings.u8("conv[%d].cc.speed", idx, default=0),
            pan_dry=settings.u8("conv[%d].cc.panDry", idx, default=0),
            pan_wet=settings.u8("conv[%d].cc.panWet", idx, default=0),
            level=settings.u8("conv[%d].cc.level", idx, default=0),
        )


@dataclass
class VoiceParams:
    """Per-block parameter snapshot. Every field is [V, 2] (V stereo voices
    x 2 engine channels, the reference's cc[2] pair): numpy arrays on the
    host (ControlPlane.snapshot), tensors on a device (snapshot_device)."""

    select: torch.Tensor    # int32, bank index
    predelay: torch.Tensor  # int32, samples [0, max_predelay]
    vsteps: torch.Tensor    # int32, crossfade countdown
    dry: torch.Tensor       # f32 [0, 1]
    wet: torch.Tensor       # f32 [0, 1]
    pan_dry: torch.Tensor   # f32 [-1, 1]
    pan_wet: torch.Tensor   # f32 [-1, 1]
    level: torch.Tensor     # f32 [0, 1]

    def to(self, device) -> "VoiceParams":
        """Upload every field to `device` as a COPY: torch.from_numpy would
        share the host buffer on the CPU, and a later in-place host update
        would then change the uploaded parameters too."""
        return VoiceParams(**{
            f.name: torch.tensor(np.asarray(getattr(self, f.name)),
                                 device=device)
            for f in fields(self)})


class ControlPlane:
    """Host-side parameter store for V stereo voices.

    Mutates numpy arrays on CC events / direct sets; snapshot() yields the
    host VoiceParams for the next block; end_block() advances countdowns.
    `device` (where snapshot_device uploads to): None or "cuda" selects the
    best CUDA device (select_gpu, which raises without CUDA); "cpu" keeps
    the parameters on the CPU.
    """

    def __init__(self, num_voices: int, bank_size: int,
                 max_predelay: int = CC_MAX_PREDELAY, device=None):
        self.num_voices = num_voices
        self.bank_size = bank_size
        self.max_predelay = max_predelay
        self.device = resolve_device(device)
        v = num_voices
        # per-channel bank windows: each (voice, ch) selects from the slice
        # [select_base, select_base + select_span) of the merged bank (see
        # ConvolutionReverb.from_settings / set_channel_banks)
        self.select_base = np.zeros((v, 2), np.int32)
        self.select_span = np.full((v, 2), max(bank_size, 1), np.int32)
        self.select = np.zeros((v, 2), np.int32)
        self.predelay = np.zeros((v, 2), np.int32)
        self.vsteps = np.zeros((v, 2), np.int32)
        self.speed = np.full((v, 2), 100, np.int32)  # reference conv.h:40
        self.dry = np.full((v, 2), 0.5, np.float32)
        self.wet = np.full((v, 2), 0.5, np.float32)
        self.pan_dry = np.zeros((v, 2), np.float32)
        self.pan_wet = np.zeros((v, 2), np.float32)
        self.level = np.ones((v, 2), np.float32)
        self.mappings: dict[tuple[int, int], CCMapping] = {}
        self._device_params = None  # cached device snapshot
        self._host_cache = None
        self._dirty = True
        self.uploads = 0  # param-upload counter
        self.blocks = 0  # processed-block counter (the working set's clock)
        # sessions subscribe here to collapse on IR re-select
        self.on_select_change = None  # callback (voice, ch, old, new)
        # optional full-bank-index -> engine-slot translation installed by
        # runtime/working_set.py; CC scaling and per-channel bank windows
        # stay in full-bank coordinates, `select` then holds slot indices
        self.select_remap = None      # callable (voice, ch, full_idx) -> slot
        # between-blocks callbacks (e.g. async working-set paging publishes
        # completed slot uploads here), fired at the END of end_block
        self.block_hooks: list = []
        # auxiliary runtime state kept beside the parameters (numpy arrays
        # keyed by name): the working set keeps its host-side maps here and
        # registers on_aux_restored to rebuild device residency after a
        # checkpoint load
        self.aux: dict = {}
        self.on_aux_restored = None
        # fired by sessions immediately BEFORE a checkpoint is written:
        # subsystems with in-flight host-side work (async working-set
        # uploads and their deferred selects) publish it so the checkpoint
        # captures a consistent world
        self.pre_checkpoint_hooks: list = []

    # -- wiring ---------------------------------------------------------------

    def set_mapping(self, voice: int, ch: int, mapping: CCMapping) -> None:
        self.mappings[(voice, ch)] = mapping

    def set_channel_banks(self, windows: list[tuple[int, int]]) -> None:
        """Give each engine channel its own (offset, size) window into the
        merged bank, applied to every voice. Pass one window to share a
        bank (the default), or one per channel for per-channel banks."""
        self._dirty = True
        for ch in range(2):
            off, size = windows[min(ch, len(windows) - 1)]
            self.select_base[:, ch] = off
            self.select_span[:, ch] = max(size, 1)
            if self.select_remap is None:
                # clamp existing selections into the new window; under
                # working-set residency `select` holds SLOT indices (a
                # different coordinate space) and the remap hook applies
                # the windows at event time instead
                self.select[:, ch] = np.clip(self.select[:, ch], off,
                                             off + max(size, 1) - 1)

    def load_initial_values(self, settings, voice: int, ch: int, idx: int) -> None:
        """Initial values from settings (reference src/main.cu:63-70)."""
        self._dirty = True
        sel = settings.u32("conv[%d].value.select", idx, default=0)
        full = (self.select_base[voice, ch]
                + min(sel, max(self.select_span[voice, ch] - 1, 0)))
        if self.select_remap is not None:
            full = self.select_remap(voice, ch, int(full))
        self.select[voice, ch] = full
        pd = settings.u32("conv[%d].value.predelay", idx, default=0)
        if pd > self.max_predelay:
            # an out-of-range predelay would match no wet-ring slot and
            # silently mute the voice; clamp like the CC path does
            Log.warn("conv", "predelay %d exceeds maxPredelay %d; clamped",
                     pd, self.max_predelay)
            pd = self.max_predelay
        self.predelay[voice, ch] = pd
        self.dry[voice, ch] = settings.f32("conv[%d].value.dry", idx, default=0.5)
        self.wet[voice, ch] = settings.f32("conv[%d].value.wet", idx, default=0.5)
        self.speed[voice, ch] = settings.u32("conv[%d].value.speed", idx, default=100)
        self.pan_dry[voice, ch] = settings.f32("conv[%d].value.panDry", idx, default=0.0)
        self.pan_wet[voice, ch] = settings.f32("conv[%d].value.panWet", idx, default=0.0)
        self.level[voice, ch] = settings.f32("conv[%d].value.level", idx, default=1.0)

    # -- events -----------------------------------------------------------------

    def apply_cc(self, voice: int, ch: int, status: int, controller: int,
                 value: int) -> bool:
        """Apply one CC event to one engine channel with reference scalings
        (src/conv.cu:255-276). Returns True if any parameter changed."""
        m = self.mappings.get((voice, ch))
        if m is None or status != m.message:
            return False
        hit = False
        self._dirty = True
        if controller == m.select:
            new = (int(self.select_base[voice, ch])
                   + value * int(self.select_span[voice, ch]) // 128)
            if self.select_remap is not None:
                new = int(self.select_remap(voice, ch, new))
            old = int(self.select[voice, ch])
            self.select[voice, ch] = new
            self.vsteps[voice, ch] = self.speed[voice, ch]
            Log.info("conv", "Selected IR %d", new)
            if new != old and self.on_select_change is not None:
                self.on_select_change(voice, ch, old, new)
            hit = True
        if controller == m.predelay:
            self.predelay[voice, ch] = value * self.max_predelay // 128
            hit = True
        if controller == m.dry:
            self.dry[voice, ch] = value / 128.0
            hit = True
        if controller == m.wet:
            self.wet[voice, ch] = value / 128.0
            hit = True
        if controller == m.pan_dry:
            self.pan_dry[voice, ch] = value / 64.0 - 1.0
            hit = True
        if controller == m.pan_wet:
            self.pan_wet[voice, ch] = value / 64.0 - 1.0
            hit = True
        if controller == m.level:
            self.level[voice, ch] = value / 128.0
            hit = True
        if controller == m.speed:
            self.speed[voice, ch] = value * CC_MAX_SPEED // 128
            self.vsteps[voice, ch] = min(self.vsteps[voice, ch],
                                         self.speed[voice, ch])
            hit = True
        return hit

    def apply_midi_message(self, message: bytes, device: str = "") -> None:
        """Dispatch a framed MIDI message to every channel mapped to
        `device` (reference onMidiMessage, src/conv.cu:278-285)."""
        if len(message) < 3:
            return
        status, controller, value = message[0], message[1], message[2]
        for (voice, ch), m in self.mappings.items():
            if not device or m.device == device:
                self.apply_cc(voice, ch, status, controller, value)

    def set_select(self, voice: int, ch: int, index: int) -> None:
        """Direct (non-MIDI) IR selection with crossfade, like a CC hit.
        `index` is a FULL-bank index; working-set residency remaps it to
        a device slot exactly like the CC path."""
        self._dirty = True
        if self.select_remap is not None:
            index = int(self.select_remap(voice, ch, index))
        elif not 0 <= index < max(self.bank_size, 1):
            # clamp like snapshot() will: storing the raw index would
            # desync the played IR from the collapse provenance
            Log.warn("params", "select %d outside the %d-IR bank; clamped",
                     index, self.bank_size)
            index = min(max(index, 0), max(self.bank_size - 1, 0))
        old = int(self.select[voice, ch])
        self.select[voice, ch] = index
        self.vsteps[voice, ch] = self.speed[voice, ch]
        if index != old and self.on_select_change is not None:
            self.on_select_change(voice, ch, old, index)

    # -- per-block ---------------------------------------------------------------

    def snapshot(self) -> VoiceParams:
        """Host parameter snapshot for the next block step."""
        return VoiceParams(
            select=np.clip(self.select, 0, max(self.bank_size - 1, 0)),
            predelay=self.predelay.copy(),
            vsteps=self.vsteps.copy(),
            dry=self.dry.copy(),
            wet=self.wet.copy(),
            pan_dry=self.pan_dry.copy(),
            pan_wet=self.pan_wet.copy(),
            level=self.level.copy(),
        )

    def end_block(self, blocks: int = 1) -> None:
        """Advance the crossfade countdown (reference src/conv.cu:345,353)
        by `blocks` blocks (a chunked session's chunk, runtime/stream.py).

        The countdown is carried ON DEVICE between uploads: the cached
        device params advance with one small device-side op and the host
        cache follows in lockstep, so a crossfade in flight uploads no
        parameters per block. Real parameter events still mark the plane
        dirty and re-upload."""
        self.blocks += blocks
        np.maximum(self.vsteps - blocks, 0, out=self.vsteps)
        if (self._device_params is not None and self._host_cache is not None
                and self._host_cache.vsteps.any()):
            # fresh buffers on both sides (snapshot_device uploads copies,
            # so neither can alias the other)
            self._host_cache = replace(
                self._host_cache,
                vsteps=np.maximum(self._host_cache.vsteps - blocks, 0))
            self._device_params = replace(
                self._device_params,
                vsteps=vsteps_decrement(self._device_params.vsteps, blocks))
        # between-blocks hooks fire LAST (after the countdown advance), once
        # per call, so an event they raise — e.g. async paging re-issuing a
        # deferred select with fresh vsteps — is not clobbered by this
        # call's decrement and behaves exactly like a next-block (next-
        # chunk) MIDI event
        for hook in self.block_hooks:
            hook()

    def snapshot_device(self) -> VoiceParams:
        """Device-resident VoiceParams, re-uploaded only when parameters
        changed since the last call. Safe against direct array mutation:
        change detection compares against the last-uploaded host values."""
        host = self.snapshot()
        if (self._device_params is None or self._dirty
                or any(not np.array_equal(getattr(host, f.name),
                                          getattr(self._host_cache, f.name))
                       for f in fields(host))):
            self._device_params = host.to(self.device)
            self._host_cache = host
            self._dirty = False
            self.uploads += 1
        return self._device_params
