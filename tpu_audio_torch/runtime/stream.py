"""Host streaming loop around the engine step (port of
tpu_audio/runtime/stream.py: MidiSchedule and the per-block StreamSession).

Capability equivalent of the reference's JACK process-callback runtime
(reference src/jackclient.cu:4-11 + src/conv.cu:287-466 + src/main.cu:82-95):

  - each block is uploaded, stepped and its output copied back on the
    device's stream; PyTorch queues the work and returns, so block t's
    step is enqueued before block t - pipeline_depth is handed to the sink
    (the reference overlaps H2D/compute/D2H with 4 CUDA streams,
    src/conv.cu:149-153);
  - per-block wall timing with warmup discard (reference _nruns = -10,
    src/conv.h:80), p50/p99, RTF and a missed-deadline count;
  - scripted MIDI events are applied between blocks through the
    ControlPlane (reference's per-device MIDI thread, src/midi.cu:22-59);
  - coefficient-engine management driven by HOST mirrors, never by device
    reads (the hot path does not sync): an analytic coef_a mirror selects
    the steady step once every crossfade has decayed, the indexed (span)
    step while one is live, and collapse_pure on each IR re-select.

Left out of this port for now: mesh serving, chunked dispatch, batched
fetches and the pcm16 wire, layout pinning, checkpoints and live bank
swaps.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from tpu_audio_torch.engine.params import ControlPlane
from tpu_audio_torch.runtime.backends import BlockSink, BlockSource
from tpu_audio_torch.utils.log import Log
from tpu_audio_torch.utils.profiling import BlockTimer

STEADY_THRESHOLD = 1e-6  # coef_a below this ≈ crossfade fully decayed


class MidiSchedule:
    """Scripted MIDI event stream: (block_index, device, message_bytes)."""

    def __init__(self, events: list[tuple[int, str, bytes]] = ()):  # noqa: B006
        self._events = sorted(events, key=lambda e: e[0])
        self._next = 0

    @classmethod
    def parse(cls, text: str) -> "MidiSchedule":
        """One event per line: ``<block> [dev=<id>] <hex bytes...>``, e.g.
        ``100 B0 15 40`` or ``100 dev=hw:2,0 B0 15 40``. '#' comments.

        An explicit ``dev=`` prefix is unambiguous and preferred; a bare
        second token containing a non-hex character is still accepted as a
        device id."""
        def is_hex(tok: str) -> bool:
            return all(c in "0123456789abcdefABCDEF" for c in tok) and len(tok) <= 2

        events = []
        for lineno, raw in enumerate(text.splitlines(), start=1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            tokens = line.split()
            rest = tokens[1:]
            device = ""
            if rest and rest[0].startswith("dev="):
                device, rest = rest[0][4:], rest[1:]
            elif rest and not is_hex(rest[0]):
                device, rest = rest[0], rest[1:]
            try:
                block = int(tokens[0])
                data = bytes(int(t, 16) for t in rest)
            except ValueError as exc:
                raise ValueError(
                    f"MIDI schedule line {lineno}: {exc} "
                    f"(line was: {raw.strip()!r}; format is "
                    f"'<block> [dev=<id>] <hex bytes 00-FF...>')") from exc
            events.append((block, device, data))
        return cls(events)

    def pop_due(self, block_index: int) -> list[tuple[str, bytes]]:
        due = []
        while (self._next < len(self._events)
               and self._events[self._next][0] <= block_index):
            _, device, data = self._events[self._next]
            due.append((device, data))
            self._next += 1
        return due


class StreamSession:
    """Drives (source -> engine step -> sink) to completion."""

    def __init__(self, engine, bank, control: ControlPlane,
                 source: BlockSource, sink: BlockSink,
                 sample_rate: int = 44100, warmup: int = 10,
                 realtime: bool = False,
                 pipeline_depth: int = 1, underrun_policy: str = "stop",
                 max_consecutive_underruns: int | None = None):
        if getattr(engine, "mac_strategy", None) != "allk":
            raise NotImplementedError("the port's StreamSession drives the "
                                      "fmajor 'allk' engine")
        self.engine = engine
        self.bank = bank
        self.device = engine.device
        self.control = control
        self.source = source
        self.sink = sink
        self.sample_rate = sample_rate
        self.realtime = realtime
        # how many blocks may be in flight between dispatch and sink
        # delivery: 1 = classic double buffering
        self.pipeline_depth = max(1, pipeline_depth)
        # "stop": end the stream when the source runs dry (file processing);
        # "silence": substitute silent blocks and keep real time, bounded
        # only by max_consecutive_underruns (None = ride out any outage)
        if underrun_policy not in ("stop", "silence"):
            raise ValueError(f"unknown underrun_policy {underrun_policy!r}")
        self.underrun_policy = underrun_policy
        self.max_consecutive_underruns = max_consecutive_underruns
        self.underruns = 0
        self._consecutive_underruns = 0
        self.block_period = engine.block / sample_rate
        self.timer = BlockTimer(warmup=warmup, deadline_s=self.block_period)
        self._missed_logged = 0
        self.blocks_streamed = 0
        self.indexed_blocks = 0

        self._step_steady = engine.step_coef_steady
        self._step_indexed = engine.step_coef_indexed
        self._collapse_pure = engine.collapse_pure
        # analytic host mirror of coef_a for the steady/indexed switch, and
        # of span purity (base_pure) for the collapse_pure precondition
        self._a_host = np.zeros((engine.num_voices, 2), np.float64)
        self._pure_host = np.ones((engine.num_voices, 2), bool)
        self._pending_old: dict[tuple[int, int], int] = {}
        control.on_select_change = self._note_select_change

    # -- coef-engine hooks ---------------------------------------------------------

    def _note_select_change(self, voice: int, ch: int, old: int, new: int) -> None:
        # keep the select the engine last stepped with (first change wins
        # between two steps)
        self._pending_old.setdefault((voice, ch), old)

    def _indexed_valid(self) -> bool:
        """True when every voice whose fade still matters (a >= threshold)
        has span provenance in state — the indexed step / collapse_pure
        precondition. Converged voices' base terms are < -120 dB, so stale
        provenance there never gates."""
        return bool((self._pure_host
                     | (self._a_host < STEADY_THRESHOLD)).all())

    def _maybe_collapse(self, state):
        if not self._pending_old:
            return state
        # collapse_pure is exact iff the pre-state was indexed-valid: every
        # changed voice is then either pure (the affine re-base stays in
        # the span, interrupted fades included) or converged (its stale span
        # restarts at c*onehot). The materializing collapse that would
        # serve the other case is not part of this port.
        if not self._indexed_valid():
            raise NotImplementedError(
                "re-select while a materialized fade is live needs the "
                "materializing collapse, which this port does not have yet")
        old_sel = self.control.select.copy()
        changed = np.zeros_like(old_sel, dtype=bool)
        for (v, ch), old in self._pending_old.items():
            old_sel[v, ch] = old
            changed[v, ch] = True
            self._a_host[v, ch] = 1.0
            self._pure_host[v, ch] = True
        self._pending_old.clear()
        return self._collapse_pure(
            state, torch.tensor(old_sel, device=self.device),
            torch.tensor(changed, device=self.device))

    def _underrun_stop(self) -> bool:
        """Account one silence-substituted underrun; True when the
        consecutive-underrun cap says the session should end instead."""
        self.underruns += 1
        self._consecutive_underruns += 1
        if (self.max_consecutive_underruns is not None
                and self._consecutive_underruns > self.max_consecutive_underruns):
            Log.warn("stream", "source dry for %d consecutive blocks; stopping",
                     self._consecutive_underruns - 1)
            return True
        return False

    # -- device transfer ---------------------------------------------------------------

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        # a copy, never a view of the source's buffer: the state keeps this
        # block as prev_in. On CUDA the copy goes through a fresh pinned
        # buffer so the host->device transfer is queued, not waited for.
        if self.device.type != "cuda":
            return torch.tensor(x, device=self.device)
        pinned = torch.from_numpy(np.asarray(x, np.float32)).pin_memory()
        return pinned.to(self.device, non_blocking=True)

    def _start_fetch(self, out: torch.Tensor):
        """Queue the device->host copy of one output block; returns what
        _deliver needs to wait for it."""
        if out.device.type != "cuda":
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    def _deliver(self, host: torch.Tensor, done) -> None:
        if done is not None:
            done.synchronize()
        self.sink.write(host.numpy())

    # -- main loop ---------------------------------------------------------------------

    def run(self, state, max_blocks: int | None = None,
            midi: MidiSchedule | None = None):
        """Stream until the source ends (or max_blocks). Returns final state.

        The engine updates the state's delay line and wet ring in place:
        the state passed in is consumed."""
        # resync the analytic mirrors from the state (one host read, before
        # the loop) so a session started mid-crossfade keeps the fade step
        self._a_host = state.coef_a.double().cpu().numpy()
        self._pure_host = state.base_pure.cpu().numpy().copy()

        pending = collections.deque()
        block_index = 0
        next_deadline = time.perf_counter() + self.block_period

        while max_blocks is None or block_index < max_blocks:
            x = self.source.read()
            if x is None:
                if self.underrun_policy == "stop" or self._underrun_stop():
                    break
                x = np.zeros((self.engine.num_voices, 2, self.engine.block),
                             np.float32)
            else:
                self._consecutive_underruns = 0

            if midi is not None:
                for device, message in midi.pop_due(block_index):
                    self.control.apply_midi_message(message, device)

            self.timer.start()
            state = self._maybe_collapse(state)
            vsteps = self.control.vsteps.astype(np.float64)
            if bool((self._a_host < STEADY_THRESHOLD).all()):
                step = self._step_steady
            elif self._indexed_valid():
                step = self._step_indexed
                self.indexed_blocks += 1
            else:
                raise NotImplementedError(
                    "a materialized fade is live; the general fade step is "
                    "not part of this port yet")
            # advance the analytic coef_a mirror exactly like the device
            # recursion does
            self._a_host *= 1.0 - 1.0 / (vsteps + 5.0)

            params = self.control.snapshot_device()
            state, out = step(state, self.bank, params, self._upload(x))
            self.control.end_block()

            # pipelined delivery: queue this block's device->host copy now,
            # deliver the block from `pipeline_depth` steps ago
            pending.append(self._start_fetch(out))
            if len(pending) >= self.pipeline_depth + 1:
                self._deliver(*pending.popleft())

            elapsed = self.timer.stop()
            if (elapsed > self.block_period
                    and self.timer.missed > self._missed_logged):
                self._missed_logged = self.timer.missed
                Log.debug("stream", "missed deadline at block %d: %.2f ms",
                          block_index, elapsed * 1e3)

            if self.realtime:
                now = time.perf_counter()
                if now < next_deadline:
                    time.sleep(next_deadline - now)
                next_deadline += self.block_period
            block_index += 1

        while pending:
            self._deliver(*pending.popleft())
        self.sink.close()
        self.blocks_streamed += block_index
        return state

    # -- reporting ------------------------------------------------------------------------

    def summary(self) -> dict:
        s = self.timer.summary(self.block_period)
        s["sample_rate"] = self.sample_rate
        s["block"] = self.engine.block
        s["num_voices"] = self.engine.num_voices
        s["blocks_streamed"] = self.blocks_streamed
        s["underruns"] = self.underruns
        return s
