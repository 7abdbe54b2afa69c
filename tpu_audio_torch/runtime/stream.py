"""Host streaming loop around the engine step (port of
tpu_audio/runtime/stream.py: MidiSchedule and the per-block StreamSession).

Capability equivalent of the reference's JACK process-callback runtime
(reference src/jackclient.cu:4-11 + src/conv.cu:287-466 + src/main.cu:82-95):

  - each block is uploaded, stepped and its output copied back on the
    device's stream; PyTorch queues the work and returns, so block t's
    step is enqueued before block t - pipeline_depth is handed to the sink
    (the reference overlaps H2D/compute/D2H with 4 CUDA streams,
    src/conv.cu:149-153);
  - chunked dispatch (``chunk_blocks`` > 1, coefficient engines): N blocks
    are gathered, uploaded in one transfer, stepped by one chunk step
    (engine/fmajor.py:make_chunk_step) and fetched in one transfer; MIDI,
    bank swaps and the step choice apply at chunk boundaries, and
    ``pipeline_depth`` then counts chunks;
  - per-block wall timing with warmup discard (reference _nruns = -10,
    src/conv.h:80), p50/p99, RTF and a missed-deadline count, with an
    ``on_missed_deadline(block, seconds)`` hook;
  - real-time pacing by ``time.sleep`` or by the C++ absolute-deadline
    clock (``clock="native"``, runtime/native.py), and ``stop()`` from any
    thread, honoured at the next block boundary (the reference parks its
    main thread on stdin and quits on Enter, src/main.cu:95);
  - scripted MIDI events, then live ones (``live_midi.poll()``, e.g. a
    runtime/midi_transport.py FIFO reader), are applied between blocks
    through the ControlPlane (reference's per-device MIDI thread,
    src/midi.cu:22-59);
  - periodic checkpoints (runtime/checkpoint.py) for crash recovery
    (runtime/recovery.py): every ``checkpoint_every`` blocks the pending
    deliveries are drained, ``control.pre_checkpoint_hooks`` run, and the
    state is copied to the host and written, inside that block's timed
    span (a save stalls the loop, and its block is timed with it);
  - coefficient-engine management driven by HOST mirrors, never by device
    reads (the hot path does not sync): an analytic coef_a mirror selects
    the steady step once every crossfade has decayed; while one is live,
    the indexed (span) step where every fading voice's snapshot is in the
    bank's span ('allk'), else the general step over the materialized
    snapshot; a re-select runs collapse_pure or the materializing collapse
    to match;
  - live bank swaps (swap_bank) between blocks: in-flight fade snapshots
    are materialized against the OLD bank first, so fade tails keep its
    sound, and the 'selected' strategy's per-voice spectra are re-gathered
    from the new one; a span-only engine (fmajor with swap_snapshot=False,
    the cascade) defers the swap until its fades decay.

Each engine names its fade protocol in ``engine.fade_protocol``:

  - "spans": the steady, span-indexed and general coefficient steps, and
    the span re-base collapse_pure at a re-select (fmajor 'allk'; the
    cascade, which takes the post-change parameters at collapse_pure);
  - "selected": the steady and general steps, and the materializing
    collapse, which also re-gathers the per-voice spectra (fmajor
    'selected');
  - "coef": the steady and general steps and the materializing collapse
    (the partitioned engine's 'coef' variant);
  - "slew": ``engine.step``, which slews the active spectra itself and
    needs no collapse (the monolithic engine, partitioned 'materialized').

Mesh serving (``mesh=``, a parallel/mesh.py Mesh): the session drives the
engine's ShardedEngine, which splits voices over the mesh's voice axis and,
in fmajor roll mode and the partitioned engine, partitions over its part
axis. The bank and the state are placed at the start of run() (a restored
single-device state included), each block is uploaded once into pinned
host memory and copied to each voice row's device as its voice slice, each
row's output is copied into its slice of one pinned host buffer behind an
event on that row's device, and a checkpoint gathers the state first
(runtime/checkpoint.py), so the file has the single-device format. Step
choice stays on the host mirrors; bank swaps and the working set's slot
writes reach every replica. Per-block dispatch only (``chunk_blocks`` must
be 1), and coefficient engines only, as in the JAX package.

Batched fetches (``fetch_batch`` > 1): dispatch stays per block (MIDI,
parameters and the step choice keep block granularity), but each output is
copied into slot i of a device batch tensor [N, V, 2, B] as it comes, and
the batch leaves the device in one copy into pinned host memory behind one
event (on a mesh, one batch and one copy per voice row). With
``wire="pcm16"`` the batch is encoded to 16-bit PCM on the device first
(utils/wire.py: half the bytes) and decoded on the host. ``pipeline_depth``
then counts batches; a partial batch is flushed before every checkpoint,
at the source's end, at an underrun stop and at stop(). Pace is recorded
per batch at delivery: the wall time between two deliveries over the
batch's blocks, the missed-deadline hook fired from there.

Spans (``spans=``, a utils/profiling.py Spans; None records nothing): the
loop opens a span at each of its layer boundaries, all inside one
``block`` span per iteration whose id is the iteration's first block
index: ``gather`` (the source's reads), ``control`` (the scripted and
live MIDI messages applied to the control plane, only on a block where
one is due), ``bank_swap`` and ``select`` (only when a swap or a
re-select runs), ``step_choice``, ``params`` (the
control plane's device snapshot), ``upload``, ``step.<kind>`` (the
engine's step call alone, kind ``steady``, ``indexed``, ``general``,
``chunk`` or ``slew``), ``fetch`` (the device-to-host copy queued, or the
output added to the open batch), ``end_block``, ``fetch_wait`` (the wait
for a queued copy) and ``sink`` (the sink's writes, the pcm16 decode),
both with the id of the block they deliver, ``checkpoint`` (a save) and
``clock_wait`` (realtime pacing). Deliveries drained after the last
block have no enclosing span. The session's counters, always kept, are
in ``summary()["counters"]``, with the engine's steady-step graph counters
(``steady_captures``, ``steady_replays``, ``steady_eager``:
engine/fmajor.py) counted over the session's runs. Of the crossfades:
``selects`` (re-selected channels the session collapsed),
``fades_interrupted`` (those of them whose fade was still live, coef_a at
or above STEADY_THRESHOLD on the host mirror) and
``fading_channel_blocks`` (per block, the channels whose fade is live,
summed over the blocks).

BlockTimer's interval per block starts after the MIDI dispatch: the
source's read, the ``control`` span's work and the realtime wait are
outside it, so the summary's per-block times (p50, p99, RTF, missed
deadlines) leave the dispatch out; the ``control`` span times it.

Left out of this port, by design: the JAX session's layout pinning.

Where chunked dispatch differs from the JAX session's: a partial chunk
(the source's end, or ``max_blocks``) renders only its valid blocks (JAX
also scans the zero pad, so its state runs on past the last delivered
block), and ``indexed_blocks`` / ``general_blocks`` count blocks (JAX
counts one per chunk).
"""

from __future__ import annotations

import collections
import time
from dataclasses import replace

import numpy as np
import torch

from tpu_audio_torch.engine.params import ControlPlane
from tpu_audio_torch.runtime import native
from tpu_audio_torch.runtime.backends import BlockSink, BlockSource
from tpu_audio_torch.runtime.checkpoint import save_checkpoint
from tpu_audio_torch.utils.log import Log
from tpu_audio_torch.utils.profiling import BlockTimer, Spans
from tpu_audio_torch.utils.wire import decode_pcm16, encode_pcm16

STEADY_THRESHOLD = 1e-6  # coef_a below this ≈ crossfade fully decayed
# the fmajor engine's steady-step graph counters, reported as the session's
GRAPH_COUNTERS = ("steady_captures", "steady_replays", "steady_eager")


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

    def rewind_to(self, block_index: int) -> None:
        """Reposition so events at blocks >= block_index replay: crash
        recovery (runtime/recovery.py; events before the checkpoint are
        baked into the restored control plane, later ones must fire again)
        and the offline bounce (which replays a schedule from block 0 on
        the host)."""
        self._next = 0
        while (self._next < len(self._events)
               and self._events[self._next][0] < block_index):
            self._next += 1


def engine_steps(engine):
    """(steady step, general step) of an engine by its fade protocol: a
    coefficient engine's step_coef_steady and step_coef, or engine.step
    for both where the engine slews its own spectra."""
    if engine.fade_protocol == "slew":
        return engine.step, engine.step
    return engine.step_coef_steady, engine.step_coef


class StreamSession:
    """Drives (source -> engine step -> sink) to completion."""

    def __init__(self, engine, bank, control: ControlPlane,
                 source: BlockSource, sink: BlockSink,
                 sample_rate: int = 44100, warmup: int = 10,
                 realtime: bool = False,
                 pipeline_depth: int = 1, underrun_policy: str = "stop",
                 max_consecutive_underruns: int | None = None,
                 on_missed_deadline=None, clock: str = "sleep",
                 chunk_blocks: int = 1, fetch_batch: int = 1,
                 wire: str = "f32", mesh=None, spans: Spans | None = None):
        self.engine = engine
        self.spans = spans
        self.bank = bank
        self.device = engine.device
        # mesh: serve over a parallel/mesh.py Mesh through this session's
        # ShardedEngine (`_eng`, the engine itself without one). run()
        # places the bank and the state at its start and gathers the bank
        # back onto the engine's device at its end; on_bank_placed(bank)
        # hands each of the two to the bank's owner (the working set,
        # whose slot writes must reach every replica during the run)
        self.mesh = mesh
        self._eng = engine
        self.on_bank_placed = None
        if mesh is not None:
            if chunk_blocks > 1:
                raise ValueError("mesh serving uses per-block dispatch "
                                 "(chunk_blocks must be 1)")
            if engine.fade_protocol == "slew":
                raise ValueError("mesh serving supports coef-interface "
                                 "engines (fmajor, cascade, "
                                 "partitioned-coef)")
            from tpu_audio_torch.parallel.mesh import ShardedEngine

            self._eng = ShardedEngine(engine, mesh)
            self.device = self._eng.device
        self.control = control
        self.source = source
        self.sink = sink
        self.sample_rate = sample_rate
        self.realtime = realtime
        # realtime pacing: "sleep" = perf_counter + time.sleep; "native" =
        # the C++ absolute-deadline clock (clock_nanosleep, drift-free,
        # re-anchors after late blocks — riding the period clock the way
        # the reference rides the JACK server's); without the native
        # library the session warns and sleeps. clock_used says which one
        # paced the last realtime run, clock_ticks / clock_missed are the
        # native clock's counts
        if clock not in ("sleep", "native"):
            raise ValueError(f"unknown clock {clock!r}")
        self.clock = clock
        self.clock_used = None
        self.clock_ticks = self.clock_missed = 0
        # how many blocks (chunks) may be in flight between dispatch and
        # sink delivery: 1 = classic double buffering
        self.pipeline_depth = max(1, pipeline_depth)
        # chunk_blocks > 1: one upload, one chunk step and one fetch per N
        # blocks; MIDI and parameter changes apply at chunk granularity
        self.chunk_blocks = max(1, chunk_blocks)
        if self.chunk_blocks > 1 and engine.fade_protocol == "slew":
            raise ValueError(
                f"chunk_blocks={chunk_blocks}: {type(engine).__name__} "
                f"slews its own spectra (fade protocol 'slew') and has no "
                f"chunk step; serve it per block")
        # fetch_batch > 1: per-block dispatch, but every N outputs leave
        # the device in one copy (N blocks more delivery latency);
        # pipeline_depth then counts batches
        self.fetch_batch = max(1, fetch_batch)
        if self.fetch_batch > 1 and self.chunk_blocks > 1:
            raise ValueError("fetch_batch and chunk_blocks are exclusive")
        # wire="pcm16" (batched only): the batch is encoded to 16-bit PCM on
        # the device before its copy, half the bytes (utils/wire.py)
        if wire not in ("f32", "pcm16"):
            raise ValueError(f"unknown wire format {wire!r}")
        if wire != "f32" and self.fetch_batch == 1:
            raise ValueError("wire='pcm16' requires fetch_batch > 1 "
                             "(per-block delivery always transfers f32)")
        self.wire = wire
        # the open batch: one device tensor [N, ...] per voice row, and how
        # many of its slots are filled
        self._batch: list | None = None
        self._batch_n = 0
        self._batch_id = 0
        self._batch_tprev = None
        # device-to-host copies and their bytes, host-to-device bytes of the
        # blocks' inputs, over every run
        self.fetch_copies = 0
        self.fetch_bytes = 0
        self.upload_bytes = 0
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
        # the first chunk absorbs the kernels' builds and the FFT plans and
        # records chunk_blocks per-block times: discard two whole chunks
        if self.chunk_blocks > 1:
            warmup = max(warmup, 2 * self.chunk_blocks)
        self.timer = BlockTimer(warmup=warmup, deadline_s=self.block_period)
        self.on_missed_deadline = on_missed_deadline
        self._missed_logged = 0
        # cooperative stop for unbounded live sessions, set from any thread
        self._stop_requested = False
        # one record per checkpoint written: block_index, d2h_s, write_s,
        # bytes (runtime/checkpoint.py) and block_s, the wall time of the
        # block (the chunk, in chunked mode) that wrote it, the save
        # included
        self.checkpoint_saves: list[dict] = []
        self.blocks_streamed = 0
        # blocks (not chunks) that rode step_coef_indexed / the general
        # fade step
        self.indexed_blocks = 0
        self.general_blocks = 0
        # re-selects served by collapse_pure / by the materializing collapse
        self.collapses_pure = 0
        self.collapses_full = 0
        # re-selected channels collapsed, those of them that interrupted a
        # live fade, and the live fades' channel-blocks
        self.selects = 0
        self.fades_interrupted = 0
        self.fading_channel_blocks = 0
        # the engine's GRAPH_COUNTERS over this session's runs
        self.graph_counts = dict.fromkeys(GRAPH_COUNTERS, 0)

        # coefficient engines pick a step from the host mirrors and collapse
        # on a re-select; "slew" engines only call engine.step
        protocol = engine.fade_protocol
        span_fades = protocol == "spans"
        self._is_coef = protocol != "slew"
        if self.chunk_blocks > 1:
            from tpu_audio_torch.engine.fmajor import make_chunk_step

            self._step_steady = make_chunk_step(engine, steady=True)
            self._step_full = make_chunk_step(engine)
            self._step_indexed = (make_chunk_step(engine, indexed=True)
                                  if span_fades else None)
        else:
            self._step_steady, self._step_full = engine_steps(self._eng)
            self._step_indexed = (self._eng.step_coef_indexed if span_fades
                                  else None)
        self._collapse_pure = (self._eng.collapse_pure if span_fades
                               else None)
        # 'selected' re-gathers its per-voice spectra at a collapse (it
        # takes the new selection) and at a bank swap
        self._selected = protocol == "selected"
        # the cascade rescales in-flight tail content at a re-select, which
        # needs the post-change parameters (the new fade's vsteps, predelay)
        self._collapse_pure_params = (span_fades
                                      and engine.collapse_pure_takes_params)
        # span-only engines (swap_snapshot=False) have no materialized
        # snapshot: a bank swap waits for the fades to decay
        self._span_only = span_fades and not engine.swap_snapshot
        # the state carries span provenance (base_pure)
        self._has_provenance = span_fades or self._selected
        # analytic host mirror of coef_a for the step choice, and of span
        # purity (base_pure) for the indexed-step precondition
        self._a_host = np.zeros((engine.num_voices, 2), np.float64)
        self._pure_host = np.ones((engine.num_voices, 2), bool)
        self._pending_old: dict[tuple[int, int], int] = {}
        self._pending_bank = None
        self._swap_wait_logged = False
        self._swap_deferred_blocks = 0
        # fired once per run(), before the first block: the seam for
        # warm-up work (the working set builds its fault path's FFT plan
        # there, models/reverb.py:session)
        self.pre_run_hooks: list = []
        if self._is_coef:
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
        if self.spans is None:
            return self._collapse(state)
        return self.spans.call("select", self._collapse, state)

    def _collapse(self, state):
        """Re-base the fades of the voices re-selected since the last
        step."""
        # collapse_pure (a [V,2,K]-sized span update — the re-select block
        # then costs the same as a steady block) is valid iff the pre-state
        # was indexed-valid: every changed voice is then either pure (the
        # affine re-base stays in the span EXACTLY, interrupted fades
        # included) or converged (its stale span restarts at c*onehot).
        # Only a bank swap mid-fade breaks purity and routes re-selects
        # through the materializing collapse below.
        use_pure = self._step_indexed is not None and self._indexed_valid()
        new_sel = self.control.select.copy()
        old_sel = new_sel.copy()
        changed = np.zeros_like(old_sel, dtype=bool)
        for (v, ch), old in self._pending_old.items():
            old_sel[v, ch] = old
            changed[v, ch] = True
            self.fades_interrupted += bool(self._a_host[v, ch]
                                           >= STEADY_THRESHOLD)
            self._a_host[v, ch] = 1.0
            self._pure_host[v, ch] = use_pure
        self.selects += len(self._pending_old)
        self._pending_old.clear()
        old_t = torch.tensor(old_sel, device=self.device)
        changed_t = torch.tensor(changed, device=self.device)
        if use_pure:
            self.collapses_pure += 1
            if self._collapse_pure_params:
                return self._collapse_pure(state, old_t, changed_t,
                                           self.control.snapshot_device())
            return self._collapse_pure(state, old_t, changed_t)
        # materializing collapse: every voice's base becomes a valid tensor
        # (virtual snapshots are materialized too), so the general fade
        # step may read state.base for anyone afterwards
        self._pure_host[:] = False
        self.collapses_full += 1
        new_t = (torch.tensor(new_sel, device=self.device)
                 if self._selected else None)
        # the post-change parameters: the 'selected' cascade's in-flight
        # tail rescale reads them, the other engines take and ignore them
        return self._eng.collapse(state, self.bank, old_t, changed_t,
                                  new_select=new_t,
                                  params=self.control.snapshot_device())

    def _pick_coef_step(self, blocks: int = 1):
        """The coefficient engine's step for the next `blocks` blocks (one
        chunk): steady once every fade has decayed, else the indexed or
        general fade step. Then the analytic coef_a mirror advanced exactly
        as the device recursion advances it, with the chunk's in-step
        vsteps countdown (make_chunk_step), and the live fades' channels
        counted per block while any is live."""
        vsteps = self.control.vsteps.astype(np.float64)
        fading = int(np.count_nonzero(self._a_host >= STEADY_THRESHOLD))
        if not fading:
            step = self._step_steady
        elif self._step_indexed is not None and self._indexed_valid():
            step = self._step_indexed
            self.indexed_blocks += blocks
        else:
            step = self._step_full
            self.general_blocks += blocks
        for i in range(blocks):
            if i and fading:
                fading = int(np.count_nonzero(
                    self._a_host >= STEADY_THRESHOLD))
            self.fading_channel_blocks += fading
            self._a_host *= 1.0 - 1.0 / (vsteps + 5.0)
            vsteps = np.maximum(vsteps - 1.0, 0.0)
        return step

    def _step_span(self, step) -> str:
        """The span name of a per-block step the session picked."""
        if not self._is_coef:
            return "step.slew"
        if step is self._step_steady:
            return "step.steady"
        if step is self._step_indexed:
            return "step.indexed"
        return "step.general"

    def _leaf(self, state, name: str) -> torch.Tensor:
        """One field of the state; on a mesh, joined over the shards (a
        gather onto the mesh's first device)."""
        return (getattr(state, name) if self.mesh is None
                else state.leaf(name))

    def _materialize_base(self, state):
        """Materialize virtual fade snapshots with NO re-select (bank-swap
        and run-start paths)."""
        state = self._eng.materialize_base(state, self.bank)
        self._pure_host[:] = False
        return state

    # -- live bank swap ------------------------------------------------------------------

    def swap_bank(self, bank) -> None:
        """Live IR-bank replacement (the reference's `prepare` reload path,
        src/conv.cu:206-253, made safe): `bank` (the engine's bank type, of the same
        geometry, on the session's device) is applied between blocks, or at
        the next run start. Before switching, any VIRTUAL fade snapshot is
        materialized against the OLD bank, and the 'selected' strategy's
        per-voice spectra are re-gathered from the new bank — so fade tails
        keep the old sound and the steady path plays the new bank from the
        swap block on."""
        self._pending_bank = bank

    def _apply_pending_bank(self, state):
        if self._pending_bank is None:
            return state
        if self._span_only and bool((self._a_host
                                     >= STEADY_THRESHOLD).any()):
            # span-only engine (swap_snapshot=False): there is nothing to
            # materialize the old bank's fade tails into, so the swap
            # waits for in-flight crossfades to decay — bounded by the
            # fade time ONLY while no new fades start. Continuous MIDI
            # select churn resets coef_a to 1.0 on every re-select and can
            # defer a live swap indefinitely (the swap needs one full fade
            # window of select silence); the periodic re-log keeps that
            # visible.
            self._swap_deferred_blocks += 1
            if not self._swap_wait_logged:
                self._swap_wait_logged = True
                Log.info("stream", "bank swap deferred until in-flight "
                         "crossfades decay (span-only engine)")
            elif self._swap_deferred_blocks % 500 == 0:
                Log.warn("stream", "bank swap still deferred after %d "
                         "blocks — continuous re-selects keep fades in "
                         "flight; pause select events for one fade window "
                         "to let the swap through",
                         self._swap_deferred_blocks)
            return state
        if self.spans is None:
            return self._swap_pending_bank(state)
        return self.spans.call("bank_swap", self._swap_pending_bank, state)

    def _swap_pending_bank(self, state):
        self._swap_deferred_blocks = 0
        self._swap_wait_logged = False
        new_bank = self._pending_bank
        self._pending_bank = None
        if self.mesh is not None:
            new_bank = self._eng.place_bank(new_bank)
        # (the "coef" and "slew" engines keep their fade snapshots
        # materialized, base or active, so their fade tails keep the old
        # bank's sound as they are)
        if self._span_only:
            # the deferral above guarantees every fade has decayed, so the
            # old-bank span coefficients are inert: zero them so no stale
            # provenance is reinterpreted against the new bank
            zero = torch.zeros_like(self._leaf(state, "base_g"))
            state = (state.with_leaves(base_g=zero)
                     if self.mesh is not None
                     else replace(state, base_g=zero))
        elif (self._has_provenance
              and bool(self._leaf(state, "base_pure").any())):
            # materialize virtual snapshots against the OLD bank: the
            # fade-out tail must keep playing the old bank's sound
            state = self._materialize_base(state)
        if self._selected:
            # the steady MAC reads materialized per-voice spectra —
            # re-gather them from the NEW bank
            state = self._eng.regather_selection(
                state, new_bank, torch.tensor(self.control.select,
                                              device=self.device))
        self.bank = new_bank
        return state

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
        # a copy, never a view of the source's buffer (or, chunked, of the
        # gathered blocks): the state keeps the last block as prev_in. On
        # CUDA the copy goes through a fresh pinned buffer so the
        # host->device transfer is queued, not waited for; on a mesh the
        # pinned buffer itself is returned and the sharded step copies
        # each voice row's slice to the row's device.
        if self.device.type != "cuda":
            t = torch.tensor(x, device=self.device)
            self.upload_bytes += t.nbytes
            return t
        pinned = torch.from_numpy(np.asarray(x, np.float32)).pin_memory()
        self.upload_bytes += pinned.nbytes
        if self.mesh is not None:
            return pinned
        return pinned.to(self.device, non_blocking=True)

    def _start_fetch(self, out, n_valid: int | None, block_id: int):
        """Queue the device->host copy of one output block, or of one
        chunk's [T, V, 2, B] outputs of which the first `n_valid` are
        delivered, or of a mesh step's VoiceShards (each row into its
        slice of one host buffer); returns what _deliver needs: the host
        tensor, the events to wait for, n_valid and the id of the (first)
        block."""
        parts = out if isinstance(out, list) else [out]
        if parts[0].device.type != "cuda":
            host = torch.cat(parts) if len(parts) > 1 else parts[0]
            return host, (), n_valid, block_id
        rows = sum(t.shape[0] for t in parts)
        host = torch.empty((rows,) + tuple(parts[0].shape[1:]),
                           dtype=parts[0].dtype, pin_memory=True)
        done, v0 = [], 0
        for t in parts:
            host[v0:v0 + t.shape[0]].copy_(t, non_blocking=True)
            v0 += t.shape[0]
            done.append(self._copied(t))
        return host, done, n_valid, block_id

    def _copied(self, t: torch.Tensor) -> torch.cuda.Event:
        """Count one device-to-host copy of `t`, just queued, and return an
        event recorded after it on the stream of the device that holds
        `t`."""
        self.fetch_copies += 1
        self.fetch_bytes += t.numel() * t.element_size()
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return event

    def _batch_add(self, out, block_id: int) -> bool:
        """Copy one block's output (each voice row's, on a mesh) into the
        next slot of the open batch on its device, so that a step output
        the next step reuses cannot reach the batch changed. True when
        the batch is full."""
        parts = out if isinstance(out, list) else [out]
        if self._batch is None:
            self._batch = [torch.empty((self.fetch_batch,) + tuple(t.shape),
                                       dtype=t.dtype, device=t.device)
                           for t in parts]
            self._batch_n = 0
            self._batch_id = block_id
        for buf, t in zip(self._batch, parts):
            buf[self._batch_n].copy_(t)
        self._batch_n += 1
        return self._batch_n == self.fetch_batch

    def _flush_batch(self, pending) -> None:
        """Queue the device-to-host copy of the open batch's filled slots
        (a partial batch included): per voice row, the [n, V_row, 2, B]
        slots, encoded to int16 on the device on the pcm16 wire, in one
        copy into pinned memory behind one event."""
        if self._batch is None:
            return
        bufs, n = self._batch, self._batch_n
        self._batch = None
        hosts, done = [], []
        for buf in bufs:
            t = buf[:n]
            if self.wire == "pcm16":
                t = encode_pcm16(t)
            if t.device.type != "cuda":
                hosts.append(t)
                continue
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            done.append(self._copied(t))
            hosts.append(host)
        pending.append((hosts, done, n, self._batch_id))

    def _deliver(self, host, done, n_valid: int | None,
                 block_id: int) -> None:
        """Wait for a queued copy and hand its blocks to the sink."""
        sp = self.spans
        batch = isinstance(host, list)
        if sp is not None:
            sp.open("fetch_wait", block_id)
        for event in done:
            event.synchronize()
        if sp is not None:
            sp.close()
            sp.open("sink", block_id)
        if batch:
            self._deliver_batch(host, n_valid)
        elif n_valid is None:
            self.sink.write(host.numpy())
        else:
            for block in host[:n_valid].numpy():   # a partial chunk's pad
                self.sink.write(block)             # is trimmed here
        if sp is not None:
            sp.close()
        if batch:
            self._batch_pace(n_valid)

    def _deliver_batch(self, hosts: list, n: int) -> None:
        """Write a fetched batch's n blocks to the sink: the voice rows'
        parts joined, the pcm16 wire decoded."""
        arr = (hosts[0].numpy() if len(hosts) == 1
               else np.concatenate([h.numpy() for h in hosts], axis=1))
        if arr.dtype == np.int16:
            arr = decode_pcm16(arr)
        for block in arr:
            self.sink.write(block)

    def _batch_pace(self, n: int) -> None:
        """Record a delivered batch's pace: the wall time since the
        previous batch's delivery over its n blocks, once per block, and
        fire the missed-deadline hook from here (the loop's own timing
        never sees a batch)."""
        now = time.perf_counter()
        if self._batch_tprev is not None:
            per_block = (now - self._batch_tprev) / n
            for _ in range(n):
                self.timer.record(per_block)
            if (per_block > self.block_period
                    and self.timer.missed > self._missed_logged):
                self._missed_logged = self.timer.missed
                if self.on_missed_deadline is not None:
                    self.on_missed_deadline(self.timer.count, per_block)
                else:
                    Log.debug("stream", "missed deadline near block %d: "
                              "%.2f ms", self.timer.count, per_block * 1e3)
        self._batch_tprev = now

    def _gather(self, want: int) -> tuple[list, bool]:
        """Read up to `want` blocks from the source under the underrun
        policy. Returns (blocks, dry): `dry` when the source ended (or the
        underrun cap stopped it) before `want` blocks came."""
        blocks = []
        while len(blocks) < want:
            x = self.source.read()
            if x is None:
                if self.underrun_policy == "stop" or self._underrun_stop():
                    return blocks, True
                x = np.zeros((self.engine.num_voices, 2, self.engine.block),
                             np.float32)
            else:
                self._consecutive_underruns = 0
            blocks.append(x)
        return blocks, False

    # -- main loop ---------------------------------------------------------------------

    def stop(self) -> None:
        """Request a clean end of run() at the next block boundary —
        callable from another thread (e.g. a stdin watcher, the
        reference's cin.get() park at src/main.cu:95)."""
        self._stop_requested = True

    def warm_up(self, state) -> float:
        """Step one block (one chunk) of silence through each of the
        session's steps on `state`, which it consumes, and wait for the
        outputs on the host. Nothing reaches the sink and the control plane
        does not move. A process's first step loads the kernels and plans
        the FFTs (chip_smoke.py phase 22 prints what that costs the CLI's
        one-voice model); a live session warmed up before its producer
        starts renders the first block it is given in time, and leaves no
        backlog of blocks behind that one. Returns the seconds it took."""
        if self.mesh is not None:
            raise ValueError("warm_up runs on one device (mesh=None)")
        t0 = time.perf_counter()
        x = np.zeros((self.chunk_blocks, self.engine.num_voices, 2,
                      self.engine.block), np.float32)
        params = self.control.snapshot_device()
        steps = ((self._step_steady, self._step_indexed, self._step_full)
                 if self._is_coef else (self._step_full,))
        for step in steps:
            if step is None:
                continue
            if self.chunk_blocks == 1:
                state, out = step(state, self.bank, params,
                                  self._upload(x[0]))
            else:
                state, out = step(state, self.bank, params, self._upload(x),
                                  self.chunk_blocks)
            _, done, _, _ = self._start_fetch(out, None, 0)
            for event in done:
                event.synchronize()
        return time.perf_counter() - t0

    def _open_clock(self):
        """The native clock for a realtime run with clock="native", when
        the native library builds, ticking once per chunk; None means
        time.sleep pacing."""
        if not self.realtime:
            return None
        if self.clock == "native":
            if native.native_available():
                self.clock_used = "native"
                return native.NativeBlockClock(self.chunk_blocks
                                               * self.block_period)
            Log.warn("stream", "native clock unavailable; using sleep")
        self.clock_used = "sleep"
        return None

    def _dispatch(self, messages) -> None:
        """Apply a block's due MIDI messages, scripted then live, in
        order."""
        for device, message in messages:
            self.control.apply_midi_message(message, device)

    def _save(self, path, state, block_index: int) -> None:
        figures = save_checkpoint(path, state, self.control,
                                  meta={"block_index": block_index})
        self.checkpoint_saves.append({"block_index": block_index, **figures})

    def run(self, state, max_blocks: int | None = None,
            midi: MidiSchedule | None = None, live_midi=None,
            checkpoint_path=None, checkpoint_every: int | None = None,
            start_block: int = 0):
        """Stream until the source ends, max_blocks, or stop(). Returns the
        final state.

        live_midi: anything with poll() -> [(device, message)], polled
        once per block (chunk) after the scripted `midi` events.
        checkpoint_path + checkpoint_every: persist the full engine state
        and control plane every `checkpoint_every` blocks (in chunked mode
        at the first chunk end that crosses a multiple) so a failed session
        can be rebuilt and resumed (runtime/recovery.py). Each save copies
        the state to the host synchronously — size the interval
        accordingly. start_block offsets the block indices of the MIDI
        schedule and of the checkpoints (resume bookkeeping).

        The fmajor engine and the cascade update the state's delay line and
        wet ring in place: the state passed in is consumed.

        On a mesh the bank and the state (a fresh init, a restored
        checkpoint or a previous run's result) are placed over it first,
        and the run returns the sharded state; the bank goes back onto the
        engine's device when the run ends, the way it ends included. A
        session without a mesh gathers a sharded state first."""
        args = (max_blocks, midi, live_midi, checkpoint_path,
                checkpoint_every, start_block)
        if self.mesh is None:
            if hasattr(state, "gather"):    # a mesh session's result
                state = state.gather(self.device)
            return self._run(state, *args)
        # the owner takes the placed bank before the pre-run hooks, which
        # may write a slot of it
        self._hand_over(self._eng.place_bank(self.bank))
        try:
            return self._run(self._eng.place_state(state), *args)
        finally:
            self._hand_over(self.bank.gather(self.engine.device))

    def _hand_over(self, bank) -> None:
        self.bank = bank
        if self.on_bank_placed is not None:
            self.on_bank_placed(bank)

    def _run(self, state, max_blocks, midi, live_midi, checkpoint_path,
             checkpoint_every, start_block):
        for hook in self.pre_run_hooks:
            hook()
        # resync the analytic mirrors from the state (one host read, before
        # the loop) so a session started mid-crossfade — a checkpoint
        # restored mid-fade included — keeps the fade step; snapshot
        # provenance is state-carried, so purity survives too
        if self._is_coef:
            self._a_host = self._leaf(state, "coef_a").double().cpu().numpy()
        if self._has_provenance:
            self._pure_host = (self._leaf(state, "base_pure").cpu().numpy()
                               .copy())
            if (self._step_indexed is None
                    and bool((self._pure_host
                              & (self._a_host >= STEADY_THRESHOLD)).any())):
                # a span-collapsed fade is in flight but this session has
                # no indexed step ('selected'): materialize the virtual
                # snapshots once so the general fade reads a valid base
                state = self._materialize_base(state)
        else:
            self._pure_host[:] = False

        chunk = self.chunk_blocks
        batched = self.fetch_batch > 1
        sp = self.spans
        counts_before = self._engine_graph_counts()
        pending = collections.deque()
        self._batch = None
        self._batch_tprev = None
        block_index = 0
        next_deadline = time.perf_counter() + chunk * self.block_period
        native_clock = self._open_clock()
        try:
            while max_blocks is None or block_index < max_blocks:
                if self._stop_requested:
                    # consume the request (a stop may arrive before the
                    # loop even starts)
                    self._stop_requested = False
                    break
                # a chunk never reaches past max_blocks: its gather stops
                # there, and a partial chunk renders its valid blocks only
                want = chunk if max_blocks is None else min(
                    chunk, max_blocks - block_index)
                block_id = start_block + block_index
                if sp is None:
                    xs, dry = self._gather(want)
                else:
                    sp.open("block", block_id)
                    xs, dry = sp.call("gather", self._gather, want)
                if not xs:
                    if sp is not None:
                        sp.close()
                    break
                n_valid = len(xs)

                due = midi.pop_due(block_id) if midi is not None else []
                if live_midi is not None:
                    due += live_midi.poll()
                if due:
                    if sp is None:
                        self._dispatch(due)
                    else:
                        sp.call("control", self._dispatch, due)

                # the block's timed work starts here: the source's read
                # and the realtime wait stay out of BlockTimer
                t0 = time.perf_counter()
                state = self._apply_pending_bank(state)
                if self._is_coef:
                    state = self._maybe_collapse(state)
                    step = (self._pick_coef_step(n_valid) if sp is None
                            else sp.call("step_choice", self._pick_coef_step,
                                         n_valid))
                else:
                    step = self._step_full

                params = (self.control.snapshot_device() if sp is None
                          else sp.call("params", self.control.snapshot_device))
                if chunk == 1:
                    if sp is None:
                        state, out = step(state, self.bank, params,
                                          self._upload(xs[0]))
                    else:
                        # the upload runs before the step, in its own span
                        x = sp.call("upload", self._upload, xs[0])
                        state, out = sp.call(self._step_span(step), step,
                                             state, self.bank, params, x)
                        sp.open("fetch")   # closed once the fetch is queued
                    if not batched:
                        pending.append(self._start_fetch(out, None, block_id))
                    elif self._batch_add(out, block_id):
                        self._flush_batch(pending)
                    if sp is not None:
                        sp.close()
                else:
                    # zero-pad a partial chunk to the fixed [T, V, 2, B]
                    # upload; its pad is not rendered
                    xs += [np.zeros_like(xs[0])] * (chunk - n_valid)
                    if sp is None:
                        state, outs = step(state, self.bank, params,
                                           self._upload(np.stack(xs)),
                                           n_valid)
                        pending.append(self._start_fetch(outs, n_valid,
                                                         block_id))
                    else:
                        x = sp.call("upload", self._upload, np.stack(xs))
                        state, outs = sp.call("step.chunk", step, state,
                                              self.bank, params, x, n_valid)
                        pending.append(sp.call("fetch", self._start_fetch,
                                               outs, n_valid, block_id))
                if sp is None:
                    self.control.end_block(n_valid)
                else:
                    sp.call("end_block", self.control.end_block, n_valid)

                # pipelined delivery: this block's (chunk's, batch's)
                # device->host copy is queued; deliver the one from
                # `pipeline_depth` fetches ago
                if len(pending) >= self.pipeline_depth + 1:
                    self._deliver(*pending.popleft())

                end = block_index + n_valid
                saved = (checkpoint_path is not None and checkpoint_every
                         and end % checkpoint_every < n_valid)
                if saved:
                    # drain in-flight deliveries FIRST: a checkpoint must
                    # never get ahead of the sink, or a crash between save
                    # and delivery would lose the undelivered blocks
                    self._flush_batch(pending)
                    while pending:
                        self._deliver(*pending.popleft())
                    # let subsystems publish in-flight host-side work (the
                    # async working set's uploads and deferred selects)
                    for hook in self.control.pre_checkpoint_hooks:
                        hook()
                    if sp is None:
                        self._save(checkpoint_path, state, start_block + end)
                    else:
                        sp.call("checkpoint", self._save, checkpoint_path,
                                state, start_block + end)

                if batched:
                    # recorded per batch at its delivery
                    elapsed = 0.0
                else:
                    # a chunk's wall time is recorded as its per-block
                    # equivalent once per valid block
                    elapsed = (time.perf_counter() - t0) / n_valid
                    for _ in range(n_valid):
                        self.timer.record(elapsed)
                if saved:
                    self.checkpoint_saves[-1]["block_s"] = (
                        time.perf_counter() - t0 if batched
                        else elapsed * n_valid)
                if (elapsed > self.block_period
                        and self.timer.missed > self._missed_logged):
                    self._missed_logged = self.timer.missed
                    if self.on_missed_deadline is not None:
                        self.on_missed_deadline(block_index, elapsed)
                    else:
                        Log.debug("stream", "missed deadline at block %d: "
                                  "%.2f ms", block_index, elapsed * 1e3)

                # a late block left the source's producer, which runs on
                # its own clock, ahead: take its waiting blocks at once
                behind = self.realtime and self.source.backlog() > 0
                if native_clock is not None:
                    if not behind:
                        if sp is None:
                            native_clock.wait()
                        else:
                            sp.call("clock_wait", native_clock.wait)
                elif self.realtime:
                    now = time.perf_counter()
                    if now < next_deadline and not behind:
                        if sp is None:
                            time.sleep(next_deadline - now)
                        else:
                            sp.call("clock_wait", time.sleep,
                                    next_deadline - now)
                    next_deadline += chunk * self.block_period
                if sp is not None:
                    sp.close()
                block_index = end
                if dry:
                    break   # the source ended (or the underrun cap) mid-chunk

            self._flush_batch(pending)
            while pending:
                self._deliver(*pending.popleft())
        finally:
            for name, n in self._engine_graph_counts().items():
                self.graph_counts[name] += n - counts_before[name]
            if sp is not None:
                sp.unwind()
            if native_clock is not None:
                self.clock_ticks = native_clock.ticks
                self.clock_missed = native_clock.missed
                native_clock.close()
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
        s["counters"] = {
            "upload_bytes": self.upload_bytes,
            "fetch_copies": self.fetch_copies,
            "fetch_bytes": self.fetch_bytes,
            "indexed_blocks": self.indexed_blocks,
            "general_blocks": self.general_blocks,
            "collapses_pure": self.collapses_pure,
            "collapses_full": self.collapses_full,
            "selects": self.selects,
            "fades_interrupted": self.fades_interrupted,
            "fading_channel_blocks": self.fading_channel_blocks,
            "underruns": self.underruns,
            "param_uploads": self.control.uploads,
            **self.graph_counts,
        }
        return s

    def _engine_graph_counts(self) -> dict:
        """The engine's GRAPH_COUNTERS now (0 for an engine without)."""
        return {n: getattr(self._eng, n, 0) for n in GRAPH_COUNTERS}
