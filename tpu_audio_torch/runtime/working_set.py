"""Working-set IR residency: serve a large bank at small-bank speed (port
of tpu_audio/runtime/working_set.py).

The all-K MAC's per-block cost scales with the number of RESIDENT IRs (its
rhs window is read every block), and past 16 IRs mac_strategy='auto'
sends a bank to the 'selected' strategy, whose per-voice gather and batched
MAC run every block. But voices rarely USE more than a handful of IRs at
once — selections draw from a menu. This module keeps only a small working
set resident on the device: the engine (fmajor or the cascade) runs the
all-K path (ring_mac) over
``capacity`` slots, the control plane's select events are remapped
full-index -> slot, and a bank miss uploads ONE time-domain IR and packs it
into a slot between blocks (``engine.update_bank_slot``: 1.41 MB up for a
4 s stereo IR at 44.1 kHz).

Eviction safety: a slot's contents participate in audio as long as any
voice selects it OR an in-flight crossfade's span (``base_g``) references
it. Slots are only reclaimed when (a) no voice currently selects them and
(b) they have not been touched for ``min_age_blocks`` PROCESSED blocks —
longer than any crossfade — so replaced slots are provably inert. The
clock is the control plane's block counter, NOT wall time: sessions run
slower or faster than real time, and fades decay in block time either way.
Slots never selected since startup are reclaimable immediately.

Exhaustion (every slot protected) is a WORKLOAD BURST, not necessarily a
configuration error: a CC sweep that selects new IRs faster than one per
fade window protects slots faster than they age out. The default policy
(``on_exhausted='defer'``) therefore parks the select as a host-side intent
— the voice keeps playing its current IR, exactly like an async-paging
deferral — and re-issues it between blocks once a slot frees; a serving
session never crashes on hot MIDI. ``'raise'`` restores the strict contract
(capacity must exceed concurrently sounding IRs plus fading tails).

The policy is the JAX package's, line for line: the same select sequence
gives the same residency, counters and control state. What differs is the
device side. Slots are written IN PLACE on the block loop's stream (the
JAX bank is rebuilt functionally), and the async pager packs on a CUDA
stream of its own:

  - the worker thread builds the incoming IR's packed tensors on its side
    stream (engine.pack_bank_slot), never touching the live bank, records
    an event, and waits for it on its own thread, the pinned upload buffer
    held until then;
  - poll(), on the block loop's thread, makes the compute stream wait on
    that event and writes the slot in place (engine.write_bank_slot), so
    the publish is ordered after every block already queued and before
    the block that first selects the IR.

The reference has no analogue (its GPU holds the whole bank).
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable

import numpy as np
import torch

from tpu_audio_torch.utils.log import Log


class WorkingSetExhausted(RuntimeError):
    """Every resident slot is selected, span-referenced, reserved, or
    inside its fade-protection window — no eviction victim exists."""


class WorkingSetBank:
    """Host-side residency manager for one engine's device bank.

    Parameters
    ----------
    engine: an fmajor 'allk' engine or the cascade (update_bank_slot,
        pack_bank_slot, write_bank_slot), built with ``num_irs ==
        capacity``. Either fault uploads the time-domain IR [O, L].
    control: the ControlPlane whose ``select_remap`` hook this installs.
        ``control.select`` then holds SLOT indices; CC scaling and
        per-channel bank windows keep operating on full-bank indices.
    slot_payload: full-bank index -> the time-domain IR [O, L].
    bank: the initial device bank (slots 0..capacity-1 = ``residents``).
    residents: full-bank indices initially resident, in slot order.
    min_age_blocks: minimum idle PROCESSED-block count before an
        ever-used slot may be reclaimed; must exceed the longest
        crossfade (CC-reachable maximum: speed 127 -> 1016 blocks).
    """

    def __init__(self, engine, control, slot_payload: Callable[[int], object],
                 bank, residents: list[int], min_age_blocks: int = 1100,
                 async_paging: bool = False, on_exhausted: str = "defer"):
        self.engine = engine
        self.control = control
        self.slot_payload = slot_payload
        self.bank = bank
        self.capacity = len(residents)
        self.full_size = int(np.max(control.select_base
                                    + control.select_span))
        self.min_age_blocks = min_age_blocks
        self.slot_to_full = list(residents)
        self.full_to_slot = {f: s for s, f in enumerate(residents)}
        self.last_used = [float("-inf")] * self.capacity  # never selected
        self.misses = 0
        self.hits = 0
        self.warmups = 0
        self.on_update: Callable[[object], None] | None = None
        # per-(voice, ch) fade-span tracking: every slot a voice's span
        # provenance (base_g) may still weight audibly, plus the block and
        # vsteps of the LAST re-select that touched it. After a re-select
        # the whole mixture decays with the NEW fade's coef_a trajectory,
        # so one (block, window) pair bounds every member's residual: the
        # span is inert once `now - block >= vsteps + DECAY_MARGIN` (after
        # vsteps hits 0, a shrinks by 4/5 per block — < 1e-6 in ~62
        # blocks).
        self.DECAY_MARGIN = 64
        self._span: dict[tuple[int, int], set[int]] = {}
        self._span_meta: dict[tuple[int, int], tuple[float, int]] = {}
        # -- asynchronous paging (opt-in) ------------------------------------
        # async_paging=True: a bank miss no longer stalls the block loop on
        # the upload and pack. The select is DEFERRED: the voice keeps
        # playing its current IR (the event only re-slews the wet gain
        # toward its unchanged target), a single worker thread packs the
        # incoming IR for a reserved victim slot on its own stream, and the
        # between-blocks poll (control.block_hooks) writes the slot and
        # re-issues the select — the crossfade starts, with the normal fade
        # semantics, on the first block the IR is actually resident. A
        # newer select for the same (voice, ch) supersedes a pending one.
        self.async_paging = bool(async_paging)
        self.deferred = 0            # deferred-select counter (tests/stats)
        self._reserved: set[int] = set()
        self._pending: "dict[int, dict]" = {}      # full_idx -> record
        self._pending_order: list = []
        self._deferred_target: dict[tuple[int, int], int] = {}
        self._queue = None
        self._worker = None
        # -- exhaustion policy -------------------------------------------------
        # 'defer' (default): a select that cannot find an eviction victim
        # parks as a host intent ((voice, ch) -> full index, insertion-
        # ordered) and is re-issued by poll() once a slot frees — the
        # async-paging semantics applied to capacity instead of upload
        # latency. 'raise' keeps the strict sizing contract.
        if on_exhausted not in ("defer", "raise"):
            raise ValueError(f"on_exhausted must be 'defer' or 'raise', "
                             f"got {on_exhausted!r}")
        self.on_exhausted = on_exhausted
        self.starved = 0             # exhaustion-deferral counter (stats)
        self._starved: dict[tuple[int, int], int] = {}
        if self.async_paging:
            self._queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._worker_loop, name="workset-pager", daemon=True)
            self._worker.start()
        if self.async_paging or self.on_exhausted == "defer":
            # the between-blocks poll publishes completed background
            # uploads (async mode) and retries starved selects once a
            # slot ages out of protection (defer policy); sync+raise
            # needs neither, so the hot loop pays no hook there
            control.block_hooks.append(self.poll)
            # a deferred select lives only in host memory until poll()
            # publishes it: a checkpoint writer fires these hooks first,
            # so drain() lands any in-flight upload and re-issues
            # applicable selects (starved intents that still have no
            # victim stay parked and are kept in aux['ws_starved'])
            control.pre_checkpoint_hooks.append(self.drain)
        control.select_remap = self._remap
        # residency is checkpointable state: without it a restored
        # `select` (slot indices) would address slots holding different
        # IRs in a fresh process; on restore, mismatched slots re-page
        control.on_aux_restored = self._restore_residency
        self._sync_aux()

    def _write_slot(self, slot: int, packed):
        """Write a packed slot into the bank in place: into every replica
        of a mesh-placed bank (a ShardedBank, which the serving session
        hands over at run start; virtual shards share one replica), else
        into the single-device bank. Returns the bank."""
        if hasattr(self.bank, "write_slot"):
            return self.bank.write_slot(self.engine, slot, packed)
        return self.engine.write_bank_slot(self.bank, slot, packed)

    def _update_slot(self, slot: int, ir):
        """Pack the time-domain IR on the engine's device and write it
        (engine.update_bank_slot, on every replica of a mesh-placed
        bank)."""
        return self._write_slot(slot, self.engine.pack_bank_slot(ir))

    def warmup(self) -> None:
        """Warm the fault path before serving starts: re-upload slot 0's
        currently resident IR — a no-op on bank contents — so the first
        real bank miss pays no one-off cost mid-stream (on CUDA, the cuFFT
        plan of the slot's partition transform). Sessions wire this onto
        their pre_run_hooks (models/reverb.py:session). A failure raises:
        a fault path that cannot page slot 0 in would fail at the first
        real miss, mid-stream, so the session does not start."""
        self.bank = self._update_slot(
            0, self.slot_payload(self.slot_to_full[0]))
        self.warmups += 1
        if self.on_update is not None:
            self.on_update(self.bank)

    def _sync_aux(self) -> None:
        self.control.aux["ws_slot_to_full"] = np.asarray(
            self.slot_to_full, np.int64)
        # starved intents are session state too: a checkpoint taken while
        # exhausted must re-issue them after restore, not drop the events
        self.control.aux["ws_starved"] = np.asarray(
            [[v, c, f] for (v, c), f in self._starved.items()],
            np.int64).reshape(-1, 3)

    def _restore_residency(self) -> None:
        """Rebuild device residency from a restored checkpoint: re-page
        every slot whose resident IR differs from the checkpointed map,
        then protect everything for one fade window (spans are unknown
        after a restore — conservative is correct)."""
        want = self.control.aux.get("ws_slot_to_full")
        if want is None:
            return
        want = [int(f) for f in want]
        if len(want) != self.capacity:
            raise ValueError(
                f"checkpoint residency has {len(want)} slots, working set "
                f"has {self.capacity}")
        for slot, full in enumerate(want):
            if self.slot_to_full[slot] != full:
                self.bank = self._update_slot(
                    slot, self.slot_payload(full))
        self.slot_to_full = list(want)
        self.full_to_slot = {f: s for s, f in enumerate(want)}
        self.last_used = [float(self.control.blocks)] * self.capacity
        self._span.clear()
        self._span_meta.clear()
        if self.on_update is not None:
            self.on_update(self.bank)
        # restore starved intents (newest-wins per voice/ch, like live):
        # everything was just protected for one fade window above, so
        # these typically re-park and apply as slots age out — the same
        # deferred semantics the checkpoint interrupted
        st = self.control.aux.get("ws_starved")
        self._starved.clear()
        if st is not None and self.on_exhausted == "defer":
            for v, c, f in np.asarray(st).reshape(-1, 3):
                self.control.set_select(int(v), int(c), int(f))

    # -- the remap hook (runs on the host between blocks) -----------------------

    def _live_span_slots(self, now: float) -> set[int]:
        """Slots referenced by any fade span that has not yet decayed."""
        live = set()
        for key, (block, window) in self._span_meta.items():
            if now - block < window:
                live |= self._span.get(key, set())
        return live

    def _retime_span(self, voice: int, ch: int, now: float) -> set:
        """A select event (applied OR deferred) restarts the fade clock, so
        the voice's span protection must be re-timed with the NEW fade's
        window: clear a provably-decayed previous span, add the currently
        sounding slot (it enters its fade-out / re-slew), stamp the new
        analytic decay window, and refresh every member's idle-age
        protection. Shared by the sync and deferred paths — the eviction-
        safety proof requires them identical."""
        key = (voice, ch)
        span = self._span.setdefault(key, set())
        prev = self._span_meta.get(key)
        if prev is not None and now - prev[0] >= prev[1]:
            span.clear()  # previous fades provably decayed (analytic bound)
        span.add(int(self.control.select[voice, ch]))
        window = int(self.control.speed[voice, ch]) + self.DECAY_MARGIN
        self._span_meta[key] = (now, window)
        for s in span:
            self.last_used[s] = now
        return span

    def _remap(self, voice: int, ch: int, full_idx: int) -> int:
        if not 0 <= full_idx < self.full_size:
            # out-of-range CC scalings (the reference formula can exceed
            # the bank for malformed >7-bit values) clamp like the plain
            # engines' gathers do — never page in garbage
            Log.warn("workset", "select %d outside the %d-IR bank; clamped",
                     full_idx, self.full_size)
            full_idx = min(max(full_idx, 0), self.full_size - 1)
        now = self.control.blocks
        # any new select supersedes a starved intent for this (voice, ch);
        # if this one starves too it re-parks itself below
        self._starved.pop((voice, ch), None)
        slot = self.full_to_slot.get(full_idx)
        if slot is None and self.async_paging:
            # deferred fault: selection stays put until the IR is resident
            return self._defer(voice, ch, full_idx, now)
        self._deferred_target.pop((voice, ch), None)  # superseded if pending
        if slot is None:
            # may raise (exhausted under 'raise' policy / payload failure):
            # the select then never applies, so nothing is re-timed — the
            # span keeps its previous (possibly expired) window
            try:
                slot = self._fault(full_idx, now)
            except WorkingSetExhausted:
                if self.on_exhausted != "defer":
                    raise
                return self._starve(voice, ch, full_idx, now)
        else:
            self.hits += 1
        span = self._retime_span(voice, ch, now)
        span.add(int(slot))
        self.last_used[slot] = now
        return slot

    def _victims(self, now: float) -> list[int]:
        selected = {int(s) for s in self.control.select.ravel()}
        # never evict a slot a live (undecayed) fade span references, even
        # under a custom min_age_blocks shorter than the fade window; nor
        # one reserved by an in-flight asynchronous upload
        protected = selected | self._live_span_slots(now) | self._reserved
        return [s for s in range(self.capacity)
                if s not in protected
                and now - self.last_used[s] >= self.min_age_blocks]

    def _choose_victim(self, now: float) -> int:
        victims = self._victims(now)
        if not victims:
            raise WorkingSetExhausted(
                f"working set exhausted: all {self.capacity} resident IR "
                f"slots are selected or were used within the last "
                f"{self.min_age_blocks} blocks (fade protection); raise "
                f"the capacity (concurrently sounding IRs + fading tails "
                f"must fit)")
        return min(victims, key=lambda s: self.last_used[s])

    def _fault(self, full_idx: int, now: float) -> int:
        victim = self._choose_victim(now)
        old_full = self.slot_to_full[victim]
        # pack + upload BEFORE touching the residency maps: a failed
        # payload/upload must not leave them claiming an IR is resident
        # that never landed (a later select of it would 'hit' a slot still
        # holding the evicted IR and silently play the wrong sound)
        self.bank = self._update_slot(
            victim, self.slot_payload(full_idx))
        self.full_to_slot.pop(old_full, None)
        self.slot_to_full[victim] = full_idx
        self.full_to_slot[full_idx] = victim
        self.misses += 1
        self._sync_aux()
        Log.info("workset", "IR %d -> slot %d (evicted %d; miss #%d)",
                 full_idx, victim, old_full, self.misses)
        if self.on_update is not None:
            self.on_update(self.bank)
        return victim

    # -- asynchronous paging ------------------------------------------------------

    def _defer(self, voice: int, ch: int, full_idx: int, now: float) -> int:
        """Enqueue a background fault and keep the selection unchanged: the
        event degenerates to a wet re-slew toward the current IR; the real
        select (and its crossfade) is re-issued by poll() once resident."""
        rec = self._pending.get(full_idx)
        if rec is None:
            try:
                victim = self._choose_victim(now)
            except WorkingSetExhausted:
                if self.on_exhausted != "defer":
                    raise
                # no slot to reserve yet: park the intent; poll() enqueues
                # the real deferred fault once a victim ages out
                return self._starve(voice, ch, full_idx, now)
            old_full = self.slot_to_full[victim]
            self.full_to_slot.pop(old_full, None)
            self.slot_to_full[victim] = full_idx
            self._reserved.add(victim)
            rec = {"full": full_idx, "slot": victim, "old_full": old_full,
                   "result": None, "error": None,
                   "ready": threading.Event()}
            self._pending[full_idx] = rec
            self._pending_order.append(rec)
            self._queue.put(rec)
        # a deferred select still restarts the fade clock (the event
        # re-slews wet with the NEW vsteps, reference conv.cu:261), so the
        # span's analytic decay window must be re-timed exactly like the
        # sync path — otherwise a slow fade started here could outlive its
        # (stale) window and leave a still-audible span slot evictable by
        # a concurrent voice's fault
        self._retime_span(voice, ch, now)
        self._deferred_target[(voice, ch)] = full_idx
        self.deferred += 1
        return int(self.control.select[voice, ch])

    def _starve(self, voice: int, ch: int, full_idx: int, now: float) -> int:
        """Exhaustion deferral ('defer' policy): park the select as a host
        intent and keep the voice on its current IR. Same observable
        semantics as an async-paging deferral — the event re-slews wet and
        restarts the fade clock, the real select (with its crossfade) is
        re-issued by poll() once an eviction victim exists. Newest select
        per (voice, ch) wins; intents are kept in control.aux."""
        key = (voice, ch)
        Log.warn("workset", "working set exhausted: select IR %d (voice %d "
                 "ch %d) deferred until a slot leaves fade protection "
                 "(%d starved so far)", full_idx, voice, ch,
                 self.starved + 1)
        self._retime_span(voice, ch, now)
        self._starved[key] = full_idx
        self.starved += 1
        self._sync_aux()
        return int(self.control.select[voice, ch])

    def _worker_loop(self) -> None:
        """The pager thread: packs each queued IR on a CUDA stream of its
        own (the CPU has none) and marks the record ready once the device
        work it queued has finished, or once it failed."""
        device = self.engine.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        on_stream = (torch.cuda.stream(stream) if stream is not None
                     else contextlib.nullcontext())
        with on_stream:
            while True:
                rec = self._queue.get()
                if rec is None:
                    return
                try:
                    packed = self.engine.pack_bank_slot(
                        self.slot_payload(rec["full"]))
                    if packed.done is not None:
                        packed.done.synchronize()
                    rec["result"] = packed
                except Exception as exc:  # noqa: BLE001 - surfaced in poll()
                    rec["error"] = exc
                rec["ready"].set()

    def poll(self) -> None:
        """Publish completed background uploads and re-issue their deferred
        selects. Runs between blocks (registered on control.block_hooks)."""
        while self._pending_order and self._pending_order[0]["ready"].is_set():
            rec = self._pending_order.pop(0)
            self._pending.pop(rec["full"], None)
            self._reserved.discard(rec["slot"])
            if rec["error"] is not None:
                # roll back the defer's residency claim — the upload never
                # landed, so the slot still holds the evicted IR (unless
                # old_full has since been re-faulted into another slot)
                self.slot_to_full[rec["slot"]] = rec["old_full"]
                if rec["old_full"] not in self.full_to_slot:
                    self.full_to_slot[rec["old_full"]] = rec["slot"]
                for key, want in list(self._deferred_target.items()):
                    if want == rec["full"]:
                        del self._deferred_target[key]
                raise rec["error"]
            # the write is queued on the block loop's stream after every
            # block already in flight (the victim slot is inert to them)
            self.bank = self._write_slot(rec["slot"], rec["result"])
            rec["result"] = None
            self.full_to_slot[rec["full"]] = rec["slot"]
            self.last_used[rec["slot"]] = self.control.blocks
            self.misses += 1
            self._sync_aux()
            Log.info("workset", "IR %d -> slot %d (async; evicted %d; "
                     "miss #%d)", rec["full"], rec["slot"], rec["old_full"],
                     self.misses)
            if self.on_update is not None:
                self.on_update(self.bank)
            for (v, c), want in list(self._deferred_target.items()):
                if want == rec["full"]:
                    del self._deferred_target[(v, c)]
                    self.control.set_select(v, c, rec["full"])
        # retry starved selects (exhaustion deferrals) in arrival order.
        # An intent is retried once its IR is already resident (another
        # voice faulted it in — a plain hit, no victim needed) or an
        # eviction victim exists; set_select re-enters _remap, which may
        # hit, fault, async-defer, or re-park if capacity vanished again
        # (re-parking under _starve keeps the intent, so nothing is lost)
        if self._starved:
            now = self.control.blocks
            for key in list(self._starved):
                full = self._starved.get(key)
                if full is None:
                    continue  # superseded while iterating
                if full in self.full_to_slot or self._victims(now):
                    del self._starved[key]
                    self.control.set_select(key[0], key[1], full)
            self._sync_aux()

    def drain(self, timeout: float | None = None) -> None:
        """Block until every in-flight background upload has completed,
        then publish them all (async mode; no-op otherwise). Deterministic
        sync point for checkpointing/shutdown — and for tests that need
        the publish block to be schedule-independent."""
        for rec in list(self._pending_order):
            if not rec["ready"].wait(timeout):
                raise TimeoutError(
                    f"pending IR {rec['full']} upload did not complete "
                    f"within {timeout} s")
        self.poll()

    def close(self) -> None:
        """Stop the background pager thread (async mode)."""
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join(timeout=5)
            self._worker = None
