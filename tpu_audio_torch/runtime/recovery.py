"""Failure detection and recovery: rebuild a failed session and resume it
from its last checkpoint (port of tpu_audio/runtime/recovery.py).

The reference's only failure policy is assert() -> process abort (its JACK
shutdown hook does nothing, reference src/jackclient.cu:13-18). Here the
recovery unit is the streaming loop: any recoverable exception escaping
StreamSession.run (a failed readback, a dead transport, a sink that raised)
ends that session, and ``run_resilient``:

  - builds a FRESH model through the caller's factory (new device tensors,
    a new bank prep);
  - restores the last periodic checkpoint (runtime/checkpoint.py) and
    rewinds the scripted MIDI so events at blocks >= the checkpoint replay
    (a chunk further back for a chunked session, whose checkpoint holds
    only the events of the chunks before it);
  - rewinds a seekable source to the checkpoint block, so the regenerated
    stream is EXACT, and drops the regenerated blocks already delivered
    (a dedup sink), so the sink sees a gap-free, duplicate-free stream;
  - lets a live (unseekable) source just continue: input during the outage
    is lost, which is the honest semantics of live audio.

What in-process recovery cannot do on CUDA: a sticky device error (an
illegal memory address, a device-side assert, a failed launch that
corrupts the context) poisons the CUDA context for the whole process; no
later allocation or kernel in this process can succeed, and a fresh model
built here would fail the same way. After a failure on a CUDA model,
run_resilient therefore probes the device before rebuilding and re-raises
when the context is dead: only a NEW process that loads the checkpoint
(the same run_resilient call, restarted by a supervisor, resumes from it)
recovers from such an error.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpu_audio_torch.runtime.backends import BlockSink
from tpu_audio_torch.runtime.checkpoint import load_checkpoint
from tpu_audio_torch.utils.log import Log


class _DedupSink(BlockSink):
    """Drops blocks already delivered before a crash-and-replay."""

    def __init__(self, sink: BlockSink):
        self.sink = sink
        self.delivered = 0
        self._skip = 0

    def rewind_to(self, block_index: int) -> None:
        self._skip = max(self.delivered - block_index, 0)

    def write(self, block: np.ndarray) -> None:
        if self._skip > 0:
            self._skip -= 1
            return
        self.sink.write(block)
        self.delivered += 1

    def close(self) -> None:
        pass  # closed once by run_resilient


def _check_device(device: torch.device, exc: BaseException) -> None:
    """Raise when the failure left the CUDA context unusable (a sticky
    error): carrying on in this process would fail again at once."""
    if device.type != "cuda":
        return
    try:
        torch.cuda.synchronize(device)
        torch.zeros(1, device=device).add_(1).cpu()
    except RuntimeError as probe:
        raise RuntimeError(
            f"the CUDA context is unusable after {type(exc).__name__}: "
            f"{exc} ({probe}); in-process recovery is impossible — restart "
            f"the process and resume from the checkpoint") from exc


def run_resilient(build_model, source, sink: BlockSink, checkpoint_path,
                  max_blocks: int | None = None, midi=None, live_midi=None,
                  checkpoint_every: int = 256, max_restarts: int = 3,
                  recoverable: tuple = (Exception,),
                  session_kwargs: dict | None = None):
    """Stream source->engine->sink with automatic crash recovery.

    build_model: zero-arg callable returning a fresh ConvolutionReverb
    (fresh device tensors — a failed session's model is not reused).
    Returns (state, summary) of the final session; the summary adds
    ``restarts``, ``blocks_delivered``, ``recoveries`` (per restart: the
    blocks delivered when it failed, the block it resumed from, and the
    seconds of the rebuild and of the checkpoint load) and
    ``checkpoint_saves`` (every session's saves, runtime/stream.py).
    """
    checkpoint_path = os.fspath(checkpoint_path)
    session_kwargs = dict(session_kwargs or {})
    deduped = _DedupSink(sink)
    restarts = 0
    resume_block = 0
    recoveries, saves = [], []
    model = build_model()
    state = model.init_state()

    while True:
        session = model.session(source, deduped, **session_kwargs)
        try:
            remaining = (None if max_blocks is None
                         else max_blocks - resume_block)
            state = session.run(state, max_blocks=remaining, midi=midi,
                                live_midi=live_midi,
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every,
                                start_block=resume_block)
            saves += session.checkpoint_saves
            break
        except recoverable as exc:  # noqa: PERF203 - the recovery path
            saves += session.checkpoint_saves
            restarts += 1
            if restarts > max_restarts:
                Log.error("recover", "giving up after %d restarts",
                          max_restarts)
                raise
            _check_device(model.device, exc)
            Log.warn("recover", "session failed at ~block %d (%s: %s); "
                     "rebuilding", deduped.delivered, type(exc).__name__, exc)
            if model.working_set is not None:
                model.working_set.close()
            t0 = time.perf_counter()
            model = build_model()  # fresh device tensors and bank
            t1 = time.perf_counter()
            if os.path.exists(checkpoint_path):
                state, meta = load_checkpoint(
                    checkpoint_path, model.engine.init_state(), model.control)
                resume_block = int(meta.get("block_index", 0))
            else:
                state = model.init_state()
                resume_block = 0
            recoveries.append({"delivered": deduped.delivered,
                               "resume_block": resume_block,
                               "rebuild_s": t1 - t0,
                               "load_s": time.perf_counter() - t1})
            # events at blocks >= the checkpoint must replay: the restored
            # control plane carries the state up to the checkpoint block.
            # A chunked session applies events at chunk STARTS, so a
            # checkpoint at block C has only events <= C - chunk in it:
            # rewind a chunk further back (the replays land at the chunk
            # boundary where the uninterrupted run applied them)
            if midi is not None and hasattr(midi, "rewind_to"):
                chunk = int(session_kwargs.get("chunk_blocks") or 1)
                midi.rewind_to(resume_block - (chunk - 1))
            if hasattr(source, "seek"):
                source.seek(resume_block)
                deduped.rewind_to(resume_block)
                Log.info("recover", "resumed exactly from checkpoint block "
                         "%d", resume_block)
            else:
                # live source: blocks during the outage are gone; the
                # restored engine state keeps the reverb tail consistent
                deduped.rewind_to(deduped.delivered)
                Log.info("recover", "live source: resuming from block %d "
                         "with restored state (outage gap dropped)",
                         deduped.delivered)

    sink.close()
    summary = session.summary()
    summary["restarts"] = restarts
    summary["blocks_delivered"] = deduped.delivered
    summary["recoveries"] = recoveries
    summary["checkpoint_saves"] = saves
    return state, summary
