"""One CUDA graph of the fmajor engine's steady ring step
(``FMajorPartitionedConvolution.step_coef_steady`` in ring mode under
'allk'): the eager step enqueues ~90 small launches a block from Python, a
replay of its capture enqueues the same kernels in the same order with one
call, so its outputs are the eager step's bit for bit.

A graph holds the device addresses it was captured against, so a capture is
bound to one set of buffers (``steady_key``):

  - the state's delay line ``fdl`` and wet ring ``wet_ring``, which the
    step updates in place as it does eagerly, and the bank's ``rhs2``,
    which it reads (a working set's in-place slot writes keep the capture
    valid). The capture keeps no reference to them;
  - every other input is copied into the graph's own static tensors before
    a replay: the block ``x`` always; the state's ``prev_in``, ``coef_a``,
    ``coef_c`` and ``wptr`` unless they are what the last replay returned
    (the captured step writes its new values back into these statics); a
    ``VoiceParams`` field only when it is another tensor than the one last
    copied in, or was written since.

A replay returns what the eager step returns: ``out``, ``coef_a``,
``coef_c`` and ``wptr`` are cloned off the graph's statics, so that no
later replay overwrites them; ``prev_in`` is the caller's ``x``; every
other leaf is the state's own.
"""

from __future__ import annotations

import gc
from dataclasses import fields, replace

import torch

from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.ops.ring_mac import ring_mac

# state leaves copied in before a replay and written back by it
STATE_INPUTS = ("prev_in", "coef_a", "coef_c", "wptr")
PARAM_FIELDS = tuple(f.name for f in fields(VoiceParams))


def steady_key(state, bank, x: torch.Tensor) -> tuple:
    """What a capture is bound to: the address and layout of each buffer
    the graph reads or writes in place, and the block's layout."""
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype)
                 for t in (state.fdl, state.wet_ring, bank.rhs2)
                 ) + (x.shape, x.dtype)


def run_on(stream: torch.cuda.Stream, step, *args):
    """step(*args) -> (state, out) on `stream`, after the current stream's
    queued work and before its later work; the leaves it allocated are
    marked in use by the current stream, which reads them next."""
    current = torch.cuda.current_stream(stream.device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        state, out = step(*args)
    current.wait_stream(stream)
    for t in (out, state.coef_a, state.coef_c, state.wptr):
        t.record_stream(current)
    return state, out


class SteadyRingGraph:
    """The capture of `step` (the engine's eager steady step) against one
    state's and one bank's buffers, and its replay."""

    def __init__(self, step, state, bank, params: VoiceParams,
                 x: torch.Tensor, stream: torch.cuda.Stream):
        """Capture `step(state, bank, params, x)` on `stream`. The caller
        has run the step once on these buffers on `stream` (cuFFT plans,
        the cuBLAS workspace and the kernels' launch state then exist).
        Nothing runs here: run() computes the block."""
        self.key = steady_key(state, bank, x)
        self.x = x.clone()
        self.inputs = {n: getattr(state, n).clone() for n in STATE_INPUTS}
        self.params = VoiceParams(**{n: getattr(params, n).clone()
                                     for n in PARAM_FIELDS})
        # per copied-in input: the tensor whose values the static holds,
        # and its version counter then
        self._held = {}
        for owner, names in ((state, STATE_INPUTS), (params, PARAM_FIELDS)):
            for n in names:
                t = getattr(owner, n)
                self._held[n] = (t, t._version)
        counts = (ring_mac.launches, ring_mac.launches_bf16)
        self.graph = torch.cuda.CUDAGraph()
        # no garbage collection while capturing: a collected CUDA graph's
        # destructor (an unreachable engine's) would invalidate the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, stream=stream,
                                  capture_error_mode="thread_local"):
                new, self.out = step(replace(state, **self.inputs), bank,
                                     self.params, self.x)
                for n in ("coef_a", "coef_c", "wptr"):
                    self.inputs[n].copy_(getattr(new, n))
                self.inputs["prev_in"].copy_(self.x)
        finally:
            if collecting:
                gc.enable()
        # the capture launched nothing: count the launches a replay makes
        self.launches = ring_mac.launches - counts[0]
        self.launches_bf16 = ring_mac.launches_bf16 - counts[1]
        ring_mac.launches, ring_mac.launches_bf16 = counts

    def _copy_in(self, static: torch.Tensor, name: str,
                 t: torch.Tensor) -> None:
        held_t, version = self._held[name]
        if held_t is not t or version != t._version:
            static.copy_(t)
            self._held[name] = (t, t._version)

    def run(self, state, params: VoiceParams, x: torch.Tensor):
        """One block on the current stream: (new state, out), as the eager
        step returns them."""
        self.x.copy_(x)
        for n in STATE_INPUTS:
            self._copy_in(self.inputs[n], n, getattr(state, n))
        for n in PARAM_FIELDS:
            self._copy_in(getattr(self.params, n), n, getattr(params, n))
        self.graph.replay()
        ring_mac.launches += self.launches
        ring_mac.launches_bf16 += self.launches_bf16
        leaves = {n: self.inputs[n].clone() for n in ("coef_a", "coef_c",
                                                       "wptr")}
        leaves["prev_in"] = x
        for n, t in leaves.items():
            self._held[n] = (t, t._version)
        return replace(state, **leaves), self.out.clone()
