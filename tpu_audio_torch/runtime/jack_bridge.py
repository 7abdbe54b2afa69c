"""JACK audio bridge over ctypes, no build-time dependency (port of
tpu_audio/runtime/jack_bridge.py).

Capability equivalent of the reference's JackClient base class (reference
src/jackclient.h:10-63, src/jackclient.cu:24-55): open a client against a
running jackd, register stereo in/out ports, and move blocks between the
JACK process callback and the engine. The GPU serving design keeps the
engine OUT of the audio callback (the callback must return in
microseconds; a GPU step is enqueued from the session loop), so this bridge
adapts JACK to the lock-free shm rings the session already serves
(csrc/blockio.cpp via runtime/native.py):

    jackd RT thread --process_cb--> input NativeRing --> StreamSession
    StreamSession --> output NativeRing --process_cb--> jackd RT thread

Run the bridge in its own process (``python -m
tpu_audio_torch.runtime.jack_bridge --in-ring tpu_in --out-ring tpu_out
[--settings settings.txt]``, where --settings wires the conv[n].input/output
external ports exactly like the reference, src/main.cu:86-89) next to an app
started with ``--input-ring tpu_in --output-ring tpu_out``. One bridge moves
one stereo pair, so the app serves ``--voices 1`` behind it.

The ctypes process callback re-enters Python and therefore takes the GIL:
fine for a bridge process whose only job is two memcpys per period, but not
hard-real-time under arbitrary Python load. ``--native`` execs the C
implementation instead (csrc/jackbridge.cpp: the same rings and policies,
and an RT callback that never touches the interpreter). Both read
TPU_AUDIO_LIBJACK to find libjack, which is how they run against the
deterministic stub jackd (runtime/native.py:jack_stub_path).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os

import numpy as np

from tpu_audio_torch.utils.log import Log

_JACK_DEFAULT_AUDIO_TYPE = b"32 bit float mono audio"
_JackPortIsInput = 0x1
_JackPortIsOutput = 0x2
_JackNoStartServer = 0x01


def _load_libjack():
    # TPU_AUDIO_LIBJACK overrides discovery — the same contract as the C
    # bridge (csrc/jackbridge.cpp load_jack): non-standard install paths in
    # deployment, the stub jackd in tests
    name = os.environ.get("TPU_AUDIO_LIBJACK") or \
        ctypes.util.find_library("jack")
    if not name:
        return None
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.jack_client_open.restype = ctypes.c_void_p
    lib.jack_client_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                     ctypes.c_void_p]
    lib.jack_port_register.restype = ctypes.c_void_p
    lib.jack_port_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_char_p, ctypes.c_ulong,
                                       ctypes.c_ulong]
    lib.jack_port_get_buffer.restype = ctypes.POINTER(ctypes.c_float)
    lib.jack_port_get_buffer.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.jack_get_sample_rate.restype = ctypes.c_uint32
    lib.jack_get_sample_rate.argtypes = [ctypes.c_void_p]
    lib.jack_get_buffer_size.restype = ctypes.c_uint32
    lib.jack_get_buffer_size.argtypes = [ctypes.c_void_p]
    lib.jack_set_process_callback.argtypes = [ctypes.c_void_p,
                                              ctypes.c_void_p,
                                              ctypes.c_void_p]
    lib.jack_activate.argtypes = [ctypes.c_void_p]
    lib.jack_deactivate.argtypes = [ctypes.c_void_p]
    lib.jack_client_close.argtypes = [ctypes.c_void_p]
    lib.jack_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p]
    lib.jack_get_client_name.restype = ctypes.c_char_p
    lib.jack_get_client_name.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None
_LIB_TRIED = False


def jack_available() -> bool:
    """True when libjack is loadable on this host (a running jackd is
    additionally required to actually open a client)."""
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        _LIB = _load_libjack()
    return _LIB is not None


_PROCESS_CB = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32,
                               ctypes.c_void_p)


class JackRingBridge:
    """JACK client that bridges stereo audio to/from two NativeRings.

    Underrun policy matches the session's live semantics: if the output
    ring is dry the callback emits silence (the session's reverb tail
    resumes when it catches up); if the input ring is full the NEWEST
    capture period is dropped whole (the ring write is all-or-none,
    csrc/blockio.cpp — the SPSC contract forbids the producer consuming
    stale data to make room) and counted in ``overruns``. The reference's
    JACK client, being synchronous, could never fall behind — a GPU served
    over a loaded host can.

    ``expect_block``: the session's block size. jackd's period size MUST
    match it — the rings carry flat f32 with no framing, so a mismatch
    would not error, it would silently de-interleave into garbled
    channels. Pass None to skip the check.

    ``expect_rate``: the session's sample rate. A jackd at a different
    rate streams pitch-shifted audio with no other symptom (the reference
    at least reports the server's rate, jackclient.cu:39) — enforced like
    the block check. Pass None to skip.
    """

    def __init__(self, in_ring, out_ring, name: str = "tpu_audio",
                 server_may_start: bool = False,
                 expect_block: int | None = None,
                 expect_rate: int | None = None,
                 connect_inputs=None, connect_outputs=None):
        if not jack_available():
            raise RuntimeError("libjack not found on this host")
        self.lib = _LIB
        self.in_ring = in_ring
        self.out_ring = out_ring
        flags = 0 if server_may_start else _JackNoStartServer
        self.client = self.lib.jack_client_open(name.encode(), flags, None)
        if not self.client:
            raise RuntimeError(
                "jack_client_open failed (is jackd running?)")
        # the server may have renamed the client on collision: ALL port
        # strings must use the ASSIGNED name, or jack_connect wires nothing
        self.name = self.lib.jack_get_client_name(self.client).decode()
        self.sample_rate = self.lib.jack_get_sample_rate(self.client)
        self.block = self.lib.jack_get_buffer_size(self.client)
        if expect_block is not None and self.block != expect_block:
            self.lib.jack_client_close(self.client)
            raise RuntimeError(
                f"jackd runs {self.block} frames/period but the session "
                f"expects {expect_block}: the shm rings carry unframed f32 "
                f"and a mismatch garbles channels — restart jackd with "
                f"-p{expect_block} (or the session with --block-size "
                f"{self.block})")
        if expect_rate is not None and self.sample_rate != expect_rate:
            self.lib.jack_client_close(self.client)
            raise RuntimeError(
                f"jackd runs {self.sample_rate} Hz but the session expects "
                f"{expect_rate}: audio would stream pitch-shifted — restart "
                f"jackd with -r{expect_rate} (or the session at "
                f"{self.sample_rate} Hz)")
        self.ports_in = [self.lib.jack_port_register(
            self.client, f"in_{i}".encode(), _JACK_DEFAULT_AUDIO_TYPE,
            _JackPortIsInput, 0) for i in range(2)]
        self.ports_out = [self.lib.jack_port_register(
            self.client, f"out_{i}".encode(), _JACK_DEFAULT_AUDIO_TYPE,
            _JackPortIsOutput, 0) for i in range(2)]
        # external ports to wire at start(); per channel, like the
        # reference's conv[n].input/output keys (src/main.cu:86-89)
        self.connect_inputs = list(connect_inputs) if connect_inputs else [
            f"system:capture_{i + 1}" for i in range(2)]
        self.connect_outputs = list(connect_outputs) if connect_outputs else [
            f"system:playback_{i + 1}" for i in range(2)]
        self.underruns = 0
        self.overruns = 0
        # keep a reference: ctypes callbacks are garbage-collected otherwise
        self._cb = _PROCESS_CB(self._process)
        self.lib.jack_set_process_callback(self.client, self._cb, None)
        Log.info("jack", "client '%s': %d Hz, %d frames/period",
                 self.name, self.sample_rate, self.block)

    # the JACK RT thread calls this once per period
    def _process(self, nframes: int, _arg) -> int:
        try:
            frames = int(nframes)
            # capture -> input ring (planar [2, B] -> flat f32)
            ins = np.empty((2, frames), np.float32)
            for i, port in enumerate(self.ports_in):
                buf = self.lib.jack_port_get_buffer(port, nframes)
                ins[i] = np.ctypeslib.as_array(buf, shape=(frames,))
            if not self.in_ring.write(ins.ravel()):
                self.overruns += 1   # session fell behind; period dropped
            # output ring -> playback (silence on underrun)
            out = self.out_ring.read(2 * frames)
            if out is None:
                out = np.zeros(2 * frames, np.float32)
                self.underruns += 1
            out = out.reshape(2, frames)
            for i, port in enumerate(self.ports_out):
                buf = self.lib.jack_port_get_buffer(port, nframes)
                np.ctypeslib.as_array(buf, shape=(frames,))[:] = out[i]
            return 0
        except Exception:  # never raise into the RT thread
            return 1

    def start(self, connect_system: bool = True) -> None:
        if self.lib.jack_activate(self.client):
            raise RuntimeError("jack_activate failed")
        if connect_system:
            # reference wiring: external input -> ins, outs -> external
            # output per channel (src/main.cu:86-89, conv[n].input/output);
            # failures are non-fatal, like the reference's unchecked
            # jack_connect calls
            for i in range(2):
                self.lib.jack_connect(
                    self.client, self.connect_inputs[i].encode(),
                    f"{self.name}:in_{i}".encode())
                self.lib.jack_connect(
                    self.client, f"{self.name}:out_{i}".encode(),
                    self.connect_outputs[i].encode())

    def stop(self) -> None:
        self.lib.jack_deactivate(self.client)
        self.lib.jack_client_close(self.client)


def ports_from_settings(settings, pair: int = 0):
    """Resolve the external JACK port names for one conv pair from a
    parsed Settings, per the reference's conv[n].input/output keys
    (src/main.cu:86-89, settings.txt). Missing keys fall back to the
    system capture/playback defaults. Returns (inputs, outputs)."""
    inputs, outputs = [], []
    for i in range(2):
        idx = pair * 2 + i
        inputs.append(settings.str(
            "conv[%d].input", idx, default=f"system:capture_{i + 1}"))
        outputs.append(settings.str(
            "conv[%d].output", idx, default=f"system:playback_{i + 1}"))
    return inputs, outputs


def main(argv=None) -> int:
    """Bridge process entry point (see module docstring)."""
    import argparse
    import time

    from tpu_audio_torch.runtime.native import NativeRing

    ap = argparse.ArgumentParser(prog="tpu_audio_torch.runtime.jack_bridge")
    ap.add_argument("--in-ring", required=True,
                    help="shm ring name the session reads input from")
    ap.add_argument("--out-ring", required=True,
                    help="shm ring name the session writes output to")
    ap.add_argument("--name", default="tpu_audio")
    ap.add_argument("--expect-block", type=int, default=None,
                    help="session block size; jackd's period must match "
                         "(the rings carry unframed f32)")
    ap.add_argument("--expect-rate", type=int, default=None,
                    help="session sample rate; jackd must match (a "
                         "mismatch streams pitch-shifted audio with no "
                         "other symptom)")
    ap.add_argument("--connect-in", action="append", default=None,
                    metavar="PORT",
                    help="external port to wire into channel N's input "
                         "(repeat twice; default system:capture_1/2)")
    ap.add_argument("--connect-out", action="append", default=None,
                    metavar="PORT",
                    help="external port channel N's output feeds "
                         "(repeat twice; default system:playback_1/2)")
    ap.add_argument("--settings", default=None,
                    help="settings.txt to read conv[n].input/output port "
                         "names from (reference wiring, src/main.cu:86-89); "
                         "explicit --connect-in/--connect-out win")
    ap.add_argument("--pair", type=int, default=0,
                    help="conv pair index inside --settings (pair n reads "
                         "conv[2n]/conv[2n+1])")
    ap.add_argument("--native", action="store_true",
                    help="exec the C bridge (csrc/jackbridge.cpp, built "
                         "into tpu_audio_torch/_build) instead: the JACK RT "
                         "callback stays pure C, with no GIL")
    args = ap.parse_args(argv)
    connect_in, connect_out = None, None
    if args.settings:
        from tpu_audio_torch.io.settings import Settings
        s = Settings().open(args.settings, verbose=False)
        connect_in, connect_out = ports_from_settings(s, pair=args.pair)
    if args.connect_in:
        connect_in = args.connect_in
    if args.connect_out:
        connect_out = args.connect_out
    for lst, flag in ((connect_in, "--connect-in"),
                      (connect_out, "--connect-out")):
        if lst is not None and len(lst) != 2:
            ap.error(f"{flag} must be given exactly twice (stereo)")
    if args.native:
        from tpu_audio_torch.runtime.native import bridge_path
        exe = bridge_path()
        if exe is None:
            ap.error("--native: C bridge build failed (g++/toolchain?)")
        argv_c = [exe, "--in-ring", args.in_ring,
                  "--out-ring", args.out_ring, "--name", args.name]
        if args.expect_block is not None:
            argv_c += ["--expect-block", str(args.expect_block)]
        if args.expect_rate is not None:
            argv_c += ["--expect-rate", str(args.expect_rate)]
        for p in connect_in or []:
            argv_c += ["--connect-in", p]
        for p in connect_out or []:
            argv_c += ["--connect-out", p]
        os.execv(exe, argv_c)  # replaces this process; no return
    bridge = JackRingBridge(NativeRing.open(args.in_ring),
                            NativeRing.open(args.out_ring), name=args.name,
                            expect_block=args.expect_block,
                            expect_rate=args.expect_rate,
                            connect_inputs=connect_in,
                            connect_outputs=connect_out)
    bridge.start()
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        bridge.stop()
        Log.info("jack", "bridge stopped (%d underruns, %d overruns)",
                 bridge.underruns, bridge.overruns)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
