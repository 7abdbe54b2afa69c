"""ctypes bindings to the C++ native runtime, csrc/blockio.cpp (port of
tpu_audio/runtime/native.py).

Provides the host-side real-time primitives the reference implements in
C++ (JACK block delivery src/jackclient.cu, ALSA MIDI framing src/midi.cu,
clock pinning scripts/floorit):

  - NativeRing: lock-free SPSC float ring buffer, optionally shared-memory
    backed so another process (an audio server, a capture daemon, the JACK
    bridge) can exchange blocks with the engine with no locks on the RT
    path;
  - NativeBlockClock: drift-free absolute-deadline pacing with
    missed-deadline accounting;
  - NativeMidiFramer: C implementation of the MIDI framer, bit-compatible
    with tpu_audio_torch.io.midi.MidiFramer;
  - RingSource / RingSink: BlockSource/BlockSink adapters over NativeRing.

The C++ sources are read in place from the repository's ``csrc/`` and never
written there: ``g++`` builds each artefact (the library, the C JACK bridge
``csrc/jackbridge.cpp``, the stub libjack ``csrc/jackstub.cpp`` the bridges
are tested against) at first use into ``tpu_audio_torch/_build/``, under a
name keyed by a hash of its sources and flags, so a stale build is never
loaded. Nothing is built at import time. ``native_available()`` is False
when no toolchain exists; callers then fall back to the pure-Python
framer and the sleep clock.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from tpu_audio_torch.ops.cuda_build import BUILD_DIR
from tpu_audio_torch.runtime.backends import BlockSink, BlockSource
from tpu_audio_torch.utils.log import Log

CSRC = Path(__file__).resolve().parents[2] / "csrc"

_LIB_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_BRIDGE_FLAGS = ("-O2", "-std=c++17")
_lib = None
_lib_lock = threading.Lock()


def _build(name: str, sources: tuple[str, ...], compile_units: tuple[str, ...],
           flags: tuple[str, ...], libs: tuple[str, ...], what: str
           ) -> Path | None:
    """g++ `compile_units` (files of csrc/) into _build/ as `name` with
    `_<hash>` before its suffix, where the hash covers every file of
    `sources` and the command line. Compiles to a pid-unique tmp file and
    os.replace()s it into place, so concurrent first uses never load a
    half-written binary. None when a source is missing or the build
    fails."""
    digest = hashlib.sha256(" ".join(flags + libs).encode())
    for source in sources:
        path = CSRC / source
        if not path.exists():
            return None
        digest.update(path.read_bytes())
    stem, dot, suffix = name.partition(".")
    out = BUILD_DIR / f"{stem}_{digest.hexdigest()[:16]}{dot}{suffix}"
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", *flags, *(str(CSRC / u) for u in compile_units),
                        "-o", str(tmp), *libs],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    except (subprocess.SubprocessError, FileNotFoundError, OSError) as exc:
        Log.warn("native", "%s build failed: %s", what, exc)
        tmp.unlink(missing_ok=True)
        return None
    return out


def library_path() -> Path | None:
    """Build (hash-keyed) and return the shared library of blockio.cpp."""
    return _build("libtpuaudio.so", ("blockio.cpp", "blockio.h"),
                  ("blockio.cpp",), _LIB_FLAGS, ("-lrt",), "native library")


def bridge_path() -> str | None:
    """Build (hash-keyed, like the library) and return the native JACK
    bridge executable (csrc/jackbridge.cpp) — the no-GIL RT sibling of
    runtime/jack_bridge.py. None when the toolchain is unavailable."""
    path = _build("tpuaudio_jackbridge",
                  ("jackbridge.cpp", "blockio.cpp", "blockio.h"),
                  ("jackbridge.cpp", "blockio.cpp"), _BRIDGE_FLAGS,
                  ("-ldl", "-lrt", "-lpthread"), "jack bridge")
    return None if path is None else str(path)


def jack_stub_path() -> str | None:
    """Build and return the deterministic stub libjack (csrc/jackstub.cpp):
    point TPU_AUDIO_LIBJACK at it and either bridge runs against a fake
    jackd whose periods, rate, capture pattern and playback dump are set by
    JACK_STUB_* variables. None when the toolchain is unavailable."""
    path = _build("libjackstub.so", ("jackstub.cpp",), ("jackstub.cpp",),
                  _LIB_FLAGS, ("-lpthread",), "jack stub")
    return None if path is None else str(path)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            Log.warn("native", "cannot load %s: %s", path, exc)
            return None
        u64, i64, u32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_uint32
        p = ctypes.c_void_p
        lib.ta_ring_create.restype = p
        lib.ta_ring_create.argtypes = [u64, ctypes.c_char_p]
        lib.ta_ring_open.restype = p
        lib.ta_ring_open.argtypes = [ctypes.c_char_p]
        lib.ta_ring_destroy.argtypes = [p, ctypes.c_char_p]
        lib.ta_ring_capacity.restype = u64
        lib.ta_ring_capacity.argtypes = [p]
        lib.ta_ring_readable.restype = u64
        lib.ta_ring_readable.argtypes = [p]
        lib.ta_ring_writable.restype = u64
        lib.ta_ring_writable.argtypes = [p]
        lib.ta_ring_write.restype = u64
        lib.ta_ring_write.argtypes = [p, ctypes.POINTER(ctypes.c_float), u64]
        lib.ta_ring_read.restype = u64
        lib.ta_ring_read.argtypes = [p, ctypes.POINTER(ctypes.c_float), u64]
        lib.ta_clock_create.restype = p
        lib.ta_clock_create.argtypes = [u64]
        lib.ta_clock_wait.restype = i64
        lib.ta_clock_wait.argtypes = [p]
        lib.ta_clock_missed.restype = u64
        lib.ta_clock_missed.argtypes = [p]
        lib.ta_clock_ticks.restype = u64
        lib.ta_clock_ticks.argtypes = [p]
        lib.ta_clock_destroy.argtypes = [p]
        lib.ta_midi_create.restype = p
        lib.ta_midi_destroy.argtypes = [p]
        lib.ta_midi_feed.restype = u32
        lib.ta_midi_feed.argtypes = [p, ctypes.POINTER(ctypes.c_uint8), u32,
                                     ctypes.POINTER(ctypes.c_uint8), u32]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (needs g++)")
    return lib


class NativeRing:
    """SPSC float ring buffer; shared-memory backed when `shm_name` given."""

    def __init__(self, capacity: int, shm_name: str | None = None,
                 _handle=None, _owns: bool = True):
        self._lib = _require()
        self.shm_name = shm_name
        self._owns = _owns
        if _handle is not None:
            self._h = _handle
        else:
            self._h = self._lib.ta_ring_create(
                capacity, shm_name.encode() if shm_name else None)
            if not self._h:
                raise RuntimeError("ta_ring_create failed")

    @classmethod
    def open(cls, shm_name: str) -> "NativeRing":
        h = _require().ta_ring_open(shm_name.encode())
        if not h:
            raise RuntimeError(f"cannot open shm ring {shm_name}")
        return cls(0, shm_name, _handle=h, _owns=False)

    def _handle(self):
        # the C calls take the handle unchecked: a closed ring must raise,
        # not hand them a null pointer
        if not self._h:
            raise ValueError("the ring is closed")
        return self._h

    @property
    def capacity(self) -> int:
        return self._lib.ta_ring_capacity(self._handle())

    @property
    def readable(self) -> int:
        return self._lib.ta_ring_readable(self._handle())

    @property
    def writable(self) -> int:
        return self._lib.ta_ring_writable(self._handle())

    def write(self, data: np.ndarray) -> bool:
        """All or none: False (nothing written) when `data` does not fit."""
        data = np.ascontiguousarray(data, dtype=np.float32)
        ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.ta_ring_write(self._handle(), ptr, data.size))

    def read(self, n: int) -> np.ndarray | None:
        """`n` floats, or None (nothing consumed) when fewer are readable."""
        if self.readable < n:
            return None   # no allocation while the ring is short
        out = np.empty(n, np.float32)
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if not self._lib.ta_ring_read(self._handle(), ptr, n):
            return None
        return out

    def close(self, unlink: bool = False) -> None:
        if self._h:
            name = self.shm_name if (unlink and self._owns) else None
            self._lib.ta_ring_destroy(self._h, name.encode() if name else None)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeBlockClock:
    """Absolute-deadline block pacing (drift-free clock_nanosleep)."""

    def __init__(self, period_s: float):
        self._lib = _require()
        self._h = self._lib.ta_clock_create(int(period_s * 1e9))

    def wait(self) -> float:
        """Sleep to the next deadline; returns lateness in seconds (<=0 on
        time). Late blocks re-anchor instead of racing to catch up."""
        return self._lib.ta_clock_wait(self._h) / 1e9

    @property
    def missed(self) -> int:
        return self._lib.ta_clock_missed(self._h)

    @property
    def ticks(self) -> int:
        return self._lib.ta_clock_ticks(self._h)

    def close(self):
        if self._h:
            self._lib.ta_clock_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeMidiFramer:
    """C MIDI framer; same semantics as tpu_audio_torch.io.midi.MidiFramer."""

    def __init__(self):
        self._lib = _require()
        self._h = self._lib.ta_midi_create()
        self._out = np.empty(4096, np.uint8)

    def feed(self, data: bytes) -> list[bytes]:
        arr = np.frombuffer(data, dtype=np.uint8)
        # ta_midi_feed DROPS completed messages on out overflow; the bound
        # is 3 out bytes per input byte (a 1-data-byte running-status
        # message emits len + status + data) plus one buffered sub-256-byte
        # message
        need = 3 * arr.size + 260
        if self._out.size < need:
            self._out = np.empty(need, np.uint8)
        in_ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        out_ptr = self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        n = self._lib.ta_midi_feed(self._h, in_ptr, arr.size, out_ptr,
                                   self._out.size)
        messages = []
        i = 0
        while i < n:
            # int(): numpy promotes `int + uint8` to uint8, which would wrap
            # `i` at 256
            length = int(self._out[i])
            messages.append(bytes(self._out[i + 1:i + 1 + length]))
            i += 1 + length
        return messages

    def close(self):
        if self._h:
            self._lib.ta_midi_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class RingSource(BlockSource):
    """BlockSource over a NativeRing: frames arrive from another process or
    thread. `blocking` polls every 0.5 ms for up to `max_empty_reads` polls
    before reporting an underrun (None)."""

    def __init__(self, ring: NativeRing, num_voices: int, block: int,
                 blocking: bool = False, max_empty_reads: int = 1000):
        self.ring = ring
        self.shape = (num_voices, 2, block)
        self.n = num_voices * 2 * block
        self.blocking = blocking
        self.max_empty_reads = max_empty_reads

    def read(self) -> np.ndarray | None:
        empty = 0
        while True:
            data = self.ring.read(self.n)
            if data is not None:
                return data.reshape(self.shape)
            if not self.blocking:
                return None
            empty += 1
            if empty > self.max_empty_reads:
                return None
            time.sleep(0.0005)

    def backlog(self) -> int:
        return self.ring.readable // self.n


class RingSink(BlockSink):
    """BlockSink into a NativeRing; a block that does not fit is dropped
    whole and counted in `dropped`. `latency_blocks` silent blocks go into
    the ring just ahead of the first block: the consumer, which takes one
    block per period, then finds that many blocks in hand, so a block that
    comes up to that many periods late plays on time."""

    def __init__(self, ring: NativeRing, latency_blocks: int = 0):
        self.ring = ring
        self.dropped = 0
        self._lead = latency_blocks

    def write(self, block: np.ndarray) -> None:
        if self._lead:
            silence = np.zeros_like(block)
            for _ in range(self._lead):
                self.ring.write(silence)
            self._lead = 0
        if not self.ring.write(block):
            self.dropped += 1
