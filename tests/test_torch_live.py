"""The port's live serving path: the MIDI framer (tpu_audio_torch/io/midi.py)
against the JAX package's, the native runtime bindings (runtime/native.py:
shm rings, the block clock, the C framer, built from csrc/ into
tpu_audio_torch/_build and never into csrc/), the MIDI transports
(runtime/midi_transport.py), live MIDI in the session, the JACK bridges
(runtime/jack_bridge.py and the C bridge, against the stub jackd of
csrc/jackstub.cpp) and the CLI's live flags across two processes.

Framers must agree message for message; a session fed live MIDI must equal
the same events scheduled at the blocks where they applied, to the bit in
the port and within 2e-5 against the JAX session.
"""

import hashlib
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.io.midi import MidiFramer as JaxFramer
from tpu_audio.io.midi import is_valid_message as jax_is_valid
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.io.midi import (
    MidiFramer, cc_bytes, is_valid_message, parse_cc,
)
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime import native
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "csrc"
# what the JAX package itself builds into csrc/ (tpu_audio/runtime/
# native.py), which other test files may create while these run
JAX_ARTEFACTS = re.compile(r"(libtpuaudio\.so|tpuaudio_jackbridge)"
                           r"(\.src\.sha256)?(\.tmp\.\d+)?$")


def _csrc_snapshot():
    """Every file of csrc/ that is not the JAX package's own artefact, with
    the hash of its bytes."""
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in CSRC.iterdir() if not JAX_ARTEFACTS.match(p.name)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The port's three g++ artefacts, built once for this module into a
    fresh build directory (so the build really runs), with csrc/ snapshots
    from before and after."""
    before = _csrc_snapshot()
    build_dir = tmp_path_factory.mktemp("build")
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "BUILD_DIR", build_dir)
    mp.setattr(native, "_lib", None)
    paths = {"library": native.library_path(), "bridge": native.bridge_path(),
             "stub": native.jack_stub_path()}
    if not all(paths.values()) or not native.native_available():
        mp.undo()
        pytest.skip("native toolchain (g++) unavailable")
    yield {"paths": paths, "dir": build_dir, "before": before,
           "after": _csrc_snapshot()}
    mp.undo()


# -- the framer ------------------------------------------------------------------------


MIDI_CASES = [
    [bytes([0xB0, 21, 64])],
    [bytes([0xB0, 21, 64, 22, 100, 23, 1])],
    [bytes([0xB0, 21]), bytes([64]), bytes([25, 127])],
    [bytes([0x90, 60, 127, 0x80, 60, 0])],
    [bytes([0xF0, 1, 2, 3, 0xF7])],
    [bytes([0xC0, 5]), bytes([0xE0, 0, 64])],
    [bytes([0x42]), bytes([0xB1, 21, 3])],
    [bytes([0xB0, 21, 64, 0xFE, 22, 9]), bytes([0xB0, 23, 0xF8, 5])],
    [bytes([0xB0, 0x15, 0x40, 0xF1, 0x05, 0x16, 0x41, 0xF2, 0x01, 0x02,
            0xF6])],
    [bytes([0xF0, 0x01, 0x02, 0xF7]), bytes([0x10, 0x20, 0x30]),
     bytes([0xB0, 0x15, 0x40, 0xF1, 0x05]), bytes([0x16, 0x41])],
]


def _random_stream(seed, n=300):
    """Valid messages, running status, realtime bytes, SysEx, system
    common and stray data bytes."""
    rng = np.random.default_rng(seed)
    stream = bytearray()
    for _ in range(n):
        kind = int(rng.integers(0, 8))
        d = [int(b) for b in rng.integers(0, 128, 3)]
        stream += [bytes([0xB0 | d[2] % 16, d[0], d[1]]), bytes(d[:2]),
                   bytes([0x90, d[0], d[1]]), bytes([0xF8]),
                   bytes([0xC0, d[0]]), bytes([0xF0, d[0], d[1], 0xF7]),
                   bytes([0xF1, d[0]]), bytes([d[0]])][kind]
    return bytes(stream)


def _chunks(stream, seed):
    rng = np.random.default_rng(seed)
    i = 0
    while i < len(stream):
        n = int(rng.integers(1, 9))
        yield stream[i:i + n]
        i += n


@pytest.mark.parametrize("case", range(len(MIDI_CASES) + 3))
def test_framer_matches_the_jax_framer(case):
    """Feed by feed, the same messages as the JAX framer: the JAX tests'
    cases (tests/test_midi.py), then seeded random streams in random
    chunks."""
    feeds = (MIDI_CASES[case] if case < len(MIDI_CASES)
             else list(_chunks(_random_stream(case), case)))
    port, jax_side = MidiFramer(), JaxFramer()
    for chunk in feeds:
        assert port.feed(chunk) == jax_side.feed(chunk), chunk.hex()
        assert port.running_status == jax_side.running_status


def test_framer_helpers_match_jax():
    for status in range(0x80, 0x100):
        for n in range(1, 4):
            msg = bytes([status] + [0x10] * (n - 2) + [0xF7] * (n > 1))
            assert is_valid_message(msg) == jax_is_valid(msg)
    assert cc_bytes(3, 21, 200) == bytes([0xB3, 21, 72])
    assert parse_cc(bytes([0xB3, 21, 72])) == (0xB3, 21, 72)
    assert parse_cc(bytes([0x93, 21, 72])) is None
    with pytest.raises(ValueError):
        MidiFramer(strict=True).feed(bytes([0x42]))


# -- the native runtime ----------------------------------------------------------------


def test_native_builds_leave_csrc_untouched(built):
    """The library, the C bridge and the stub jackd build from csrc/ into
    the port's build directory, hash-keyed; csrc/ gains and changes
    nothing (no binary, no stamp)."""
    assert built["after"] == built["before"]
    assert set(built["before"]) >= {"blockio.cpp", "blockio.h",
                                    "jackbridge.cpp", "jackstub.cpp"}
    for path in built["paths"].values():
        assert Path(path).parent == built["dir"]
        assert re.search(r"_[0-9a-f]{16}(\.so)?$", str(path))
    assert sorted(p.name for p in built["dir"].iterdir()) == sorted(
        Path(p).name for p in built["paths"].values())
    # the default build directory is the git-ignored _build beside ops/
    from tpu_audio_torch.ops.cuda_build import BUILD_DIR
    assert BUILD_DIR == REPO / "tpu_audio_torch" / "_build"


def test_ring_roundtrip_wraparound_and_all_or_none(built):
    ring = native.NativeRing(1024)
    x = np.arange(256, dtype=np.float32)
    assert ring.write(x) and ring.readable == 256
    np.testing.assert_array_equal(ring.read(256), x)
    assert ring.read(1) is None
    ring.close()
    ring = native.NativeRing(100)
    for rep in range(10):
        x = np.full(60, float(rep), np.float32)
        assert ring.write(x)
        np.testing.assert_array_equal(ring.read(60), x)
    assert ring.write(np.zeros(90, np.float32))
    assert not ring.write(np.zeros(20, np.float32))   # would overflow
    assert ring.readable == 90 and ring.writable == 10
    assert ring.read(100) is None                     # not enough data
    assert ring.read(90) is not None
    ring.close()


def test_ring_shared_memory_across_handles(built):
    name = f"/tat_ring_{os.getpid()}_{np.random.randint(1e9)}"
    a = native.NativeRing(512, shm_name=name)
    b = native.NativeRing.open(name)
    x = np.random.default_rng(0).standard_normal(128).astype(np.float32)
    assert a.write(x)
    np.testing.assert_array_equal(b.read(128), x)
    b.close()
    a.close(unlink=True)
    with pytest.raises(RuntimeError, match="cannot open shm ring"):
        native.NativeRing.open(name)
    with pytest.raises(ValueError, match="closed"):   # never a null handle
        a.read(1)


def test_block_clock_paces_and_counts(built):
    clock = native.NativeBlockClock(0.002)
    t0 = time.perf_counter()
    for _ in range(10):
        clock.wait()
    assert time.perf_counter() - t0 >= 0.018
    assert clock.ticks == 10
    time.sleep(0.01)
    assert clock.wait() > 0 and clock.missed >= 1
    clock.close()


@pytest.mark.parametrize("stream", ["random", "flood", "system_common"])
def test_native_framer_matches_the_python_framer(built, stream):
    if stream == "random":
        data = _random_stream(1, 400)
        feeds = list(_chunks(data, 2))
    elif stream == "flood":
        # a 4096-byte running-status CC flood: the binding sizes its out
        # buffer to the 3n+260 worst case
        feeds = [bytes([0xB0]) + bytes(
            int(b) for p in range(2047) for b in (p % 120, (p * 7) % 128))]
    else:
        feeds = [bytes([0xB0, 0x15, 0x40, 0xF1, 0x05, 0x16, 0x41, 0xB0,
                        0x17, 0x42, 0xF2, 0x01, 0x02, 0xF6, 0xF0, 0x01,
                        0xF7, 0x10, 0x20, 0x90, 0x40, 0x7F])]
    nat, py = native.NativeMidiFramer(), MidiFramer()
    got, want = [], []
    for chunk in feeds:
        got += nat.feed(chunk)
        want += py.feed(chunk)
    nat.close()
    assert got == want and len(want) > 5


def test_ring_source_and_sink(built):
    ring = native.NativeRing(2 * 2 * 32 * 2)
    sink, src = native.RingSink(ring), native.RingSource(ring, 2, 32)
    blocks = [np.random.default_rng(k).standard_normal((2, 2, 32)
                                                       ).astype(np.float32)
              for k in range(3)]
    sink.write(blocks[0])
    sink.write(blocks[1])
    sink.write(blocks[2])                 # full: dropped whole
    assert sink.dropped == 1
    np.testing.assert_array_equal(src.read(), blocks[0])
    np.testing.assert_array_equal(src.read(), blocks[1])
    assert src.read() is None             # non-blocking empty
    t0 = time.perf_counter()
    assert native.RingSource(ring, 2, 32, blocking=True,
                             max_empty_reads=20).read() is None
    assert time.perf_counter() - t0 >= 0.01
    ring.close()


# -- MIDI transports ---------------------------------------------------------------------


def test_midi_fifo_transport(built, tmp_path):
    from tpu_audio_torch.runtime.midi_transport import MidiByteStream

    fifo = tmp_path / "midi.fifo"
    os.mkfifo(fifo)
    wfd = os.open(fifo, os.O_RDWR | os.O_NONBLOCK)
    stream = MidiByteStream(fifo, device="hw:9,0")
    assert isinstance(stream.framer, native.NativeMidiFramer)
    assert stream.poll() == []
    os.write(wfd, bytes([0xB0, 21, 64, 22]))
    assert stream.poll() == [("hw:9,0", bytes([0xB0, 21, 64]))]
    os.write(wfd, bytes([100]))  # running status across polls
    assert stream.poll() == [("hw:9,0", bytes([0xB0, 22, 100]))]
    stream.close()
    os.close(wfd)
    python = MidiByteStream(os.open(os.devnull, os.O_RDONLY),
                            use_native=False)
    assert isinstance(python.framer, MidiFramer)


def test_midi_byte_stream_from_fd_and_read_error():
    from tpu_audio_torch.runtime.midi_transport import MidiByteStream

    r, w = os.pipe()
    stream = MidiByteStream(r, device="fd")
    os.write(w, bytes([0xB0, 0x15, 0x40]))
    assert stream.poll() == [("fd", bytes([0xB0, 0x15, 0x40]))]
    os.close(w)
    os.close(r)                       # a dead fd: read raises OSError
    assert stream.poll() == []        # warned, not raised


def test_alsa_rawmidi_path_convention(tmp_path):
    from tpu_audio_torch.runtime.midi_transport import (
        MidiByteStream, alsa_rawmidi_path, list_alsa_rawmidi,
        open_alsa_rawmidi,
    )

    assert alsa_rawmidi_path("hw:2,0") == "/dev/snd/midiC2D0"
    assert alsa_rawmidi_path("hw:11,3") == "/dev/snd/midiC11D3"
    assert alsa_rawmidi_path("hw:1") == "/dev/snd/midiC1D0"
    assert alsa_rawmidi_path("/custom/dev") == "/custom/dev"
    with pytest.raises(ValueError):
        alsa_rawmidi_path("usb:1")
    for name in ("midiC0D0", "midiC2D1", "pcmC0D0p"):
        (tmp_path / name).write_bytes(b"")
    assert list_alsa_rawmidi(str(tmp_path)) == ["hw:0,0", "hw:2,1"]
    assert list_alsa_rawmidi(str(tmp_path / "missing")) == []
    dev = tmp_path / "midiC9D0"
    dev.write_bytes(bytes([0xB0, 0x15, 0x40, 0x16, 0x7F]))
    stream = MidiByteStream(str(dev), device="hw:9,0")
    events = stream.poll()
    stream.close()
    assert events == [("hw:9,0", bytes([0xB0, 0x15, 0x40])),
                      ("hw:9,0", bytes([0xB0, 0x16, 0x7F]))]
    with pytest.raises(FileNotFoundError):
        open_alsa_rawmidi("hw:99,0")


# -- live MIDI in the session ------------------------------------------------------------


def _small_model(jax_side, voices=1, mapping=None, engine="fmajor"):
    rng = np.random.default_rng(2)
    bank = JaxIRBank() if jax_side else IRBank()
    for _ in range(2):
        ir = rng.standard_normal((2, 96)).astype(np.float32)
        bank.append(ir * (0.4 / np.abs(ir).max()))
    if jax_side:
        model = JaxReverb(bank, num_voices=voices, block=32, max_predelay=64,
                          backend="fft")
    else:
        model = ConvolutionReverb(bank, num_voices=voices, block=32,
                                  max_predelay=64, device="cpu",
                                  engine=engine)
    cls = JaxCCMapping if jax_side else CCMapping
    for v in range(voices):
        for ch in range(2):
            model.control.set_mapping(v, ch, cls(
                message=0xB0, select=0x15, dry=0x17, wet=0x18,
                **(mapping(v) if mapping else {})))
    model.control.speed[:] = 6
    return model


class _ScriptedLive:
    """A live MIDI source releasing events at given polls (one poll per
    block), recording the block at which each poll returned events."""

    def __init__(self, by_poll):
        self.by_poll = dict(by_poll)
        self.polls = 0
        self.applied = []

    def poll(self):
        events = self.by_poll.get(self.polls, [])
        if events:
            self.applied += [(self.polls, dev, msg) for dev, msg in events]
        self.polls += 1
        return events


def test_live_midi_equals_the_same_events_scheduled():
    """Events polled live land at block boundaries exactly like a
    MidiSchedule at the blocks where they applied (a select, a wet change
    mid-fade, a dry change), in the port to the bit and against the JAX
    session within 2e-5."""
    by_poll = {3: [("", bytes([0xB0, 0x15, 100]))],
               5: [("", bytes([0xB0, 0x18, 40])),
                   ("", bytes([0xB0, 0x17, 90]))]}
    x = (np.random.default_rng(4).standard_normal((1, 2, 32 * 24)) * 0.05
         ).astype(np.float32)
    outs, applied = {}, []
    for label in ("live", "scheduled", "jax"):
        jax_side = label == "jax"
        model = _small_model(jax_side)
        sink = (JaxWavSink if jax_side else WavSink)("/dev/null",
                                                     keep_data=True)
        src = (JaxWavSource if jax_side else WavSource)(x, 1, 32)
        session = model.session(src, sink, warmup=0)
        live = _ScriptedLive(by_poll)
        if label == "scheduled":
            session.run(model.init_state(), midi=MidiSchedule(applied))
        else:
            session.run(model.init_state(), live_midi=live)
        if label == "live":
            applied = live.applied
            assert [b for b, _, _ in applied] == [3, 5, 5]
            assert live.polls == 24
        outs[label] = sink.data
        assert model.control.select[0, 0] == 1
    np.testing.assert_array_equal(outs["live"], outs["scheduled"])
    np.testing.assert_allclose(outs["live"], outs["jax"], atol=2e-5)


def test_multi_midi_fifo_routes_by_device(built, tmp_path):
    """Two FIFO devices drive different voices of one session, routed by
    CCMapping.device (the reference's one reader per ALSA device,
    src/main.cu:47-48), through MultiMidiStream."""
    from tpu_audio_torch.runtime.midi_transport import (
        MidiByteStream, MultiMidiStream,
    )

    wfds, streams = [], []
    for i, dev in enumerate(["hw:1,0", "hw:2,0"]):
        path = tmp_path / f"midi{i}.fifo"
        os.mkfifo(path)
        wfds.append(os.open(path, os.O_RDWR | os.O_NONBLOCK))
        streams.append(MidiByteStream(path, device=dev))
    multi = MultiMidiStream(streams)
    model = _small_model(False, voices=2,
                         mapping=lambda v: {"device": f"hw:{v + 1},0"})
    model.control.dry[:] = 0.0
    os.write(wfds[0], bytes([0xB0, 0x17, 64]))     # hw:1,0 -> dry 0.5
    os.write(wfds[1], bytes([0xB0, 0x17, 127]))    # hw:2,0 -> dry ~0.99
    x = (np.random.default_rng(3).standard_normal((2, 2, 32 * 4)) * 0.05
         ).astype(np.float32)
    session = model.session(WavSource(x, 2, 32),
                            WavSink("/dev/null", keep_data=True), warmup=0)
    session.run(model.init_state(), live_midi=multi)
    assert model.control.dry[0, 0] == np.float32(64 / 128.0)
    assert model.control.dry[1, 0] == np.float32(127 / 128.0)
    multi.close()
    for fd in wfds:
        os.close(fd)


def test_session_native_clock_paces_and_reports(built):
    model = _small_model(False)
    x = np.zeros((1, 2, 32 * 12), np.float32)
    session = model.session(WavSource(x, 1, 32),
                            WavSink("/dev/null", keep_data=True),
                            realtime=True, clock="native")
    t0 = time.perf_counter()
    session.run(model.init_state())
    assert time.perf_counter() - t0 >= 11 * session.block_period
    assert session.clock_used == "native" and session.clock_ticks == 12
    with pytest.raises(ValueError, match="unknown clock"):
        model.session(WavSource(x, 1, 32), WavSink("/dev/null"),
                      clock="jack")


def test_ring_sink_queues_its_latency_ahead_of_the_first_block(built):
    """RingSink(latency_blocks=3) puts three silent blocks into the ring
    just before the first block and none before later ones; RingSource's
    backlog counts the whole blocks waiting in its ring."""
    ring = native.NativeRing(8 * 2 * 2 * 32)
    sink, src = (native.RingSink(ring, latency_blocks=3),
                 native.RingSource(ring, 2, 32))
    assert src.backlog() == 0
    blocks = [np.random.default_rng(k).standard_normal((2, 2, 32)
                                                       ).astype(np.float32)
              for k in range(2)]
    sink.write(blocks[0])
    assert src.backlog() == 4
    sink.write(blocks[1])
    assert src.backlog() == 5 and sink.dropped == 0
    for _ in range(3):
        np.testing.assert_array_equal(src.read(), np.zeros((2, 2, 32)))
    np.testing.assert_array_equal(src.read(), blocks[0])
    np.testing.assert_array_equal(src.read(), blocks[1])
    assert src.read() is None and src.backlog() == 0
    ring.write(np.ones(2 * 2 * 32 + 5, np.float32))   # a block and a part
    assert src.backlog() == 1
    ring.close()


class _CountingClock:
    """Stands in for the native clock of a realtime session and counts
    its waits."""

    def __init__(self):
        self.waits = self.ticks = self.missed = 0

    def wait(self):
        self.waits += 1
        return 0.0

    def close(self):
        pass


def test_realtime_session_takes_its_sources_backlog_at_once(built):
    """A realtime session waits for its clock only while its source's
    producer is not ahead of it: six blocks already waiting in a ring are
    taken back to back (one wait, after the last of them), a WAV source is
    paced after every block, and the two outputs are the same."""
    x = (np.random.default_rng(6).standard_normal((1, 2, 32 * 6)) * 0.05
         ).astype(np.float32)
    ring = native.NativeRing(8 * 2 * 32)
    for k in range(6):
        assert ring.write(np.ascontiguousarray(x[..., 32 * k: 32 * k + 32]))
    outs, waits = {}, {}
    for label, src in (("ring", native.RingSource(ring, 1, 32)),
                       ("wav", WavSource(x, 1, 32))):
        model = _small_model(False)
        sink = WavSink("/dev/null", keep_data=True)
        session = model.session(src, sink, warmup=0, realtime=True,
                                clock="native")
        clock = _CountingClock()
        session._open_clock = lambda clock=clock: clock
        session.run(model.init_state())
        assert session.blocks_streamed == 6
        outs[label], waits[label] = sink.data, clock.waits
    ring.close()
    assert waits == {"ring": 1, "wav": 6}
    np.testing.assert_array_equal(outs["ring"], outs["wav"])


@pytest.mark.parametrize("engine,chunk", [("fmajor", 1), ("fmajor", 2),
                                          ("partitioned", 1),
                                          ("monolithic", 1)])
def test_warm_up_leaves_the_stream_as_it_was(engine, chunk):
    """StreamSession.warm_up steps silence through every step of the
    session on a throwaway state: nothing reaches the sink, the control
    plane does not move, and the stream that follows (a select fading and
    a wet change, so the fade steps run too) is the same to the bit as the
    one of a session that was not warmed up."""
    by_poll = {3: [("", bytes([0xB0, 0x15, 100]))],
               5: [("", bytes([0xB0, 0x18, 40]))]}
    x = (np.random.default_rng(7).standard_normal((1, 2, 32 * 12)) * 0.05
         ).astype(np.float32)
    outs = {}
    for warm in (True, False):
        model = _small_model(False, engine=engine)
        sink = WavSink("/dev/null", keep_data=True)
        session = model.session(WavSource(x, 1, 32), sink, warmup=0,
                                chunk_blocks=chunk)
        if warm:
            blocks = model.control.blocks
            assert session.warm_up(model.init_state()) > 0
            assert sink.data.shape[-1] == 0
            assert model.control.blocks == blocks
        session.run(model.init_state(), live_midi=_ScriptedLive(by_poll))
        outs[warm] = sink.data
        assert model.control.select[0, 0] == 1
    assert outs[True].shape[-1] == 32 * 12
    np.testing.assert_array_equal(outs[True], outs[False])


# -- the JACK bridges --------------------------------------------------------------------


def _shm_pair(tag, floats):
    uid = f"{os.getpid()}_{np.random.randint(1e9)}"
    names = f"/tat_{tag}_in_{uid}", f"/tat_{tag}_out_{uid}"
    return names, [native.NativeRing(floats, shm_name=n) for n in names]


def test_c_bridge_end_to_end_against_the_stub_jackd(built, tmp_path):
    """The C bridge against the stub jackd: the capture pattern lands
    planar in the input ring, pre-queued output-ring audio reaches the
    playback ports then silence, the ports are wired under the server's
    assigned client name, and the counts are reported."""
    block, periods = 64, 6
    (in_name, out_name), (in_ring, out_ring) = _shm_pair(
        "c", 2 * block * (periods + 2))
    queued = [np.concatenate([np.full(block, 1.0 + p, np.float32),
                              np.full(block, -1.0 - p, np.float32)])
              for p in range(4)]
    for blk in queued:
        assert out_ring.write(blk)
    clog, dump = tmp_path / "connects.txt", tmp_path / "playback.f32"
    env = dict(os.environ, TPU_AUDIO_LIBJACK=built["paths"]["stub"],
               JACK_STUB_BLOCK=str(block), JACK_STUB_PERIODS=str(periods),
               JACK_STUB_PERIOD_US="2000", JACK_STUB_CONNECT_LOG=str(clog),
               JACK_STUB_DUMP=str(dump),
               JACK_STUB_ASSIGNED_NAME="tpu_audio-01",
               JACK_STUB_RAISE_ON_DONE="1")
    try:
        proc = subprocess.run(
            [built["paths"]["bridge"], "--in-ring", in_name, "--out-ring",
             out_name, "--expect-block", str(block), "--max-seconds", "10",
             "--connect-in", "mic:left", "--connect-in", "mic:right",
             "--connect-out", "spk:left", "--connect-out", "spk:right"],
            env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        stats = re.search(r"periods=(\d+) underruns=(\d+) overruns=(\d+)",
                          proc.stdout)
        assert stats and tuple(map(int, stats.groups())) == (
            periods, periods - 4, 0), proc.stdout
        for p in range(periods):
            got = in_ring.read(2 * block).reshape(2, block)
            np.testing.assert_array_equal(got[0], np.float32(0.25 + p))
            np.testing.assert_array_equal(got[1], np.float32(-0.5 - p))
        assert in_ring.read(1) is None
        played = np.fromfile(dump, np.float32).reshape(periods, 2 * block)
        np.testing.assert_array_equal(played[:4], np.stack(queued))
        np.testing.assert_array_equal(played[4:], 0.0)
        assert clog.read_text().splitlines() == [
            "mic:left -> tpu_audio-01:in_0", "tpu_audio-01:out_0 -> spk:left",
            "mic:right -> tpu_audio-01:in_1",
            "tpu_audio-01:out_1 -> spk:right"]
    finally:
        in_ring.close(unlink=True)
        out_ring.close(unlink=True)


@pytest.mark.parametrize("flag,stub_env,message", [
    ("--expect-block=256", {"JACK_STUB_BLOCK": "128"}, "garbles"),
    ("--expect-rate=44100", {"JACK_STUB_RATE": "48000"}, "pitch-shifted"),
])
def test_c_bridge_refuses_a_mismatched_server(built, flag, stub_env, message):
    (in_name, out_name), rings = _shm_pair("r", 1024)
    key, value = flag.split("=")
    try:
        proc = subprocess.run(
            [built["paths"]["bridge"], "--in-ring", in_name, "--out-ring",
             out_name, key, value, "--max-seconds", "1"],
            env=dict(os.environ, TPU_AUDIO_LIBJACK=built["paths"]["stub"],
                     **stub_env),
            capture_output=True, text=True, timeout=30)
        assert proc.returncode == 6 and message in proc.stderr
    finally:
        for ring in rings:
            ring.close(unlink=True)


def test_native_launcher_execs_the_c_bridge(built, tmp_path):
    """python -m tpu_audio_torch.runtime.jack_bridge --native resolves the
    ports from settings and execs the C bridge it builds."""
    (in_name, out_name), rings = _shm_pair("l", 4096)
    settings = tmp_path / "settings.txt"
    settings.write_text("conv[0].input mic:l\nconv[0].output spk:l\n"
                        "conv[1].input mic:r\nconv[1].output spk:r\n")
    clog = tmp_path / "connects.txt"
    env = dict(os.environ, TPU_AUDIO_LIBJACK=built["paths"]["stub"],
               JACK_STUB_BLOCK="256", JACK_STUB_PERIODS="2",
               JACK_STUB_RAISE_ON_DONE="1", JACK_STUB_CONNECT_LOG=str(clog),
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "tpu_audio_torch.runtime.jack_bridge",
             "--native", "--in-ring", in_name, "--out-ring", out_name,
             "--settings", str(settings), "--expect-block", "256"],
            env=env, capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        assert "periods=2" in proc.stdout
        assert clog.read_text().splitlines() == [
            "mic:l -> tpu_audio:in_0", "tpu_audio:out_0 -> spk:l",
            "mic:r -> tpu_audio:in_1", "tpu_audio:out_1 -> spk:r"]
    finally:
        for ring in rings:
            ring.close(unlink=True)


def _ctypes_bridge(monkeypatch, stub, **env):
    from tpu_audio_torch.runtime import jack_bridge as jb

    monkeypatch.setenv("TPU_AUDIO_LIBJACK", stub)
    for key, value in env.items():
        monkeypatch.setenv(key, str(value))
    monkeypatch.setattr(jb, "_LIB", None)
    monkeypatch.setattr(jb, "_LIB_TRIED", False)
    assert jb.jack_available()
    return jb


def test_ctypes_bridge_end_to_end_against_the_stub_jackd(built, tmp_path,
                                                         monkeypatch):
    block, periods = 64, 5
    dump, clog = tmp_path / "dump.f32", tmp_path / "connect.log"
    jb = _ctypes_bridge(monkeypatch, built["paths"]["stub"],
                        JACK_STUB_BLOCK=block, JACK_STUB_PERIODS=periods,
                        JACK_STUB_PERIOD_US=2000, JACK_STUB_DUMP=dump,
                        JACK_STUB_CONNECT_LOG=clog,
                        JACK_STUB_ASSIGNED_NAME="tpu_audio-01")
    in_ring = native.NativeRing(2 * block * (periods + 2))
    out_ring = native.NativeRing(2 * block * (periods + 2))
    queued = [np.concatenate([np.full(block, 0.5 + p, np.float32),
                              np.full(block, -1.0 - p, np.float32)])
              for p in range(2)]
    for q in queued:
        assert out_ring.write(q)
    bridge = jb.JackRingBridge(in_ring, out_ring, expect_block=block,
                               expect_rate=44100,
                               connect_inputs=["ext:cap_1", "ext:cap_2"],
                               connect_outputs=["ext:play_1", "ext:play_2"])
    assert bridge.name == "tpu_audio-01"
    bridge.start()
    deadline = time.time() + 10
    while in_ring.readable < 2 * block * periods and time.time() < deadline:
        time.sleep(0.01)
    bridge.stop()
    for p in range(periods):
        got = in_ring.read(2 * block).reshape(2, block)
        np.testing.assert_array_equal(got[0], np.float32(0.25 + p))
        np.testing.assert_array_equal(got[1], np.float32(-0.5 - p))
    assert (bridge.underruns, bridge.overruns) == (periods - 2, 0)
    played = np.fromfile(dump, np.float32).reshape(periods, 2 * block)
    np.testing.assert_array_equal(played[:2], np.stack(queued))
    np.testing.assert_array_equal(played[2:], 0.0)
    lines = clog.read_text().splitlines()
    assert "ext:cap_1 -> tpu_audio-01:in_0" in lines
    assert "tpu_audio-01:out_1 -> ext:play_2" in lines
    in_ring.close()
    out_ring.close()


@pytest.mark.parametrize("stub_env,kwargs,match", [
    ({"JACK_STUB_BLOCK": 128}, {"expect_block": 64}, "128 frames/period"),
    ({"JACK_STUB_RATE": 48000}, {"expect_rate": 44100}, "pitch-shifted"),
])
def test_ctypes_bridge_refuses_a_mismatched_server(built, monkeypatch,
                                                   stub_env, kwargs, match):
    jb = _ctypes_bridge(monkeypatch, built["paths"]["stub"], **stub_env)
    rings = [native.NativeRing(1024) for _ in range(2)]
    with pytest.raises(RuntimeError, match=match):
        jb.JackRingBridge(*rings, **kwargs)
    for ring in rings:
        ring.close()


def test_bridge_ports_from_settings():
    from tpu_audio_torch.io.settings import Settings
    from tpu_audio_torch.runtime.jack_bridge import ports_from_settings

    s = Settings().parse("conv[2].input mic:left\nconv[3].output spk:r\n")
    assert ports_from_settings(s, pair=1) == (
        ["mic:left", "system:capture_2"], ["system:playback_1", "spk:r"])


# -- the CLI -----------------------------------------------------------------------------


def _write_assets(tmp_path):
    from tpu_audio_torch.io.wav import write_wav

    rng = np.random.default_rng(1)
    ir = (rng.standard_normal((300, 2)) * 0.3).astype(np.float32)
    write_wav(tmp_path / "ir.wav", ir, 44100, bits=16)
    (tmp_path / "tiny.index").write_text("ir.wav\n")
    (tmp_path / "settings.txt").write_text(
        "conv.count 2\n"
        "conv[0].fftSize 2048\nconv[1].fftSize 2048\n"
        "conv[0].index tiny.index\nconv[1].index tiny.index\n"
        "conv[0].cc.message 176\nconv[1].cc.message 176\n"
        "conv[0].cc.wet 24\nconv[1].cc.wet 24\n"
        "conv[0].value.wet 0.9\nconv[1].value.wet 0.9\n"
        "conv[0].value.dry 0.2\nconv[1].value.dry 0.2\n")


def test_cli_streams_between_two_processes_until_enter(built, tmp_path):
    """The app (a second process) serves shm ring -> engine -> shm ring in
    real time on the native clock, with a live MIDI FIFO, until Enter; this
    process produces, consumes and presses Enter (the JAX package's
    tests/test_live_path.py:76-135 topology). The output ring starts with
    the app's default --output-latency of 4 silent blocks."""
    _write_assets(tmp_path)
    uid = f"{os.getpid()}_{np.random.randint(1e9)}"
    name_in, name_out = f"/tat_cli_in_{uid}", f"/tat_cli_out_{uid}"
    fifo = tmp_path / "midi.fifo"
    os.mkfifo(fifo)
    block, floats = 128, 2 * 128
    env = dict(os.environ, TPU_AUDIO_LOG="warn",
               PYTHONPATH=str(REPO) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    app = subprocess.Popen(
        [sys.executable, "-m", "tpu_audio_torch.app", "--device", "cpu",
         "--settings", str(tmp_path / "settings.txt"), "--root",
         str(tmp_path), "--input-ring", name_in, "--output-ring", name_out,
         "--block-size", str(block), "--realtime", "--clock", "native",
         "--midi-fifo", f"hw:0,0={fifo}", "--until-enter", "--quiet"],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(tmp_path))
    got = []
    try:
        rings, deadline = {}, time.time() + 120
        while len(rings) < 2:
            for name in (name_in, name_out):
                if name not in rings:
                    try:
                        rings[name] = native.NativeRing.open(name)
                    except RuntimeError:
                        pass
            assert app.poll() is None, app.communicate()
            assert time.time() < deadline, "the app never created its rings"
            time.sleep(0.02)
        while True:   # the app opens its FIFO reader just after the rings
            try:
                wfd = os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
                break
            except OSError:
                assert time.time() < deadline
                time.sleep(0.02)
        os.write(wfd, bytes([0xB0, 24, 20]))
        os.close(wfd)
        rng = np.random.default_rng(0)
        sent = 0
        while len(got) < 4 + 30 and time.time() < deadline:
            if sent < 40 and rings[name_in].write(
                    (rng.standard_normal(floats) * 0.1).astype(np.float32)):
                sent += 1
            data = rings[name_out].read(floats)
            if data is not None:
                got.append(data.reshape(1, 2, block))
            else:
                time.sleep(0.002)
        app.stdin.write("\n")
        app.stdin.flush()
        out, err = app.communicate(timeout=60)
        for ring in rings.values():
            ring.close()
    finally:
        if app.poll() is None:
            app.kill()
            app.communicate()
    assert app.returncode == 0, (out, err)
    assert len(got) == 4 + 30
    assert not np.concatenate(got[:4]).any()
    audio = np.concatenate(got[4:], axis=-1)
    assert np.isfinite(audio).all() and np.abs(audio).max() > 1e-4
    summary = re.search(r"streamed (\d+) blocks .*\| missed \d+ \| underruns "
                        r"\d+ \| dropped (\d+)", out)
    assert summary and int(summary.group(1)) >= 30, out
    # the rings are unlinked when the app exits
    for name in (name_in, name_out):
        with pytest.raises(RuntimeError):
            native.NativeRing.open(name)


def test_cli_refuses_live_inputs_offline_and_rings_without_native(
        tmp_path, monkeypatch):
    from tpu_audio_torch.app.main import main as port_main

    _write_assets(tmp_path)
    common = ["--settings", str(tmp_path / "settings.txt"), "--root",
              str(tmp_path), "--block-size", "64", "--quiet", "--device",
              "cpu"]
    for live in (["--input-ring", "x"], ["--output-ring", "y"],
                 ["--midi-fifo", "z"], ["--realtime"]):
        assert port_main(common + ["--offline"] + live) == 2
    monkeypatch.setattr(native, "native_available", lambda: False)
    assert port_main(common + ["--input-ring", f"/tat_never_{os.getpid()}"]
                     ) == 2
