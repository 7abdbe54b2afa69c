"""Audio block transport: sources and sinks (port of
tpu_audio/runtime/backends.py: WAV files, synthetic signals, Python
callbacks, a loopback buffer, a null sink; the shared-memory rings of live
processes are runtime/native.py's RingSource and RingSink).

The reference's audio I/O is a JACK client whose RT thread pushes 256-frame
buffers into ``onProcess`` (reference src/jackclient.h:56, src/jackclient.cu:
4-11). That seam — "someone hands the engine fixed-size blocks and takes
fixed-size blocks back" — is the backend interface here. All blocks are
float32 numpy arrays of shape [V, 2, B] (V voices, stereo, B frames); the
session moves them to and from the device.
"""

from __future__ import annotations

import numpy as np

from tpu_audio_torch.io.wav import WavWriter, read_wav


class BlockSource:
    """Produces [V, 2, B] blocks; returns None when exhausted."""

    def read(self) -> np.ndarray | None:
        raise NotImplementedError

    def backlog(self) -> int:
        """Blocks that a producer running on its own clock has already
        delivered and that read() has not taken. A realtime session does
        not wait for its own clock while this is above 0: it is behind that
        producer. A source with no such producer returns 0."""
        return 0


class BlockSink:
    """Consumes [V, 2, B] blocks."""

    def write(self, block: np.ndarray) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class WavSource(BlockSource):
    """Streams a WAV file (or array) as blocks, tiled across V voices.

    The file's stereo frames feed every voice (the common bench setup:
    V independent reverb voices processing the same program material), or
    per-voice material may be supplied as an array of shape [V, 2, T].
    """

    def __init__(self, path_or_array, num_voices: int, block: int,
                 loop: bool = False, gain: float = 1.0,
                 max_blocks: int | None = None, scale: str = "reference"):
        if isinstance(path_or_array, (str, bytes)) or hasattr(path_or_array, "__fspath__"):
            wav = read_wav(path_or_array, scale=scale, verbose=False)
            data = wav.stereo().T[None]  # [1, 2, T]
            self.sample_rate = wav.sample_rate
        else:
            data = np.asarray(path_or_array, dtype=np.float32)
            if data.ndim == 2:
                data = data[None]
            self.sample_rate = None
        if data.shape[0] not in (1, num_voices):
            raise ValueError(f"source has {data.shape[0]} voices, need {num_voices}")
        # shared program material STAYS [1, 2, T]: materializing the
        # V-voice broadcast costs num_voices x the file size in host RAM
        # (a 60 s stereo file at 1024 voices would be ~21 GB); read()
        # broadcasts each block instead
        self.data = np.ascontiguousarray(data * gain, dtype=np.float32)
        self.num_voices = num_voices
        self.block = block
        self.loop = loop
        self.max_blocks = max_blocks
        self._pos = 0
        self._emitted = 0

    def seek(self, block_index: int) -> None:
        """Reposition to a block boundary (exact checkpoint resume:
        run_resilient replays from the last checkpoint; live sources cannot
        seek and simply continue, accepting the outage gap)."""
        if self.loop:
            total = self.data.shape[-1]
            self._pos = (block_index * self.block) % max(total, 1)
        else:
            self._pos = block_index * self.block
        self._emitted = block_index

    def read(self) -> np.ndarray | None:
        if self.max_blocks is not None and self._emitted >= self.max_blocks:
            return None
        t = self.data.shape[-1]
        if self._pos >= t:
            if not self.loop:
                return None
            self._pos = 0
        out = np.zeros((self.num_voices,) + self.data.shape[1:-1]
                       + (self.block,), np.float32)
        filled = 0
        while filled < self.block:
            end = min(self._pos + (self.block - filled), t)
            n = end - self._pos
            if n <= 0:
                break
            out[..., filled:filled + n] = self.data[..., self._pos:end]
            filled += n
            self._pos = end
            if self._pos >= t and self.loop:
                self._pos = 0
            elif self._pos >= t:
                break  # final partial block is zero-padded
        self._emitted += 1
        return out


class SilenceSource(BlockSource):
    def __init__(self, num_voices: int, block: int, num_blocks: int):
        self.shape = (num_voices, 2, block)
        self.remaining = num_blocks

    def read(self):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        return np.zeros(self.shape, np.float32)


class NoiseSource(BlockSource):
    def __init__(self, num_voices: int, block: int, num_blocks: int,
                 amplitude: float = 0.1, seed: int = 0):
        self.shape = (num_voices, 2, block)
        self.remaining = num_blocks
        self.amplitude = amplitude
        self.rng = np.random.default_rng(seed)

    def read(self):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        return (self.rng.standard_normal(self.shape) * self.amplitude
                ).astype(np.float32)


class ImpulseSource(BlockSource):
    """A single unit impulse in block 0, then silence — streams the IR out."""

    def __init__(self, num_voices: int, block: int, num_blocks: int,
                 amplitude: float = 1.0):
        self.shape = (num_voices, 2, block)
        self.remaining = num_blocks
        self.amplitude = amplitude
        self._first = True

    def read(self):
        if self.remaining <= 0:
            return None
        self.remaining -= 1
        out = np.zeros(self.shape, np.float32)
        if self._first:
            out[..., 0] = self.amplitude
            self._first = False
        return out


class CallbackSource(BlockSource):
    def __init__(self, fn):
        self.fn = fn

    def read(self):
        return self.fn()


class CallbackSink(BlockSink):
    def __init__(self, fn):
        self.fn = fn

    def write(self, block):
        self.fn(block)


class NullSink(BlockSink):
    def write(self, block):
        pass


class WavSink(BlockSink):
    """Streams blocks to WAV file(s) incrementally — O(block) memory, so a
    long-running server session never grows the host footprint (the
    RIFF/data sizes are patched on close, see io.wav.WavWriter).

    voice=None writes voice 0 (the mono-server case); voice="all" writes one
    file per voice with a _vNNN suffix; an int selects one voice.
    ``keep_data=True`` additionally buffers every block in RAM and exposes
    ``.data`` — for tests and short offline renders only (unbounded).
    """

    def __init__(self, path, sample_rate: int = 44100, voice=None,
                 bits: int = 16, scale: str = "full",
                 keep_data: bool = False):
        self.path = str(path)
        self.sample_rate = sample_rate
        self.voice = 0 if voice is None else voice
        self.bits = bits
        self.scale = scale
        self._writers: list[tuple[int, WavWriter]] | None = None
        self._blocks: list[np.ndarray] | None = [] if keep_data else None

    def _open(self, num_voices: int) -> None:
        if self.voice == "all":
            import os
            # splitext, not str.replace: a suffix-less path (or a ".wav"
            # inside a directory component) would otherwise open the SAME
            # file for every voice, corrupting all of them
            root, ext = os.path.splitext(self.path)
            self._writers = []
            for v in range(num_voices):
                path = f"{root}_v{v:03d}{ext or '.wav'}"
                self._writers.append((v, WavWriter(
                    path, self.sample_rate, 2, self.bits, self.scale)))
        else:
            self._writers = [(self.voice, WavWriter(
                self.path, self.sample_rate, 2, self.bits, self.scale))]

    def write(self, block):
        block = np.asarray(block)
        if self._writers is None:
            self._open(block.shape[0])
        for v, writer in self._writers:
            writer.write(block[v].T)
        if self._blocks is not None:
            self._blocks.append(block)

    @property
    def data(self) -> np.ndarray:
        """[V, 2, T] accumulated output (requires keep_data=True)."""
        if self._blocks is None:
            raise RuntimeError("WavSink streams to disk; pass keep_data=True "
                               "to also buffer blocks in memory")
        if not self._blocks:
            return np.zeros((1, 2, 0), np.float32)
        return np.concatenate(self._blocks, axis=-1)

    def close(self):
        if self._writers is None and self.voice != "all":
            # zero blocks streamed: still produce a valid (empty) WAV, as
            # the pre-streaming implementation did
            self._open(1)
        for _, writer in self._writers or ():
            writer.close()


class LoopbackBuffer(BlockSink):
    """Sink that re-serves written blocks as a source (pipeline tests)."""

    def __init__(self):
        self._queue: list[np.ndarray] = []

    def write(self, block):
        self._queue.append(np.asarray(block).copy())

    def as_source(self) -> BlockSource:
        queue = self._queue

        class _Src(BlockSource):
            def read(self):
                return queue.pop(0) if queue else None

        return _Src()
