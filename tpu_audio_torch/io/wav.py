"""WAV file ingest and export (port of tpu_audio/io/wav.py: numpy, the
same decoded arrays bit for bit).

Capability equivalent of the reference's IR loader (reference src/wav.cu:46-118
plus GPU convert kernels src/wav.cu:4-44), redesigned host-side: sample-format
conversion is a vectorised numpy transform done once at load time (IR files
are loaded once and live in device memory as precomputed spectra — there is nothing to
gain from converting PCM on the accelerator), while all per-block DSP stays
on-device.

Scaling semantics (``scale="reference"``, the default) match the reference
exactly, including its built-in 6 dB headroom:
  - 16-bit: sample / 65536            (reference src/wav.cu:13 — NOT /32768)
  - 24-bit: sample24 / 16777216       (reference src/wav.cu:27-41 — NOT /2^23)
so full-scale PCM maps to [-0.5, 0.5). ``scale="full"`` maps to [-1, 1).

Robustness beyond the reference: proper RIFF chunk walking (the reference
assumes fmt is chunk 2 and data is chunk 3, src/wav.cu:71-85), support for
mono/N-channel files and 32-bit int / IEEE float formats (the reference
asserts stereo 16/24-bit only, src/wav.cu:105-113).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from tpu_audio_torch.utils.log import Log

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavFile:
    """Decoded WAV: float32 frames of shape [num_frames, num_channels]."""

    path: str
    sample_rate: int
    frames: np.ndarray  # float32 [num_frames, num_channels]

    @property
    def num_frames(self) -> int:
        return self.frames.shape[0]

    @property
    def num_channels(self) -> int:
        return self.frames.shape[1]

    @property
    def duration_s(self) -> float:
        return self.num_frames / self.sample_rate

    def stereo(self) -> np.ndarray:
        """[num_frames, 2] view: mono is duplicated, >2ch is truncated."""
        if self.num_channels == 2:
            return self.frames
        if self.num_channels == 1:
            return np.repeat(self.frames, 2, axis=1)
        return self.frames[:, :2]


def _decode_pcm(raw: bytes, bits: int, block_align: int, channels: int,
                audio_format: int, scale: str) -> np.ndarray:
    headroom = 0.5 if scale == "reference" else 1.0
    if audio_format == WAVE_FORMAT_IEEE_FLOAT:
        # honour bits-per-sample: parsing an f64 file as f4 halves would
        # silently load the IR as noise at twice the frame count
        if bits == 32:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            data = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(
                f"unsupported IEEE-float bits-per-sample: {bits}")
        out = data * (headroom / 1.0)
    elif bits == 16:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        # reference scale: v / 65536 == (v / 32768) * 0.5 (src/wav.cu:13)
        out = data * (headroom / 32768.0)
    elif bits == 24:
        u8 = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3).astype(np.uint32)
        # sign-extend 24-bit little-endian, then scale by 2^23 (src/wav.cu:27-41:
        # ((b0<<8|b1<<16|b2<<24) as i32) / 256 / 16777216 == v24 / 2^24)
        v = (u8[:, 0] | (u8[:, 1] << 8) | (u8[:, 2] << 16)).astype(np.int32)
        v = (v << 8) >> 8
        out = v.astype(np.float32) * (headroom / 8388608.0)
    elif bits == 32:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        out = data * (headroom / 2147483648.0)
    elif bits == 8:
        data = np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
        out = data * (headroom / 128.0)
    else:
        raise ValueError(f"unsupported bits-per-sample: {bits}")
    n_frames = len(out) // channels
    return out[: n_frames * channels].reshape(n_frames, channels)


def read_wav(path: str | os.PathLike, scale: str = "reference",
             verbose: bool = True) -> WavFile:
    """Parse a RIFF/WAVE file into float32 frames."""
    path = os.fspath(path)
    with open(path, "rb") as fh:
        blob = fh.read()
    if len(blob) < 12 or blob[0:4] != b"RIFF" or blob[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    fmt = None
    data = None
    pos = 12
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        (csize,) = struct.unpack_from("<I", blob, pos + 4)
        body = blob[pos + 8: pos + 8 + csize]
        if cid == b"fmt ":
            (audio_format, channels, sample_rate, byte_rate, block_align,
             bits) = struct.unpack_from("<HHIIHH", body, 0)
            if audio_format == WAVE_FORMAT_EXTENSIBLE and csize >= 26:
                # true format lives in the first 2 bytes of the SubFormat GUID
                (audio_format,) = struct.unpack_from("<H", body, 24)
            fmt = (audio_format, channels, sample_rate, byte_rate, block_align, bits)
        elif cid == b"data":
            data = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned

    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, byte_rate, block_align, bits = fmt
    if audio_format not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
        raise ValueError(f"{path}: unsupported audio format {audio_format}")

    frames = _decode_pcm(data, bits, block_align, channels, audio_format, scale)
    if verbose:
        Log.info("wav", "IR [%0.2f s] %s",
                 len(data) / max(byte_rate, 1), path)
    return WavFile(path=path, sample_rate=sample_rate, frames=frames)


def wav_sample_rate(path: str | os.PathLike) -> int:
    """Read just the fmt chunk's sample rate (no payload load) — the CLI
    probes the input's rate before building the model, and inputs can be
    hours long."""
    path = os.fspath(path)
    with open(path, "rb") as fh:
        head = fh.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: missing fmt chunk")
            cid, csize = hdr[0:4], struct.unpack("<I", hdr[4:8])[0]
            if cid == b"fmt ":
                body = fh.read(min(csize, 16))
                return struct.unpack_from("<HHI", body, 0)[2]
            fh.seek(csize + (csize & 1), os.SEEK_CUR)


def encode_frames(x: np.ndarray, bits: int) -> bytes:
    """Encode float frames [n, ch] to the PCM16/PCM24/float32 payload."""
    if bits == 16:
        return np.clip(np.round(x * 32768.0), -32768, 32767).astype(
            "<i2").tobytes()
    if bits == 24:
        v = np.clip(np.round(x * 8388608.0), -8388608, 8388607).astype(np.int32)
        u = v.astype(np.uint32).reshape(-1)
        b = np.empty((u.size, 3), dtype=np.uint8)
        b[:, 0] = u & 0xFF
        b[:, 1] = (u >> 8) & 0xFF
        b[:, 2] = (u >> 16) & 0xFF
        return b.tobytes()
    if bits == 32:
        return x.astype("<f4").tobytes()
    raise ValueError(f"unsupported bits: {bits}")


class WavWriter:
    """Incremental WAV writer: header first, frames appended as they arrive,
    RIFF/data sizes patched on close — O(block) memory for arbitrarily long
    sessions (the reference streams to JACK and never buffers either)."""

    def __init__(self, path: str | os.PathLike, sample_rate: int,
                 channels: int, bits: int = 16, scale: str = "full"):
        self.bits = bits
        self.channels = channels
        self._gain = 2.0 if scale == "reference" else 1.0
        self._payload_bytes = 0
        audio_format = (WAVE_FORMAT_IEEE_FLOAT if bits == 32
                        else WAVE_FORMAT_PCM)
        block_align = channels * (bits // 8)
        self._fh = open(path, "wb")
        self._fh.write(b"RIFF")
        self._fh.write(struct.pack("<I", 36))
        self._fh.write(b"WAVE")
        self._fh.write(b"fmt ")
        self._fh.write(struct.pack("<IHHIIHH", 16, audio_format, channels,
                                   sample_rate, sample_rate * block_align,
                                   block_align, bits))
        self._fh.write(b"data")
        self._fh.write(struct.pack("<I", 0))

    # RIFF sizes are u32: past this, close() could not write a valid
    # header (and would corrupt hours of already-recorded audio at the
    # very end of a session — ~6.8 h of stereo PCM16 at 44.1 kHz)
    _MAX_PAYLOAD = 0xFFFFFFFF - 36

    def write(self, frames: np.ndarray) -> None:
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 1:
            frames = frames[:, None]
        if frames.shape[1] != self.channels:
            raise ValueError(f"got {frames.shape[1]} channels, "
                             f"writer opened with {self.channels}")
        payload = encode_frames(frames * self._gain, self.bits)
        if self._payload_bytes + len(payload) > self._MAX_PAYLOAD:
            if not getattr(self, "_overflow_warned", False):
                self._overflow_warned = True
                Log.warn("wav", "RIFF 4 GiB payload limit reached; "
                         "dropping further frames (the file stays valid — "
                         "rotate the output for longer sessions)")
            return
        self._fh.write(payload)
        self._payload_bytes += len(payload)

    def close(self) -> None:
        if self._fh is None:
            return
        try:
            if self._fh.seekable():
                self._fh.seek(4)
                self._fh.write(struct.pack("<I", 36 + self._payload_bytes))
                self._fh.seek(40)
                self._fh.write(struct.pack("<I", self._payload_bytes))
        finally:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_wav(path: str | os.PathLike, frames: np.ndarray, sample_rate: int,
              bits: int = 16, scale: str = "full") -> None:
    """Write float32 frames [n, ch] as PCM16/PCM24/float32 WAV.

    ``scale="reference"`` applies the inverse of the reader's headroom scaling
    so a reference-scaled read/write round-trips.
    """
    frames = np.asarray(frames, dtype=np.float32)
    if frames.ndim == 1:
        frames = frames[:, None]
    with WavWriter(path, sample_rate, frames.shape[1], bits, scale) as w:
        w.write(frames)
