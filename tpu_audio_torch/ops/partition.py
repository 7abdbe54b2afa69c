"""IR partitioning and spectra precompute (port of tpu_audio/ops/partition.py,
numpy backend), and the monolithic engine's single spectrum.

Uniform partitioned overlap-save: the IR is split into P = ceil(L / B)
block-sized partitions, each zero-padded to N = 2B and transformed once at
load time; per block the engine pays two small-N transforms plus a
frequency-domain MAC over the partition axis. Spectra layout: [..., P, F]
complex64 with F = N//2 + 1.
"""

from __future__ import annotations

import numpy as np


def num_partitions(ir_len: int, block: int) -> int:
    return max(1, -(-ir_len // block))


def partition_ir(ir: np.ndarray, block: int, max_partitions: int | None = None,
                 ) -> np.ndarray:
    """Split a time-domain IR [..., L] into zero-padded partitions
    [..., P, 2*block] (each partition holds `block` IR samples followed by
    `block` zeros, the overlap-save layout)."""
    ir = np.asarray(ir, dtype=np.float32)
    length = ir.shape[-1]
    p = num_partitions(length, block)
    if max_partitions is not None:
        p = min(p, max_partitions)
    padded = np.zeros(ir.shape[:-1] + (p * block,), np.float32)
    keep = min(length, p * block)
    padded[..., :keep] = ir[..., :keep]
    parts = padded.reshape(ir.shape[:-1] + (p, block))
    return np.concatenate(
        [parts, np.zeros(ir.shape[:-1] + (p, block), np.float32)], axis=-1)


def partition_spectra(ir: np.ndarray, block: int,
                      max_partitions: int | None = None) -> np.ndarray:
    """Time-domain IR [..., L] -> partition spectra [..., P, F] complex64
    (one host FFT pass per bank load)."""
    parts = partition_ir(ir, block, max_partitions)
    return np.fft.rfft(parts, axis=-1).astype(np.complex64)


def monolithic_spectrum(ir: np.ndarray, fft_size: int, reserve: int = 1024,
                        ) -> np.ndarray:
    """Reference-style single spectrum: IR truncated to fft_size - reserve
    frames (reference src/conv.cu:239, default nframes=1024 src/conv.h:63),
    zero-padded to fft_size, full complex spectrum [..., fft_size]."""
    ir = np.asarray(ir, dtype=np.float32)
    keep = min(ir.shape[-1], fft_size - reserve)
    padded = np.zeros(ir.shape[:-1] + (fft_size,), np.float32)
    padded[..., :keep] = ir[..., :keep]
    return np.fft.fft(padded, axis=-1).astype(np.complex64)
