"""Real FFT transforms (port of tpu_audio/ops/fft.py:SpectralTransform).

The JAX package offers DFT-as-matmul and four-step "split" backends because
the TPU has no FFT unit. A GPU has one in cuFFT, which torch.fft calls, so
the port keeps only the plain transform.
"""

from __future__ import annotations

import torch


class SpectralTransform:
    """Static-size rfft/irfft over the last axis: [..., n] <-> [..., n//2+1]."""

    def __init__(self, n: int):
        if n & (n - 1):
            raise ValueError(f"fft size must be a power of two, got {n}")
        self.n = n
        self.num_bins = n // 2 + 1

    def rfft(self, x: torch.Tensor) -> torch.Tensor:
        """float32 [..., n] -> complex64 [..., n//2+1]."""
        return torch.fft.rfft(x, n=self.n, dim=-1)

    def irfft(self, spec: torch.Tensor) -> torch.Tensor:
        """complex64 [..., n//2+1] -> float32 [..., n]."""
        return torch.fft.irfft(spec, n=self.n, dim=-1)

    def __repr__(self):
        return f"SpectralTransform(n={self.n})"
