"""16-bit PCM wire format for audio blocks (port of tpu_audio/utils/wire.py).

The engine computes f32 throughout. The offline bounce can hand its output
back as 16-bit PCM (``render_offline(wire="pcm16")``): encoded on the
device, decoded on the host, so the caller sees f32 values quantized to
1/32767 — the values a 16-bit WAV of the bounce holds.
"""

from __future__ import annotations

import numpy as np
import torch

PCM16_SCALE = 32767.0


def encode_pcm16(x: torch.Tensor) -> torch.Tensor:
    """f32 [-1, 1] -> int16, on the tensor's device.

    Round-to-nearest (half to even): half-LSB worst-case quantization error
    (a bare int16 cast truncates toward zero — double the error, and a
    DC-shaped one around zero)."""
    return torch.round(torch.clamp(x, -1.0, 1.0) * PCM16_SCALE).to(torch.int16)


def decode_pcm16(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """int16 -> f32 (host-side, after the transfer) in one pass, into `out`
    (any f32 view of x's shape) when given: the JAX package's values, each
    int16 converted to f32 and divided by 32767 in f32."""
    return np.divide(x, np.float32(PCM16_SCALE), out=out, dtype=np.float32)
