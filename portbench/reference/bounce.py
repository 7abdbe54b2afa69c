"""The plain reference of the offline bounce: one voice's whole track and
its tail, in float64 PyTorch on the CPU, then rounded onto the 16-bit
output grid.

It imports torch and numpy alone: nothing of JAX, of the JAX package or of
the port. Its algorithm is neither the port's (segments of virtual voices,
uniformly partitioned overlap-save) nor reference/convolve.py's (the same
partitions block by block): each input channel is transformed once by one
FFT at least as long as the whole linear convolution, multiplied by the
transforms of its selected IR's output channels, and transformed back.
The law around the convolution is convolve.py's: the wet sum of both input
channels, each with its wet gain, wet pan and level, delayed by the
predelay and clamped to [-1, 1]; the dry sum of both channels, each with
its dry gain, dry pan and level, added after the clamp. The output is as
long as the port's bounce with its tail; past the end of the convolution
it holds the dry signal alone (zero past the stem).

The 16-bit output wire: clamp to [-1, 1], times 32767, round half to even,
as the port's encoder does, in the precision of the values given (float32
values round as the port rounds them, float64 ones at their exact
product); the decode divides in float32.

A ``quantize`` function (reference/precision.py), applied to the real and
imaginary parts of both operands of every spectral product, turns the same
computation into a control in a lower precision.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.convolve import pan_gains

PCM16_SCALE = 32767.0

# full float64 products on every device: no TF32 anywhere in the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def encode_pcm16(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> int16: clamp, times 32767, round half to even, in x's
    dtype."""
    return torch.round(torch.clamp(x, -1.0, 1.0) * PCM16_SCALE).to(
        torch.int16)


def decode_pcm16(k: torch.Tensor) -> torch.Tensor:
    """int16 -> float32, divided in float32."""
    return k.to(torch.float32) / torch.tensor(PCM16_SCALE,
                                              dtype=torch.float32)


def fast_length(n: int) -> int:
    """The least 2^a 3^b 5^c >= n: an FFT length the transforms take
    quickly."""
    best = 1 << max(n - 1, 0).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def _quantized(z: torch.Tensor, quantize) -> torch.Tensor:
    if quantize is None:
        return z
    return torch.complex(torch.from_numpy(quantize(z.real.numpy())),
                         torch.from_numpy(quantize(z.imag.numpy())))


class BounceReference:
    """Renders whole tracks of single voices.

    `irs` [K, 2, L]: the bank as the benchmark made it. `params`: wet,
    dry, predelay (samples), pan_wet, pan_dry, level, the same for every
    voice and channel. `out_samples`: the length of every rendered track
    (the stem, zero past its end, and the tail). `quantize`: None for the
    reference, or a rounding of float64 arrays for a control."""

    def __init__(self, irs, params: dict, out_samples: int, quantize=None):
        self.irs = torch.as_tensor(np.asarray(irs), dtype=torch.float64)
        self.out_samples = int(out_samples)
        self.quantize = quantize
        self.predelay = int(params["predelay"])
        level = float(params["level"])
        self.wet_gain = torch.from_numpy(
            float(params["wet"]) * level * pan_gains(float(params["pan_wet"])))
        self.dry_gain = torch.from_numpy(
            float(params["dry"]) * level * pan_gains(float(params["pan_dry"])))
        self._spectra = {}

    def _ir_spectrum(self, k: int, n: int) -> torch.Tensor:
        """[O, n/2 + 1] transforms of IR k's output channels."""
        if (k, n) not in self._spectra:
            self._spectra[(k, n)] = _quantized(
                torch.fft.rfft(self.irs[k], n=n), self.quantize)
        return self._spectra[(k, n)]

    def render_f64(self, x, select: tuple[int, int]) -> torch.Tensor:
        """[2, out_samples] float64 of one voice whose input is `x` [2, T],
        channel i playing IR ``select[i]``, before the output wire."""
        x = torch.as_tensor(np.asarray(x), dtype=torch.float64)
        t = min(x.shape[-1], self.out_samples)
        n = fast_length(x.shape[-1] + self.irs.shape[-1] - 1)
        spec = _quantized(torch.fft.rfft(x, n=n), self.quantize)   # [I, F]
        acc = sum(spec[i][None, :] * self._ir_spectrum(select[i], n)
                  for i in range(2))                               # [O, F]
        conv = torch.fft.irfft(acc, n=n)                           # [O, n]
        wet = torch.zeros((2, self.out_samples), dtype=torch.float64)
        span = max(min(n, self.out_samples - self.predelay), 0)
        wet[:, self.predelay:self.predelay + span] = conv[:, :span]
        out = torch.clamp(wet * self.wet_gain[:, None], -1.0, 1.0)
        out[:, :t] += self.dry_gain[:, None] * (x[0, :t] + x[1, :t])[None, :]
        return out

    def render(self, x, select: tuple[int, int]) -> torch.Tensor:
        """render_f64 through the 16-bit output wire: float32 on the
        1/32767 grid."""
        return decode_pcm16(encode_pcm16(self.render_f64(x, select)))
