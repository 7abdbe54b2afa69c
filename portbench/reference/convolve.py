"""Convolution reverb of stereo voices, block by block, in float64.

The law it follows is the reference application's (limitz/cuda-audio
``src/conv.cu``), as a voice at constant parameters hears it: input
channel i of a voice is convolved with output channel o of the IR that
channel i selects; the wet sum of both input channels, each with its wet
gain, wet pan and level, is delayed by channel 0's predelay and clamped to
[-1, 1]; the dry signal of both channels, each with its dry gain, dry pan
and level, is added after the clamp. Pan law: gain_L = 1 - pan for pan >=
0 (else 1), gain_R = 1 + pan for pan <= 0 (else 1).

The convolution is uniformly partitioned overlap-save with block B: IR
partition p (samples [pB, (p+1)B)) is transformed at 2B points, block j of
the input as the pair [x_{j-1}, x_j], and output block j is the last B
samples of the inverse transform of sum_p X_{j-p} H_p. In float64 that is
the linear convolution to rounding (tests/test_portbench_reference.py
holds it to a direct time-domain sum). A ``quantize`` function, applied to
the real and imaginary parts of every product's operands, turns the same
computation into a control in a lower precision.
"""

from __future__ import annotations

import numpy as np


def pan_gains(pan: float) -> np.ndarray:
    """[gain_L, gain_R] of the constant-sum pan law."""
    return np.array([1.0 - pan if pan >= 0 else 1.0,
                     1.0 + pan if pan <= 0 else 1.0])


def _quantized(z: np.ndarray, quantize) -> np.ndarray:
    if quantize is None:
        return z
    return quantize(z.real) + 1j * quantize(z.imag)


class Reference:
    """Renders output blocks of single voices.

    `irs` [K, 2, L]: the bank as the benchmark made it. `params`: wet,
    dry, predelay (samples), pan_wet, pan_dry, level, the same for every
    voice and channel. `quantize`: None for the reference, or a rounding
    of float64 arrays (reference/precision.py) for a control."""

    def __init__(self, irs: np.ndarray, block: int, params: dict,
                 quantize=None):
        self.block = block
        self.quantize = quantize
        irs = np.asarray(irs, np.float64)
        k, o, length = irs.shape
        self.partitions = -(-length // block)
        padded = np.zeros((k, o, self.partitions * block))
        padded[..., :length] = irs
        parts = padded.reshape(k, o, self.partitions, block)
        self.spectra = _quantized(np.fft.rfft(parts, n=2 * block, axis=-1),
                                  quantize)               # [K, O, P, F]
        self.predelay = int(params["predelay"])
        level = float(params["level"])
        self.wet_gain = (float(params["wet"]) * level
                         * pan_gains(float(params["pan_wet"])))   # [O]
        self.dry_gain = (float(params["dry"]) * level
                         * pan_gains(float(params["pan_dry"])))   # [O]

    def render(self, inputs, select: tuple[int, int], blocks
               ) -> np.ndarray:
        """Output blocks `blocks` [n, 2, B] float64 of one voice whose input
        block j is ``inputs(js)[i]`` for an int array js (zeros where js <
        0), channel i playing IR ``select[i]``."""
        b, p_count = self.block, self.partitions
        q, r = divmod(self.predelay, b)
        blocks = np.asarray(blocks, np.int64)
        # conv blocks each output block reads: t - q, and t - q - 1 for
        # the part of a predelay below one block
        conv_js = np.unique(np.concatenate(
            [blocks - q] + ([blocks - q - 1] if r else [])))
        need = np.unique(np.concatenate(
            [(conv_js[:, None] - np.arange(p_count + 1)[None, :]).reshape(-1),
             blocks]))
        x = np.asarray(inputs(need), np.float64)          # [n, 2, B]
        x = np.where((need >= 0)[:, None, None], x, 0.0)
        pos = {int(j): n for n, j in enumerate(need)}
        prev = np.array([pos.get(int(j) - 1, -1) for j in need])
        seg = np.concatenate(
            [np.where((prev >= 0)[:, None, None], x[prev], 0.0), x], axis=-1)
        spec = _quantized(np.fft.rfft(seg, axis=-1), self.quantize)
        conv = {}
        for j in conv_js:
            rows = [pos[int(j) - p] for p in range(p_count)]
            window = spec[rows]                           # [P, I, F]
            acc = np.zeros((2, self.spectra.shape[-1]), np.complex128)
            for i in range(2):
                h = self.spectra[select[i]]                # [O, P, F]
                acc += np.einsum("pf,opf->of", window[:, i], h)
            conv[int(j)] = np.fft.irfft(acc, n=2 * b, axis=-1)[:, b:]
        out = np.empty((len(blocks), 2, b))
        for n, t in enumerate(blocks):
            wet = conv[int(t) - q]                        # [O, B]
            if r:
                wet = np.concatenate([conv[int(t) - q - 1], wet],
                                     axis=-1)[:, b - r: 2 * b - r]
            wet = np.clip(wet * self.wet_gain[:, None], -1.0, 1.0)
            xt = x[pos[int(t)]]
            out[n] = wet + self.dry_gain[:, None] * (xt[0] + xt[1])[None, :]
        return out
