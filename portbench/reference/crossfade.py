"""The plain reference of live IR churn: voices whose IRs are re-selected
while they stream, each switch crossfading at the reference application's
slew law, rendered block by block in float64 PyTorch on the CPU.

It imports torch and numpy alone: nothing of JAX, of the JAX package or of
the port, and it turns TF32 off.

The law (limitz/cuda-audio ``src/conv.cu:15-32`` f_interpolate,
``:255-285`` handleCC): every block, the active spectrum of an engine
channel slews toward its selected IR's, scaled by the wet gain,

    active_t = active_{t-1} + (wet * H[sel_t] - active_{t-1}) * r_t,
    r_t = 1 / (vsteps_t + 5),

where a select message sets ``sel`` and reloads ``vsteps`` to the channel's
speed (``src/conv.h:40``: 100), and ``vsteps`` counts down by one a block,
after the block, to 0. The recursion is linear in the bank, so the active
spectrum stays a weighted sum of the bank's IRs, sum_k w_k(t) H_k, and
this reference carries the weights alone (FadeLaw), in the affine form
w = a g + c onehot(sel):

    a_t = a_{t-1} (1 - r_t),   c_t = c_{t-1} (1 - r_t) + wet r_t;

a select that changes the IR first re-bases, g := a g + c onehot(old),
a := 1, c := 0, which leaves w where it was. Since the partitioned product
of a block is linear in the IR, output block t of an input channel whose
active spectrum is sum_k w_k H_k is sum_k w_k y_k(t), y_k(t) being the
steady overlap-save block of IR k alone (reference/convolve.py's). So
CrossfadeReference computes, for each block it renders, the y_k of every
IR in one batched product, weights them, and applies convolve.py's law
around the convolution: channel 0's predelay, the wet pan and level (the
wet gain rides in w), the clamp to [-1, 1] and the dry mix after it.

Departures from the port, each within the comparison's limits:

- the port drops the fade term once every fade of the session has decayed
  below 1e-6 (-120 dB) and takes the steady step; this reference keeps
  every weight exactly;
- the port carries a and c in float32, this reference in float64;
- only selects move here: wet, predelay, pans, level and speed stay at the
  configuration's values (the law above covers a wet change too, as c's
  target, but no traffic sends one).

A ``quantize`` function (reference/precision.py), applied to the real and
imaginary parts of the partitioned product's operands and to both
operands of the fade's contraction (the y_k and the weights), turns the
same computation into a control in a lower precision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.convolve import pan_gains

# full float64 products on every device: no TF32 anywhere in the reference
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LIVE = 1e-6   # a fade whose a is at or above this still sounds (-120 dB)


@dataclass
class Fades:
    """The law's state after one block, every voice and channel: the
    weights w [V, 2, K], the fade's a [V, 2], and whether the fade in
    flight began by interrupting a live one ([V, 2] bool)."""

    w: np.ndarray
    a: np.ndarray
    interrupted: np.ndarray


class FadeLaw:
    """The slew law's weights for V voices over a bank of K IRs.

    `select` [V, 2]: each channel's IR at the stream's start, converged
    there (a = 0, c = wet, vsteps = 0, as the served path starts).
    `events`: (block, voice, channel, ir) selects, applied at the start of
    their block."""

    def __init__(self, select, num_irs: int, wet: float, speed: int,
                 events):
        self.select0 = np.asarray(select, np.int64)
        self.num_irs = int(num_irs)
        self.wet = float(wet)
        self.speed = int(speed)
        self.events: dict[int, list] = {}
        for block, voice, ch, ir in events:
            self.events.setdefault(int(block), []).append(
                (int(voice), int(ch), int(ir)))

    def weights(self, blocks) -> dict[int, Fades]:
        """{block: Fades} at each of `blocks` (blocks before 0 read the
        starting state)."""
        want = sorted({int(b) for b in blocks})
        wanted = set(want)
        v = self.select0.shape[0]
        sel = self.select0.copy()
        a = np.zeros((v, 2))
        c = np.full((v, 2), self.wet)
        g = np.zeros((v, 2, self.num_irs))
        vsteps = np.zeros((v, 2))
        interrupted = np.zeros((v, 2), bool)
        out = {}
        onehot = np.eye(self.num_irs)

        def record(block):
            w = a[..., None] * g + c[..., None] * onehot[sel]
            out[block] = Fades(w, a.copy(), interrupted.copy())

        for block in [b for b in want if b < 0]:
            record(block)
        last = want[-1] if want else -1
        for t in range(max(last + 1, 0)):
            for voice, ch, ir in self.events.get(t, ()):
                old = sel[voice, ch]
                if ir != old:
                    interrupted[voice, ch] = a[voice, ch] >= LIVE
                    g[voice, ch] = a[voice, ch] * g[voice, ch] \
                        + c[voice, ch] * onehot[old]
                    a[voice, ch], c[voice, ch] = 1.0, 0.0
                    sel[voice, ch] = ir
                vsteps[voice, ch] = self.speed
            r = 1.0 / (vsteps + 5.0)
            a *= 1.0 - r
            c = c * (1.0 - r) + self.wet * r
            if t in wanted:
                record(t)
            np.maximum(vsteps - 1.0, 0.0, out=vsteps)
        return {b: out[b] for b in want}


def _quantized(z: torch.Tensor, quantize) -> torch.Tensor:
    if quantize is None:
        return z
    if not z.is_complex():
        return torch.from_numpy(quantize(z.numpy()))
    return torch.complex(torch.from_numpy(quantize(z.real.numpy())),
                         torch.from_numpy(quantize(z.imag.numpy())))


class CrossfadeReference:
    """Renders output blocks of single voices under moving IR weights.

    `irs` [K, 2, L]: the bank as the benchmark made it. `params`: dry,
    predelay (samples), pan_wet, pan_dry, level, the same for every voice
    and channel (the wet gain is in the weights). `quantize`: None for the
    reference, or a rounding of float64 arrays for a control."""

    def __init__(self, irs, block: int, params: dict, quantize=None):
        self.block = block
        self.quantize = quantize
        irs = torch.as_tensor(np.asarray(irs), dtype=torch.float64)
        k, o, length = irs.shape
        self.num_irs = k
        self.partitions = -(-length // block)
        padded = torch.zeros((k, o, self.partitions * block),
                             dtype=torch.float64)
        padded[..., :length] = irs
        parts = padded.reshape(k, o, self.partitions, block)
        spectra = _quantized(torch.fft.rfft(parts, n=2 * block, dim=-1),
                             quantize)                     # [K, O, P, F]
        # [F, P, K * O]: one product per bin takes every IR at once
        self.h = spectra.permute(3, 2, 0, 1).reshape(
            spectra.shape[-1], self.partitions, k * o).contiguous()
        self.predelay = int(params["predelay"])
        level = float(params["level"])
        self.wet_gain = torch.from_numpy(
            level * pan_gains(float(params["pan_wet"])))  # [O]
        self.dry_gain = torch.from_numpy(
            float(params["dry"]) * level
            * pan_gains(float(params["pan_dry"])))        # [O]

    def render(self, inputs, weights, blocks) -> np.ndarray:
        """Output blocks `blocks` [n, 2, B] float64 of one voice whose input
        block j is ``inputs(js)[i]`` for an int array js (zeros where js <
        0) and whose channel i weighs IR k by ``weights(js)[n, i, k]`` at
        block js[n]."""
        b, p_count, k = self.block, self.partitions, self.num_irs
        q, r = divmod(self.predelay, b)
        blocks = np.asarray(blocks, np.int64)
        # the blocks of convolution each output block reads: t - q, and
        # t - q - 1 for the part of a predelay below one block
        conv_js = np.unique(np.concatenate(
            [blocks - q] + ([blocks - q - 1] if r else [])))
        need = np.unique(np.concatenate(
            [(conv_js[:, None] - np.arange(p_count + 1)[None, :]).reshape(-1),
             blocks]))
        x = torch.as_tensor(np.asarray(inputs(need), np.float64))
        x = torch.where(torch.from_numpy(need >= 0)[:, None, None], x, 0.0)
        pos = {int(j): n for n, j in enumerate(need)}
        prev = torch.tensor([pos.get(int(j) - 1, -1) for j in need])
        seg = torch.cat([torch.where((prev >= 0)[:, None, None],
                                     x[prev.clamp_min(0)], 0.0), x], dim=-1)
        spec = _quantized(torch.fft.rfft(seg, dim=-1), self.quantize)
        rows = torch.tensor([[pos[int(j) - p] for p in range(p_count)]
                             for j in conv_js])            # [J, P]
        # [F, I, n] gathered along its last axis: [F, I, J, P] in place
        window = spec.permute(2, 1, 0).contiguous()[:, :, rows]
        f = window.shape[0]
        lhs = window.reshape(f, -1, p_count)               # [F, I*J, P]
        y = torch.matmul(lhs, self.h)                      # [F, I*J, K*O]
        y = _quantized(y.reshape(f, 2, len(conv_js), k, 2), self.quantize)
        w = _quantized(torch.as_tensor(np.asarray(weights(conv_js),
                                                  np.float64)),
                       self.quantize)                      # [J, I, K]
        acc = torch.einsum("fijko,jik->jof", y, w.to(y.dtype))
        wet_all = torch.fft.irfft(acc, n=2 * b, dim=-1)[..., b:]
        conv = {int(j): wet_all[n] for n, j in enumerate(conv_js)}
        out = torch.empty((len(blocks), 2, b), dtype=torch.float64)
        for n, t in enumerate(blocks):
            wet = conv[int(t) - q]                         # [O, B]
            if r:
                wet = torch.cat([conv[int(t) - q - 1], wet],
                                dim=-1)[:, b - r: 2 * b - r]
            wet = torch.clamp(wet * self.wet_gain[:, None], -1.0, 1.0)
            xt = x[pos[int(t)]]
            out[n] = wet + self.dry_gain[:, None] * (xt[0] + xt[1])[None, :]
        return out.numpy()
