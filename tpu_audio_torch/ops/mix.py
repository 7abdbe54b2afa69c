"""Block mixing math: pan law, predelay + residual overlap-add, wet gain and
dry mix (port of tpu_audio/ops/mix.py).

Semantics of the reference's output stage (reference src/conv.cu:89-140,
386-427):

  - pan law (src/conv.cu:386-389):   gainL = pan >= 0 ? 1 - pan : 1
                                     gainR = pan <= 0 ? 1 + pan : 1
  - wet assembly (f_pointwiseAdd, src/conv.cu:89-100):
        out[s] = clamp(residual[s] + (s >= predelay ? wet[s - predelay] : 0),
                       -1, 1)
  - dry mix (f_addDryInterleaved, src/conv.cu:126-140): both input channels
    mix into both outputs, each with its own dry*pan*level gains, added
    UNclamped after the wet clamp.

Deliberate fix kept from the JAX package: the reference writes only
fftSize samples of the extended (fftSize + maxPredelay) output buffer
(src/conv.cu:411), dropping up to `predelay` samples of wet tail per block;
here the delayed wet tail is carried in full.
"""

from __future__ import annotations

import torch


def pan_gains(pan: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Constant-sum pan law over pan in [-1, 1] (reference src/conv.cu:386-389)."""
    one = torch.ones_like(pan)
    gain_l = torch.where(pan >= 0, 1.0 - pan, one)
    gain_r = torch.where(pan <= 0, 1.0 + pan, one)
    return gain_l, gain_r


def delay_and_clamp_add(residual: torch.Tensor, wet: torch.Tensor,
                        predelay) -> torch.Tensor:
    """clamp(residual + wet shifted right by predelay, -1, 1) over the last
    axis. residual [..., E], wet [..., W] with W <= E; `predelay` is an int
    or an integer tensor broadcastable against the leading axes (e.g. [V, 1]
    for one shift per voice). One gather at index arange(E) - predelay,
    masked where it falls before the start."""
    e, w = residual.shape[-1], wet.shape[-1]
    padded = torch.nn.functional.pad(wet, (0, e - w))
    pd = torch.as_tensor(predelay, device=residual.device).to(torch.long)
    idx = torch.arange(e, device=residual.device) - pd[..., None]
    shifted = torch.gather(padded, -1,
                           idx.clamp_min(0).expand(padded.shape))
    shifted = torch.where(idx >= 0, shifted, 0.0)
    return torch.clamp(residual + shifted, -1.0, 1.0)


def dry_mix_2x2(out_l: torch.Tensor, out_r: torch.Tensor,
                in1: torch.Tensor, in2: torch.Tensor,
                gains: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """Add the dry signal into the first len(in1) samples of both outputs
    (new tensors). gains = (l1, r1, l2, r2): channel-1 dry gain into L/R,
    channel-2 dry gain into L/R, each already folded as dry*pan*level
    (reference src/conv.cu:417-427); not re-clamped."""
    l1, r1, l2, r2 = gains
    nb = in1.shape[-1]
    out_l, out_r = out_l.clone(), out_r.clone()
    out_l[..., :nb] += in1 * l1 + in2 * l2
    out_r[..., :nb] += in1 * r1 + in2 * r2
    return out_l, out_r


def wet_scale(params) -> torch.Tensor:
    """[V, I, O] wet output gain: wet pan x level (reference folds pan*level
    into the inverse-FFT scale, src/conv.cu:392-401)."""
    gl, gr = pan_gains(params.pan_wet)
    return torch.stack([gl, gr], dim=-1) * params.level[..., None]


def add_dry(out: torch.Tensor, x: torch.Tensor, params) -> torch.Tensor:
    """Dry 2x2 pan mix added UNCLAMPED after the wet clamp (reference
    kernel order, src/conv.cu:411-427). out, x: [V, 2, B]."""
    gl, gr = pan_gains(params.pan_dry)
    dry_gain = (torch.stack([gl, gr], dim=-1)
                * (params.dry * params.level)[..., None])       # [V, I, O]
    return out + torch.einsum("vib,vio->vob", x, dry_gain)
