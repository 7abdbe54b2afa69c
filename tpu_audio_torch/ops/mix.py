"""Block mixing math: pan law, wet gain and dry mix (port of
tpu_audio/ops/mix.py:pan_gains, wet_scale, add_dry).

Semantics of the reference's output stage (reference src/conv.cu:386-427):

  - pan law (src/conv.cu:386-389):   gainL = pan >= 0 ? 1 - pan : 1
                                     gainR = pan <= 0 ? 1 + pan : 1
  - dry mix (f_addDryInterleaved, src/conv.cu:126-140): both input channels
    mix into both outputs, each with its own dry*pan*level gains, added
    UNclamped after the wet clamp.
"""

from __future__ import annotations

import torch


def pan_gains(pan: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Constant-sum pan law over pan in [-1, 1] (reference src/conv.cu:386-389)."""
    one = torch.ones_like(pan)
    gain_l = torch.where(pan >= 0, 1.0 - pan, one)
    gain_r = torch.where(pan <= 0, 1.0 + pan, one)
    return gain_l, gain_r


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
