"""Click-free IR crossfade / wet-gain smoothing (port of
tpu_audio/ops/smoother.py).

Semantics of the reference's f_interpolate kernel (reference src/conv.cu:15-32):
every block, the *active* spectrum slews one step toward the *selected* bank
spectrum scaled by the wet gain:

    active += (bank[select] * wet - active) / (vsteps + 5)

with ``vsteps`` reloaded to ``speed`` on IR select (src/conv.cu:261) and
decremented once per block until 0 (src/conv.cu:345,353). At vsteps == 0 the
smoother keeps converging at rate 1/5, which also smooths live `wet`
changes. The step factor is the same for every bin, so the recursion
commutes with the Fourier transform and with IR partitioning.
"""

from __future__ import annotations

import torch


def gather_spectra(bank: torch.Tensor, select: torch.Tensor) -> torch.Tensor:
    """The slew's target: bank [K, O, ...] at select [V, I] -> [V, I, O, ...]
    (one gather)."""
    out = bank.index_select(0, select.reshape(-1).long())
    return out.reshape(select.shape + bank.shape[1:])


def slew_spectra(active: torch.Tensor, target: torch.Tensor,
                 wet, vsteps) -> torch.Tensor:
    """One crossfade step. `active`/`target` are complex spectra [..., F];
    `wet` and `vsteps` are scalars or tensors broadcastable against them."""
    wet = torch.as_tensor(wet, dtype=torch.float32, device=active.device)
    step = 1.0 / (torch.as_tensor(vsteps, device=active.device)
                  .to(torch.float32) + 5.0)
    return active + (target * wet - active) * step


def vsteps_decrement(vsteps, blocks: int = 1) -> torch.Tensor:
    """vsteps = max(vsteps - blocks, 0): `blocks` of the reference's
    per-block decrements (src/conv.cu:345,353)."""
    return torch.clamp_min(torch.as_tensor(vsteps) - blocks, 0)
