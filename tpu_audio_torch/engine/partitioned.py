"""Uniform partitioned overlap-save convolution with complex spectra (port of
tpu_audio/engine/partitioned.py).

The IR lives as P block-sized partition spectra; each block pays two small
(N = 2B) transforms and a frequency-domain multiply-accumulate over the
partition axis, so IR length is bounded only by memory, not by one FFT (the
reference caps IRs at fftSize - 1024 ≈ 2.95 s, src/conv.cu:239).

Two state representations, equivalence-tested against each other, against
the JAX engine and against the monolithic engine:

  - ``materialized``: the active IR spectra are a [V, 2, 2, P, F] tensor
    slewed toward bank[select]*wet every block, the reference's
    f_interpolate (src/conv.cu:15-32);
  - ``coef`` (default): the slew step is the same scalar for every bin, so
    the active spectrum stays an affine combination a*base + c*bank[select]
    of a frozen snapshot and the selected bank entry; the per-block slew
    becomes two scalar recursions (a' = a(1-r), c' = c(1-r) + wet*r, r =
    1/(vsteps+5)), and the MAC reads base and bank[select]. On a re-select
    the host calls collapse() between blocks (base := a*base + c*bank[old],
    a := 1, c := 0). Once a fade has decayed (a ~ 0, which the host tracks
    analytically) the steady step drops the base term.

Mix, predelay and clamp follow the monolithic engine and the reference:
both engine channels mix into both outputs with pan*level gains, the wet
stream is delayed by channel 0's predelay (src/conv.cu:411-415), clamped to
+-1, and the dry mix is added unclamped.

Crossfades: the monolithic engine is input-synchronous (each input block
meets the IR of its arrival time), partitioned OLS output-synchronous (each
output block recombines the past inputs with the current IR). The two agree
whenever the IR is not fading, and both variants here agree at all times.

The MACs are elementwise complex products summed over the partition axis:
an einsum over `p` would batch 2*V*F products of one row each and copy both
operands into that layout first. No TF32 reaches them (no matrix product),
and the steps are functional: the state passed in is left as it was.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.ops.mix import add_dry, wet_scale
from tpu_audio_torch.ops.smoother import gather_spectra, slew_spectra
from tpu_audio_torch.utils.device import resolve_device


@dataclass
class PartitionedState:
    fdl: torch.Tensor       # complex64 [V, 2, P, F] input-spectra delay line
    prev_in: torch.Tensor   # f32 [V, 2, B] previous input block (OLS segment)
    wet_ring: torch.Tensor  # f32 [V, 2, maxPD + B] wet delay accumulator
    # coef representation ([V, 2, 2, 1, 1] placeholder when materialized):
    base: torch.Tensor      # complex64 [V, 2, 2, P, F] frozen snapshot
    coef_a: torch.Tensor    # f32 [V, 2] weight of base
    coef_c: torch.Tensor    # f32 [V, 2] weight of bank[select]
    # materialized representation ([V, 2, 2, 1, 1] placeholder for coef):
    active: torch.Tensor    # complex64 [V, 2, 2, P, F] slewed spectra


def _mac(fdl: torch.Tensor, spectra: torch.Tensor) -> torch.Tensor:
    """sum_p fdl[v,i,p,f] * spectra[v,i,o,p,f] -> [V, I, O, F]."""
    return (fdl[:, :, None] * spectra).sum(dim=3)


def _mix(mac: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """sum_i mac[v,i,o,f] * gain[v,i,o] -> [V, O, F]."""
    return (mac * gain[..., None]).sum(dim=1)


class PartitionedConvolution:
    """V stereo voices of partitioned-OLS convolution reverb.

    `bank` arguments are complex64 [K, 2, P, F] partition spectra on the
    engine's device (IRBank.partitioned_spectra, uploaded). `device`: None
    or "cuda" selects the best CUDA device (select_gpu, which raises without
    CUDA); "cpu" runs on the CPU."""

    def __init__(self, num_voices: int, block: int, partitions: int,
                 max_predelay: int = 8192, variant: str = "coef",
                 device=None):
        if variant not in ("coef", "materialized"):
            raise ValueError(f"unknown variant {variant!r}")
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions
        self.max_predelay = max_predelay
        self.variant = variant
        # StreamSession's fade protocol (runtime/stream.py): 'coef' steps by
        # the affine coefficients, 'materialized' slews inside step
        self.fade_protocol = "coef" if variant == "coef" else "slew"
        self.device = resolve_device(device)
        self.xf = SpectralTransform(2 * block)
        self.num_bins = self.xf.num_bins
        self.ring = max_predelay + block

    # -- offline / cloning interface ------------------------------------------------

    def with_voices(self, num_voices: int, device=None
                    ) -> "PartitionedConvolution":
        """Same geometry and variant at another voice count, on this
        engine's device or on `device`; banks are voice-independent (the
        seam of the runtime/offline.py renderer and of the mesh's
        per-shard engines, parallel/mesh.py)."""
        return PartitionedConvolution(
            num_voices, self.block, self.partitions,
            max_predelay=self.max_predelay, variant=self.variant,
            device=self.device if device is None else device)

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output block
        at converged params (delay-line depth + predelay ring + margin), the
        offline renderer's warm-up."""
        return self.partitions + self.max_predelay // self.block + 3

    # -- state ---------------------------------------------------------------------

    def init_state(self) -> PartitionedState:
        """Zero state: the crossfade slews up from silence (the reference's
        behaviour with zeroed buffers)."""
        v, b, p, f = self.num_voices, self.block, self.partitions, self.num_bins
        full, placeholder = (v, 2, 2, p, f), (v, 2, 2, 1, 1)
        coef = self.variant == "coef"

        def zeros(shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return PartitionedState(
            fdl=zeros((v, 2, p, f), torch.complex64),
            prev_in=zeros((v, 2, b)),
            wet_ring=zeros((v, 2, self.ring)),
            base=zeros(full if coef else placeholder, torch.complex64),
            coef_a=zeros((v, 2)),
            coef_c=zeros((v, 2)),
            active=zeros(placeholder if coef else full, torch.complex64),
        )

    def init_converged(self, bank: torch.Tensor, params: VoiceParams
                       ) -> PartitionedState:
        """Crossfade pre-settled at bank[select]*wet."""
        state = self.init_state()
        if self.variant == "coef":
            return replace(state, coef_c=params.wet.to(torch.float32).clone())
        active = gather_spectra(bank, params.select) * params.wet[
            ..., None, None, None]
        return replace(state, active=active.to(torch.complex64))

    # -- shared pieces -----------------------------------------------------------------

    def input_column(self, state: PartitionedState, x: torch.Tensor
                     ) -> torch.Tensor:
        """The OLS segment's rfft, the line's new column [V, 2, 1, F]."""
        return self.xf.rfft(torch.cat([state.prev_in, x], dim=-1))[:, :, None]

    @staticmethod
    def shift_line(fdl: torch.Tensor, column: torch.Tensor) -> torch.Tensor:
        """`column` pushed onto the front of the delay line [V, 2, P, F]
        (a new tensor); on a partition shard of the line, `column` is the
        previous shard's last one (parallel/mesh.py)."""
        return torch.cat([column, fdl[:, :, :-1]], dim=2)

    def _analyze(self, state: PartitionedState, x: torch.Tensor
                 ) -> torch.Tensor:
        """OLS segment rfft pushed onto the front of the delay line."""
        return self.shift_line(state.fdl, self.input_column(state, x))

    def _finish(self, state: PartitionedState, params: VoiceParams,
                x: torch.Tensor, spec_out: torch.Tensor, **updates):
        """Inverse transform, predelay accumulation ring, clamp, dry mix.

        The ring is a future-output accumulator: each block's wet lands at
        offset `predelay`, so a predelay change affects only new wet, the
        reference's residual semantics (src/conv.cu:89-100,440-451)."""
        b = self.block
        wet = self.xf.irfft(spec_out)[..., b:]                   # [V, 2, B]
        ring = torch.cat([state.wet_ring[..., b:],
                          torch.zeros_like(state.wet_ring[..., :b])], dim=-1)
        # channel 0's predelay feeds both outputs (src/conv.cu:411-415)
        pd = params.predelay[:, 0].long()
        idx = pd[:, None, None] + torch.arange(b, device=ring.device)
        ring.scatter_add_(2, idx.expand(wet.shape), wet)
        out = add_dry(torch.clamp(ring[..., :b], -1.0, 1.0), x, params)
        return replace(state, prev_in=x, wet_ring=ring, **updates), out

    # -- hot steps -----------------------------------------------------------------------

    def step(self, state: PartitionedState, bank: torch.Tensor,
             params: VoiceParams, x: torch.Tensor):
        """One block of the engine's variant -> (state', out [V, 2, B])."""
        if self.variant == "coef":
            return self.step_coef(state, bank, params, x)
        return self.step_materialized(state, bank, params, x)

    def step_materialized(self, state, bank, params, x):
        """The reference's form: slew the full spectra, one MAC."""
        fdl = self._analyze(state, x)
        active, mac = self.slew_stage(fdl, bank, params, state.active)
        return self.slew_finish(state, params, x, fdl, active, mac)

    def step_coef(self, state, bank, params, x, with_base: bool = True):
        """Affine-coefficient form: scalar slew, MAC over bank[select] and,
        `with_base`, the snapshot."""
        fdl = self._analyze(state, x)
        sums = self.coef_stage(fdl, bank, params.select,
                               state.base if with_base else None)
        return self.coef_finish(state, params, x, fdl, sums)

    # the two stages of each step, the seam of the mesh's part axis
    # (parallel/mesh.py): the first sums over the line's partitions, so a
    # line split over partition shards runs it on each shard's slice and
    # adds the shards' sums; the second reads only those sums

    @staticmethod
    def coef_stage(fdl, bank, select, base=None):
        """(MAC over bank[select], MAC over `base` or None), each [V, I, O,
        F] summed over the partitions of `fdl`."""
        target = _mac(fdl, gather_spectra(bank, select))          # [V,2,2,F]
        return target, (None if base is None else _mac(fdl, base))

    def coef_finish(self, state, params, x, fdl, sums):
        target, base = sums
        r = 1.0 / (params.vsteps.to(torch.float32) + 5.0)          # [V, 2]
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = wet_scale(params)                                   # [V, 2, 2]
        spec_out = _mix(target, c[..., None] * scale)
        if base is not None:
            spec_out = spec_out + _mix(base, a[..., None] * scale)
        return self._finish(state, params, x, spec_out, fdl=fdl, coef_a=a,
                            coef_c=c)

    @staticmethod
    def slew_stage(fdl, bank, params, active):
        """The slewed spectra of `fdl`'s partitions and their MAC [V, I, O,
        F]."""
        active = slew_spectra(active, gather_spectra(bank, params.select),
                              params.wet[..., None, None, None],
                              params.vsteps[..., None, None, None])
        return active, _mac(fdl, active)

    def slew_finish(self, state, params, x, fdl, active, mac):
        spec_out = _mix(mac, wet_scale(params))
        return self._finish(state, params, x, spec_out, fdl=fdl, active=active)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state step: every fade has decayed (coef_a ~ 0, tracked by
        the host, runtime/stream.py), so the base term is skipped."""
        return self.step_coef(state, bank, params, x, with_base=False)

    # -- rare path ------------------------------------------------------------------------

    def collapse(self, state: PartitionedState, bank: torch.Tensor,
                 old_select: torch.Tensor, changed: torch.Tensor,
                 new_select: torch.Tensor | None = None,
                 params: VoiceParams | None = None) -> PartitionedState:
        """Re-base the affine form after an IR re-select (host-triggered,
        between blocks): base := a*base + c*bank[old_select] where
        `changed` [V, 2], so the scalar recursion continues from the exact
        current spectrum; a := 1, c := 0 there. `new_select` and `params`
        are taken for the engines' shared signature and not read."""
        collapsed = (state.coef_a[..., None, None, None] * state.base
                     + state.coef_c[..., None, None, None]
                     * gather_spectra(bank, old_select))
        return replace(
            state,
            base=torch.where(changed[..., None, None, None], collapsed,
                             state.base),
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )
