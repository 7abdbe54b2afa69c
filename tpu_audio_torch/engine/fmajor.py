"""Production engine: f-major planar partitioned overlap-save (port of
tpu_audio/engine/fmajor.py: ring mode, the 'allk' MAC, f32, span fades).

Layouts are the JAX engine's, so the two compare like with like:

  - the frequency-domain delay line is f-MAJOR planar f32
    ``fdl [F, V*I, 2, Pp]`` (re/im plane pairs; each row [2*Pp] is one
    contiguous run), written as a RING: the new block spectrum lands in slot
    w = t mod Pp and slot s pairs with bank partition (w - s) mod Pp through
    a window [Pp-w, 2Pp-w) of the DOUBLED, time-REVERSED bank
    ``rhs2 [F, 2, 2*Pp, K*O*2]`` (complex products encoded as 2x2 real
    blocks, pack_mac_rhs);
  - the all-K MAC computes every bank entry's contribution for every voice
    (ops/ring_mac.py: the hand-written CUDA kernel on the card) and a
    [V, 2]-indexed gather picks each voice's selection;
  - crossfades use the affine-coefficient form (active = a*base +
    c*bank[sel], the reference's slew recursion, src/conv.cu:15-32, applied
    to two scalars) with SPAN provenance: base == sum_k base_g[k]*bank[k]
    always holds on this path, so a mid-fade block is the steady block plus
    a K-sized contraction of the same MAC output (step_coef_indexed), and a
    re-select is a [V, 2, K]-sized update (collapse_pure).

The materialized fade snapshot (``base``) is a placeholder, as in the JAX
engine with swap_snapshot=False: the general fade step, ``collapse`` and
``materialize_base`` are not part of this port yet.

Unlike the JAX engine, whose state buffers are donated to each jitted
step, the steps here update ``state.fdl`` and ``state.wet_ring`` IN PLACE
and return a new FMajorState that shares them: the caller must treat the
state it passed in as consumed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.ops.mix import add_dry, wet_scale
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.utils.device import pin_full_f32

_LATER = ("is not ported yet (ROADMAP.md, Queue 1 item 9: the rest of "
          "the fmajor engine)")


@dataclass
class FMajorBank:
    """Device-side bank in the MAC-ready real layout."""

    rhs2: torch.Tensor  # f32 [F, 2, 2*Pp, KOD] doubled+reversed (ring)

    @property
    def num_irs(self) -> int:
        return self.rhs2.shape[-1] // 4  # KOD = K * O(2) * (re, im)


@dataclass
class FMajorState:
    fdl: torch.Tensor       # f32 [F, VI, 2, Pp] planar freq delay line (ring)
    prev_in: torch.Tensor   # f32 [V, 2, B]
    wet_ring: torch.Tensor  # f32 [V, 2, NB, B] MODULAR block-slot output
                            # accumulator: slot (t + d) mod NB holds wet due
                            # d blocks from block t
    base: torch.Tensor      # placeholder [1, 1, 1, 1, 1, 1] (span-only fades)
    coef_a: torch.Tensor    # f32 [V, 2]
    coef_c: torch.Tensor    # f32 [V, 2]
    wptr: torch.Tensor      # i32 [] block counter (mod t_modulus): drives the
                            # fdl ring slot (t mod Pp) and wet-ring slots
    base_g: torch.Tensor    # f32 [V, 2, K] span coefficients of the snapshot
    base_pure: torch.Tensor  # bool [V, 2]


def _pad_p(arr: np.ndarray, axis: int, pp: int) -> np.ndarray:
    pad = pp - arr.shape[axis]
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths)


def pack_mac_rhs(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> [F, 2, Pp, K*O*2] f32 plane-major MAC rhs.

    Plane c=0 carries columns (br, bi) per (k, o); plane c=1 carries
    (-bi, br), so summing the two plane-dots of the (ar, ai) fdl planes
    yields the complex product-sum  sum_p X_p * H_p.
    """
    k, o, p, f = spectra.shape
    br = np.transpose(spectra.real.astype(np.float32), (3, 2, 0, 1))  # [F,P,K,O]
    bi = np.transpose(spectra.imag.astype(np.float32), (3, 2, 0, 1))
    rhs = np.empty((f, 2, p, k, o, 2), np.float32)
    rhs[:, 0, :, :, :, 0] = br
    rhs[:, 0, :, :, :, 1] = bi
    rhs[:, 1, :, :, :, 0] = -bi
    rhs[:, 1, :, :, :, 1] = br
    return _pad_p(rhs.reshape(f, 2, p, k * o * 2), 2, pp)


def double_reversed(arr: np.ndarray, axis: int) -> np.ndarray:
    """out[j] = arr[(-j) mod P], tiled twice along `axis` (one gather; call
    it on the complex spectra BEFORE packing, while the minor-side chunk is
    large — doubling the packed tensor is far slower on the host)."""
    p = arr.shape[axis]
    idx = (p - np.arange(2 * p)) % p
    return np.take(arr, idx, axis=axis)


def pack_spectra_rev2(spectra: np.ndarray, pp: int) -> np.ndarray:
    """[K, O, P, F] complex -> f32 [K, F, O, 2, 2*Pp] doubled+reversed planar:
    the layout the materializing fade paths read (span expansion), which
    the port's next fmajor slice brings."""
    planar = _pad_p(
        np.stack([spectra.real, spectra.imag], axis=1).astype(np.float32),
        3, pp)                                       # [K, 2, O, Pp, F]
    dbl = double_reversed(planar, axis=3)            # [K, 2, O, 2Pp, F]
    return np.ascontiguousarray(np.transpose(dbl, (0, 4, 2, 1, 3)))


def _tensor(arr, device, dtype=None) -> torch.Tensor:
    """Copy a host array onto `device` (never a view of the host buffer)."""
    return torch.tensor(np.asarray(arr), dtype=dtype, device=device)


def bank_from_numpy(*, device, rhs2, mac_rhs=None, spectra=None,
                    spectra_rev2=None) -> FMajorBank:
    """The port's bank from the fields of a JAX FMajorBank as numpy arrays
    (``np.asarray(leaf)`` per field). Only rhs2 is read: the other leaves
    serve the roll mode and the materializing fade paths."""
    return FMajorBank(rhs2=_tensor(rhs2, device, torch.float32))


def state_from_numpy(*, device, fdl, prev_in, wet_ring, coef_a, coef_c, wptr,
                     base_g, base_pure, base=None,
                     sel_spectra=None) -> FMajorState:
    """The port's state from the fields of a JAX FMajorState as numpy arrays
    (``np.asarray(leaf)`` per field), mid-fade states included — as long as
    every live fade is span-represented (base_pure), which is the only kind
    this port serves. `base` and `sel_spectra` (the materialized snapshot
    and the 'selected' strategy's spectra) are not read."""
    coef_a, base_pure = np.asarray(coef_a), np.asarray(base_pure)
    if ((~base_pure) & (coef_a >= 1e-6)).any():
        raise NotImplementedError("a state with a materialized (non-span) "
                                  "fade snapshot " + _LATER)
    return FMajorState(
        fdl=_tensor(fdl, device, torch.float32),
        prev_in=_tensor(prev_in, device, torch.float32),
        wet_ring=_tensor(wet_ring, device, torch.float32),
        base=torch.zeros((1,) * 6, dtype=torch.float32, device=device),
        coef_a=_tensor(coef_a, device, torch.float32),
        coef_c=_tensor(coef_c, device, torch.float32),
        wptr=_tensor(wptr, device, torch.int32).reshape(()),
        base_g=_tensor(base_g, device, torch.float32),
        base_pure=_tensor(base_pure, device, torch.bool),
    )


class FMajorPartitionedConvolution:
    """V stereo voices, f-major planar partitioned-OLS, coef crossfades."""

    ALLK_MAX_COLUMNS = 64  # K <= 16 stereo IRs ride the all-K MAC

    def __init__(self, num_voices: int, block: int, partitions: int,
                 max_predelay: int = 8192, mac_strategy: str = "allk",
                 num_irs: int | None = None, mac_dtype: str = "f32",
                 device="cpu"):
        self.num_voices = num_voices
        self.block = block
        self.partitions = partitions
        # partition axis padded to a multiple of 8; extra zero partitions
        # contribute nothing
        self.pp = -(-partitions // 8) * 8
        self.max_predelay = max_predelay
        if mac_strategy == "auto":
            if num_irs is None:
                raise ValueError("mac_strategy='auto' needs num_irs")
            mac_strategy = ("allk" if num_irs * 4 <= self.ALLK_MAX_COLUMNS
                            else "selected")
        if mac_strategy != "allk":
            raise NotImplementedError(f"mac_strategy={mac_strategy!r} " + _LATER)
        self.mac_strategy = mac_strategy
        if mac_dtype != "f32":
            raise NotImplementedError(f"mac_dtype={mac_dtype!r} " + _LATER)
        self.num_irs = num_irs
        self.device = torch.device(device)
        pin_full_f32()
        self.xf = SpectralTransform(2 * block)
        self.num_bins = self.xf.num_bins
        # block-slot accumulator: slots 0..maxPD//B (+1 for the sub-block
        # tail spill of the deepest predelay)
        self.ring_slots = max_predelay // block + 2
        # the block counter wraps at the lcm of every modulus derived from
        # it so the slot indices stay continuous across the wrap
        self.t_modulus = math.lcm(self.pp, self.ring_slots)

    # -- bank ---------------------------------------------------------------------

    def prepare_bank(self, spectra: np.ndarray) -> FMajorBank:
        """Host [K, 2, P, F] complex spectra -> device FMajorBank. Doubling
        and reversal happen on the complex spectra BEFORE packing (see
        double_reversed)."""
        spectra = np.asarray(spectra)
        if spectra.shape[2] != self.partitions or spectra.shape[3] != self.num_bins:
            raise ValueError(f"bank geometry {spectra.shape} != engine "
                             f"(P={self.partitions}, F={self.num_bins})")
        if self.num_irs is not None and spectra.shape[0] != self.num_irs:
            raise ValueError(f"bank has {spectra.shape[0]} IRs, engine was "
                             f"built for num_irs={self.num_irs} (base_g "
                             f"state is K-shaped)")
        self.num_irs = spectra.shape[0]
        dbl = double_reversed(_pad_p(spectra, 2, self.pp), 2)
        return FMajorBank(rhs2=_tensor(pack_mac_rhs(dbl, 2 * self.pp),
                                       self.device))

    # -- state ---------------------------------------------------------------------

    def init_state(self) -> FMajorState:
        if self.num_irs is None:
            raise ValueError("the span provenance base_g is bank-sized; pass "
                             "num_irs= to the constructor or call "
                             "prepare_bank before init_state")
        v, b, pp, f = self.num_voices, self.block, self.pp, self.num_bins

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        return FMajorState(
            fdl=zeros(f, v * 2, 2, pp),
            prev_in=zeros(v, 2, b),
            wet_ring=zeros(v, 2, self.ring_slots, b),
            base=zeros(1, 1, 1, 1, 1, 1),
            coef_a=zeros(v, 2),
            coef_c=zeros(v, 2),
            wptr=zeros(dtype=torch.int32),
            base_g=zeros(v, 2, self.num_irs),  # the zero snapshot
            base_pure=torch.ones((v, 2), dtype=torch.bool, device=self.device),
        )

    def init_converged(self, bank: FMajorBank, params: VoiceParams
                       ) -> FMajorState:
        state = self.init_state()
        return replace(state, coef_c=params.wet.to(torch.float32).clone())

    # -- hot step -------------------------------------------------------------------

    def _input_spectrum(self, state: FMajorState, x: torch.Tensor
                        ) -> torch.Tensor:
        """OLS segment rfft -> planar [F, VI, 2, 1] f32."""
        seg = torch.cat([state.prev_in, x], dim=-1)               # [V, 2, 2B]
        spec = self.xf.rfft(seg)                                  # [V, 2, F]
        xn = torch.stack([spec.real, spec.imag], dim=-1)          # [V, 2, F, 2]
        return xn.reshape(self.num_voices * 2, self.num_bins, 2
                          ).permute(1, 0, 2)[..., None]

    def _finish(self, state, params, x, y, t, **updates):
        """y [F, V, O, 2] planar spectra -> predelayed wet -> ring -> mix.

        Per-voice predelay pd = q*B + r: the sub-block part r rides the
        inverse transform as a spectral phase ramp (a circular shift of the
        length-2B segment, whose wrap region carries the split-off tail) and
        the block part q picks the wet-ring slots (t + q) mod NB and
        (t + q + 1) mod NB, added in place. Channel 0's predelay feeds both
        outputs (reference src/conv.cu:411-415). The emit slot t mod NB is
        read, then zeroed in place."""
        b, v = self.block, self.num_voices
        n2 = 2 * b
        pd = params.predelay[:, 0].long()                          # [V]
        q = pd // b
        r = pd % b

        # phase ramp e^{-i 2 pi f r / N}: planar rotation of y
        ang = (2.0 * math.pi / n2) * (
            torch.arange(self.num_bins, dtype=torch.float32,
                         device=y.device)[:, None]
            * r.to(torch.float32)[None, :])                       # [F, V]
        c, s = torch.cos(ang)[..., None], torch.sin(ang)[..., None]
        yre, yim = y[..., 0], y[..., 1]
        spec = torch.complex(yre * c + yim * s, yim * c - yre * s)
        ys = self.xf.irfft(spec.permute(1, 2, 0))                 # [V, O, 2B]

        # circular shift: ys[..., B:] offset j holds wet[j - r] for j >= r;
        # ys[..., :B] offset j < r holds the tail wet[B - r + j]
        offs = torch.arange(b, device=y.device)[None, None, :]
        rr = r[:, None, None]
        part_main = torch.where(offs >= rr, ys[..., b:], 0.0)
        part_tail = torch.where(offs < rr, ys[..., :b], 0.0)

        ring = state.wet_ring
        nb = ring.shape[2]
        voices = torch.arange(v, device=y.device)
        tl = t.long()
        ring[voices, :, (tl + q) % nb] += part_main
        ring[voices, :, (tl + q + 1) % nb] += part_tail
        emit = (tl % nb).reshape(1)
        wet_now = ring.index_select(2, emit)[:, :, 0]             # [V, 2, B]
        ring.index_fill_(2, emit, 0.0)

        out = add_dry(torch.clamp(wet_now, -1.0, 1.0), x, params)
        return replace(state, prev_in=x, **updates), out

    def step_coef(self, state: FMajorState, bank: FMajorBank,
                  params: VoiceParams, x: torch.Tensor,
                  with_base: bool = True, indexed_base: bool = False):
        """One block: write the input spectrum into ring slot t mod Pp, run
        the all-K MAC (ops/ring_mac.py), pick each voice's selection,
        add the span-represented fade term when `indexed_base`, finish.
        `with_base=True` without `indexed_base` (the general fade, which
        reads a materialized snapshot) is not part of this port."""
        if with_base and not indexed_base:
            raise NotImplementedError(
                "the general fade step (materialized snapshot) " + _LATER)
        v, f, pp = self.num_voices, self.num_bins, self.pp
        k = bank.num_irs
        xn = self._input_spectrum(state, x)                       # [F, VI, 2, 1]

        t = state.wptr  # block counter (mod t_modulus), device int32
        fdl = state.fdl
        fdl.index_copy_(3, (t.long() % pp).reshape(1), xn)

        r = 1.0 / (params.vsteps.to(torch.float32) + 5.0)
        a = state.coef_a * (1.0 - r)
        c = state.coef_c * (1.0 - r) + params.wet * r
        scale = wet_scale(params)                                 # [V, I, O]

        # all-K MAC: [F, VI, 2Pp] x window [F, 2Pp, KOD] -> [F, VI, KOD]
        m = ring_mac(t, fdl, bank.rhs2).reshape(f, v, 2, k, 2, 2)  # [F,V,I,K,O,d]
        sel = params.select.long()[None, :, :, None, None, None]
        y_sel = torch.gather(m, 3, sel.expand(f, v, 2, 1, 2, 2))[:, :, :, 0]
        y = torch.einsum("fviod,vio->fvod", y_sel, c[..., None] * scale)
        if indexed_base:
            # span snapshot: base == sum_k base_g[k] * bank[k], so the base
            # term is linear in the SAME all-K products m
            y_base = torch.einsum("fvikod,vik->fviod", m, state.base_g)
            y = y + torch.einsum("fviod,vio->fvod", y_base,
                                 a[..., None] * scale)

        wptr_next = torch.remainder(t + 1, self.t_modulus).to(torch.int32)
        return self._finish(state, params, x, y, t, fdl=fdl, coef_a=a,
                            coef_c=c, wptr=wptr_next)

    def step_coef_steady(self, state, bank, params, x):
        """Steady-state hot path: base term elided (coef_a ~ 0)."""
        return self.step_coef(state, bank, params, x, with_base=False)

    def step_coef_indexed(self, state, bank, params, x):
        """The crossfading step: every fading voice's snapshot is
        span-represented, base == sum_k state.base_g[k] * bank[k], so a
        mid-fade block costs the steady block plus a K-sized contraction of
        the same MAC output."""
        return self.step_coef(state, bank, params, x, with_base=False,
                              indexed_base=True)

    # -- rare path ---------------------------------------------------------------------

    def collapse(self, *args, **kwargs):
        raise NotImplementedError("the materializing collapse " + _LATER)

    def materialize_base(self, *args, **kwargs):
        raise NotImplementedError("materialize_base " + _LATER)

    def collapse_pure(self, state: FMajorState, old_select: torch.Tensor,
                      changed: torch.Tensor) -> FMajorState:
        """Span collapse: the affine re-base base := a*base + c*bank[old]
        applied to the span coefficients, base_g := a*base_g +
        c*onehot(old) — exact for any changed voice whose snapshot was
        span-represented, converged or mid-fade alike. A changed voice that
        was not pure must have converged (a ~ 0, host-checked): its stale
        base_g is dropped and the span restarts at c*onehot(old)."""
        k = state.base_g.shape[-1]
        oh = torch.nn.functional.one_hot(old_select.long(), k
                                         ).to(torch.float32)       # [V, 2, K]
        prev = torch.where(state.base_pure[..., None], state.base_g, 0.0)
        g = state.coef_a[..., None] * prev + state.coef_c[..., None] * oh
        return replace(
            state,
            base_g=torch.where(changed[..., None], g, state.base_g),
            base_pure=changed | state.base_pure,
            coef_a=torch.where(changed, 1.0, state.coef_a),
            coef_c=torch.where(changed, 0.0, state.coef_c),
        )
