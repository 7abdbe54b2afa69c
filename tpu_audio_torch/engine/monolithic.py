"""Reference-parity engine: monolithic-FFT overlap-add convolution (port of
tpu_audio/engine/monolithic.py).

The reference algorithm (reference src/conv.cu:287-466): one full-size
spectrum per IR, one forward and one inverse transform per block (cuFFT
through torch.fft on the card), the spectral slew crossfade, predelay +
residual overlap-add with clamping and the 2x2 wet/dry mix. It is the
executable specification the partitioned engines are held against, and it
serves small-IR configurations where one FFT is fine.

Deviations kept from the JAX package: a batched rfft per channel instead of
the 2-channels-in-1-complex-FFT packing (ops/hermitian.py has that layout);
the extended output tail is carried in full (the reference writes only
fftSize of its fftSize+8192 buffer, src/conv.cu:411); voices are batched
[V, ...]. Kept reference quirks: channel 0's predelay applies to both
outputs (src/conv.cu:411-415); the wet clamp runs before the dry add, which
is not re-clamped (src/conv.cu:417-427).

The steps are functional: the state passed in is left as it was.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_audio_torch.engine.params import VoiceParams
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.ops.mix import add_dry, delay_and_clamp_add, wet_scale
from tpu_audio_torch.ops.smoother import gather_spectra, slew_spectra
from tpu_audio_torch.utils.device import resolve_device


@dataclass
class MonolithicState:
    active: torch.Tensor    # complex64 [V, 2, 2, Fm] slewed IR spectra
    residual: torch.Tensor  # f32 [V, 2, E] overlap-add tail, E = N + maxPD


class MonolithicConvolution:
    """V stereo voices of reference-style convolution reverb.

    `bank` arguments are complex64 [K, 2, fft_size//2+1] half-spectra on
    the engine's device (IRBank.monolithic_spectra, uploaded). `device`:
    None or "cuda" selects the best CUDA device (select_gpu, which raises
    without CUDA); "cpu" runs on the CPU."""

    fade_protocol = "slew"   # StreamSession (runtime/stream.py): step slews

    def __init__(self, num_voices: int, fft_size: int, block: int = 256,
                 max_predelay: int = 8192, device=None):
        if block >= fft_size:
            raise ValueError("block must be < fft_size")
        self.num_voices = num_voices
        self.fft_size = fft_size
        self.block = block
        self.max_predelay = max_predelay
        self.device = resolve_device(device)
        self.xf = SpectralTransform(fft_size)
        self.num_bins = self.xf.num_bins
        self.ext = fft_size + max_predelay

    # -- offline / cloning interface ----------------------------------------------

    def with_voices(self, num_voices: int) -> "MonolithicConvolution":
        """Same geometry and device at another voice count; banks are
        voice-independent (the runtime/offline.py renderer seam)."""
        return MonolithicConvolution(num_voices, self.fft_size, self.block,
                                     max_predelay=self.max_predelay,
                                     device=self.device)

    @property
    def history_blocks(self) -> int:
        """Trailing input blocks that fully determine the next output block
        at converged params: the residual spans fft_size + max_predelay
        samples (the offline renderer's warm-up)."""
        return -(-self.ext // self.block) + 2

    def warmup(self) -> None:
        """Run both transforms once at the step's shape, so the first block
        does not pay for the FFT plans (cuFFT caches them per shape)."""
        x = torch.zeros((self.num_voices, 2, self.fft_size),
                        device=self.device)
        self.xf.irfft(self.xf.rfft(x))

    # -- state ------------------------------------------------------------------

    def init_state(self) -> MonolithicState:
        v = self.num_voices
        return MonolithicState(
            active=torch.zeros((v, 2, 2, self.num_bins), dtype=torch.complex64,
                               device=self.device),
            residual=torch.zeros((v, 2, self.ext), device=self.device))

    def init_converged(self, bank: torch.Tensor, params: VoiceParams
                       ) -> MonolithicState:
        """State with the crossfade already settled at bank[select]*wet
        (skips the reference's fade-in from zeroed spectra)."""
        active = gather_spectra(bank, params.select) * params.wet[..., None,
                                                                  None]
        return MonolithicState(
            active=active.to(torch.complex64),
            residual=torch.zeros((self.num_voices, 2, self.ext),
                                 device=self.device))

    # -- hot step ------------------------------------------------------------------

    def step(self, state: MonolithicState, bank: torch.Tensor,
             params: VoiceParams, x: torch.Tensor):
        """One audio block: state, bank [K, 2, Fm], params, x [V, 2, B] ->
        (state', out [V, 2, B])."""
        v, b = self.num_voices, self.block
        # zero-padded block FFT (reference conv.cu:321-328,367): rfft pads
        # x to fft_size
        spec_in = self.xf.rfft(x)                                 # [V, 2, Fm]
        # spectral slew toward bank[select]*wet (f_interpolate, conv.cu:
        # 339-353); one step factor for every bin
        active = slew_spectra(state.active, gather_spectra(bank, params.select),
                              params.wet[..., None, None],
                              params.vsteps[..., None, None])
        # both engine channels convolve and mix into both outputs with
        # pan*level scales (conv.cu:386-401)
        scale = wet_scale(params)                                 # [V, 2, 2]
        spec_out = (spec_in[:, :, None] * active * scale[..., None]).sum(dim=1)
        wet = self.xf.irfft(spec_out)                             # [V, 2, N]
        # predelay + residual + clamp (f_pointwiseAdd, conv.cu:89-100,
        # 411-415; channel 0's predelay for both outputs)
        pd = params.predelay[:, 0, None]                          # [V, 1]
        out_ext = delay_and_clamp_add(state.residual, wet, pd)    # [V, 2, E]
        # dry 2x2 mix into the first B samples, not re-clamped
        # (f_addDryInterleaved, conv.cu:417-427)
        out = add_dry(out_ext[..., :b], x, params)
        residual = torch.cat([out_ext[..., b:],
                              out_ext.new_zeros((v, 2, b))], dim=-1)
        return MonolithicState(active=active, residual=residual), out
