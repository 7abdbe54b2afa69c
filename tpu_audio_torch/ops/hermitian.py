"""Two real channels through one complex FFT, the Hermitian packing (port
of tpu_audio/ops/hermitian.py, on torch.fft).

Capability equivalent of the reference kernels f_pack2R2C and f_unpackC22R
(reference src/conv.cu:35-73): pack L and R as the real and imaginary parts
of one complex signal, take a single C2C FFT, and split the two channels'
spectra with Hermitian symmetry:

    L[k] = (V[k] + conj(V[N-k])) / 2
    R[k] = -j (V[k] - conj(V[N-k])) / 2

The engines take batched ``rfft`` instead (half the spectrum, no unpack
pass); these functions define the reference's spectral layout for tests
and for pipelines ported from the reference. All operate on the last axis.
"""

from __future__ import annotations

import torch


def pack_2r_to_c(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """L + j*R (reference f_pack2R2C, src/conv.cu:35-45)."""
    return torch.complex(torch.as_tensor(l, dtype=torch.float32),
                         torch.as_tensor(r, dtype=torch.float32))


def _reverse_index(v: torch.Tensor) -> torch.Tensor:
    """v[..., (N - k) mod N]."""
    return torch.roll(torch.flip(v, dims=(-1,)), 1, dims=-1)


def unpack_c_to_2r(spectrum: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Split the FFT of (L + jR) into the full-length spectra of L and R
    (reference f_unpackC22R, src/conv.cu:47-73), mirror halves included."""
    v = torch.as_tensor(spectrum)
    v_neg = torch.conj(_reverse_index(v))
    return 0.5 * (v + v_neg), -0.5j * (v - v_neg)


def full_spectrum_from_half(half: torch.Tensor, n: int) -> torch.Tensor:
    """Expand an rfft half-spectrum [..., n//2+1] to the full length-n
    Hermitian spectrum (bins n//2+1.. are conjugate mirrors). Even n
    only."""
    if n % 2:
        raise ValueError(f"full_spectrum_from_half handles even n only "
                         f"(got {n}): odd-n mirrors include the last bin")
    if half.shape[-1] != n // 2 + 1:
        raise ValueError(f"half-spectrum has {half.shape[-1]} bins, "
                         f"expected n//2+1 = {n // 2 + 1}")
    mirror = torch.conj(torch.flip(half[..., 1:-1], dims=(-1,)))
    return torch.cat([half, mirror], dim=-1)


def rfft_via_pack(l: torch.Tensor, r: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference-style full-length spectra of two real channels through one
    C2C FFT: the layout of the reference's _irBuffers[idx], [L | R] each of
    fftSize bins (src/conv.cu:246, src/conv.h:77)."""
    return unpack_c_to_2r(torch.fft.fft(pack_2r_to_c(l, r), dim=-1))
