"""On-device IR preparation (port of tpu_audio/engine/device_prep.py, for
the fmajor and cascade engines): time-domain PCM crosses the bus, and the
partition spectra and packed MAC tensors are computed on the engine's
device.

Reference parity: ``Convolution::prepare`` computes every IR spectrum ON
THE GPU (cufftExecC2C + Hermitian unpack, reference src/conv.cu:207-253);
the only host-to-device traffic is the WAV's PCM samples (src/wav.cu:100).
Here the host uploads one [K, O, L] float32 tensor (~215 MB for the
152-IR 4 s bank); ``upload_bank_td`` also offers the JAX package's exact
int16 wire for a bank on the 16-bit WAV grid (half the bytes), which a
caller asks for by name: on an H100 its host-side grid check and encode
cost more than the bytes it saves (PERF.md §6), so the prep functions
default to f32 where the JAX ones default to 'auto'. The partition
transforms run as ``torch.fft.rfft`` on the device (cuFFT on a card, as
ops/fft.py does for the block transforms), and the double+reverse and
plane packs are tensor gathers and permutes.

Exactness: the packs are bit-exact axis moves plus one negation, so a
device-prepared bank differs from the host prep (numpy pocketfft) only by
the FFT's rounding (~1e-7 relative).
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from tpu_audio_torch.utils.log import Log

if TYPE_CHECKING:
    from tpu_audio_torch.engine.cascade import CascadeBank
    from tpu_audio_torch.engine.fmajor import FMajorBank

# the exact 16-bit WAV scaling read_wav applies (reference src/wav.cu /65536
# headroom convention): x = q / 65536 with q an int16. 1/65536 is a power of
# two, so the decode multiply is exact in f32.
_PCM16_SCALE = 65536.0


def bank_time_domain(bank) -> np.ndarray:
    """IRBank -> [K, O, Lmax] float32, IRs zero-padded to the bank's
    longest entry (zero tail partitions transform to zero spectra — the
    same padding prepare_bank's gather layout already relies on)."""
    k = len(bank)
    l_max = bank.max_length
    out = np.zeros((k, 2, l_max), np.float32)
    for i in range(k):
        ir = bank.ir(i)
        out[i, :, : ir.shape[-1]] = ir
    return out


def encode_pcm16_exact(td: np.ndarray) -> np.ndarray | None:
    """int16 wire encoding when EXACT, else None. Exact iff every sample
    is q/65536 with q in int16 range — true for any IR loaded from a
    16-bit WAV (read_wav's /65536 scaling), including tiled or truncated
    copies, but not for normalized or 24-bit/float sources. Checks one IR
    (leading-axis row) at a time and stops at the first off the grid."""
    out = np.empty(td.shape, np.int16)
    for k in range(td.shape[0]):
        q = td[k] * _PCM16_SCALE
        r = np.rint(q)
        if (q != r).any() or r.min() < -32768 or r.max() > 32767:
            return None
        out[k] = r
    return out


def upload_bank_td(td: np.ndarray, wire: str = "auto", device="cpu"):
    """Host [K, O, L] f32 -> the same f32 values on `device`, over the
    smallest exact wire.

    wire='auto': int16 when ``encode_pcm16_exact`` holds (half the bytes),
    else f32; 'pcm16' raises for a bank off the 16-bit grid. The decode
    multiply on the device is exact (a power-of-two scale). Returns
    (tensor_f32, wire_used)."""
    if wire not in ("auto", "f32", "pcm16"):
        raise ValueError(f"unknown td wire {wire!r}")
    device = torch.device(device)
    if wire != "f32":
        q = encode_pcm16_exact(td)
        if q is not None:
            dev = _to_device(torch.from_numpy(q), device)
            return dev.to(torch.float32) * (1.0 / _PCM16_SCALE), "pcm16"
        if wire == "pcm16":
            raise ValueError("pcm16 td wire requested but the bank is not "
                             "on the 16-bit grid (normalized or >16-bit "
                             "source); use wire='f32'")
    host = torch.from_numpy(np.ascontiguousarray(td, np.float32))
    return _to_device(host, device), "f32"


def _to_device(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor's copy on `device`: through pinned memory on CUDA (one
    queued copy), a fresh tensor on the CPU (never a view of the caller's
    array)."""
    if device.type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host.clone()


# -- building blocks ------------------------------------------------------------


def partition_fd(td: torch.Tensor, block: int, parts: int, offset: int,
                 xf) -> torch.Tensor:
    """``ops.partition.partition_spectra`` on the device: [..., L]
    time-domain -> [..., parts, F] complex partition spectra (each
    partition `block` samples zero-padded to 2*block, overlap-save
    layout). Samples past offset + parts*block are EXCLUDED (the host
    version truncates the same way via max_partitions)."""
    lead = tuple(td.shape[:-1])
    length = td.shape[-1]
    keep = max(min(length - offset, parts * block), 0)
    start = min(offset, length)  # offset > length is legal: all zeros
    x = td[..., start: start + keep]
    x = torch.nn.functional.pad(x, (0, parts * block - keep))
    x = x.reshape(lead + (parts, block))
    x = torch.nn.functional.pad(x, (0, block))
    return xf.rfft(x)


def pad_parts(spec: torch.Tensor, pp: int) -> torch.Tensor:
    """Zero-pad the partition axis (-2) to pp (fmajor._pad_p on spectra; a
    zero partition has a zero spectrum, so padding commutes with the FFT
    and is done here, after it — cheaper)."""
    pad = pp - spec.shape[-2]
    if pad == 0:
        return spec
    zeros = spec.new_zeros(spec.shape[:-2] + (pad, spec.shape[-1]))
    return torch.cat([spec, zeros], dim=-2)


def double_reversed_j(spec: torch.Tensor, axis: int) -> torch.Tensor:
    """``fmajor.double_reversed`` on the device: out[j] = spec[(-j) mod
    P], tiled twice along `axis` (one gather; the index is built on the
    device, so no host copy waits for the stream)."""
    p = spec.shape[axis]
    idx = (p - torch.arange(2 * p, device=spec.device)) % p
    return spec.index_select(axis, idx)


def pack_mac_rhs_j(spec: torch.Tensor) -> torch.Tensor:
    """``fmajor.pack_mac_rhs`` on an already partition-padded [K, O, P, F]
    complex spectra: -> [F, 2, P, K*O*2] f32 plane-major MAC rhs (plane 0
    = (br, bi), plane 1 = (-bi, br))."""
    k, o, p, f = spec.shape
    br = spec.real.permute(3, 2, 0, 1)                     # [F, P, K, O]
    bi = spec.imag.permute(3, 2, 0, 1)
    p0 = torch.stack([br, bi], dim=-1)                     # [F, P, K, O, 2]
    p1 = torch.stack([-bi, br], dim=-1)
    return torch.stack([p0, p1], dim=1).reshape(f, 2, p, k * o * 2)


def pack_rev2_j(dbl: torch.Tensor) -> torch.Tensor:
    """``fmajor.pack_spectra_rev2`` taking the already doubled+reversed
    [K, O, 2Pp, F] complex: -> [K, F, O, 2, 2Pp] f32."""
    re = dbl.real.permute(0, 3, 1, 2)                      # [K, F, O, 2Pp]
    im = dbl.imag.permute(0, 3, 1, 2)
    return torch.stack([re, im], dim=3)                    # [K, F, O, 2, 2Pp]


def pack_planar_j(spec: torch.Tensor) -> torch.Tensor:
    """``fmajor.pack_planar_spectra`` on partition-padded [K, O, Pp, F]
    complex: -> [K, O, Pp, F, 2] f32."""
    return torch.stack([spec.real, spec.imag], dim=-1)


# -- the whole bank ----------------------------------------------------------------


def _fmajor_bank(engine, td: torch.Tensor) -> FMajorBank:
    """td [K, O, L] f32 on the engine's device -> the FMajorBank
    engine.prepare_bank would build from host spectra, placeholders
    included."""
    from tpu_audio_torch.engine.fmajor import FMajorBank

    spec = pad_parts(
        partition_fd(td, engine.block, engine.partitions, 0, engine.xf),
        engine.pp)                                         # [K, O, Pp, F]
    dt = engine.mac_dtype

    def placeholder(ndim, dtype=dt):
        return torch.zeros((1,) * ndim, dtype=dtype, device=engine.device)

    # the MAC packs in the MAC dtype (tpu_audio/engine/device_prep.py:
    # 197-221); roll mode's planar spectra stay f32
    allk = engine.mac_strategy == "allk"
    if engine.ring_mode:
        dbl = double_reversed_j(spec, axis=2)              # [K, O, 2Pp, F]
        return FMajorBank(
            mac_rhs=placeholder(4),
            rhs2=pack_mac_rhs_j(dbl).to(dt) if allk else placeholder(4),
            spectra=placeholder(5, torch.float32),
            spectra_rev2=pack_rev2_j(dbl).to(dt))
    return FMajorBank(
        mac_rhs=pack_mac_rhs_j(spec).to(dt) if allk else placeholder(4),
        rhs2=placeholder(4),
        spectra=pack_planar_j(spec),
        spectra_rev2=placeholder(5))


def cascade_columns(engine, td: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """td [K, O, L] f32 on the cascade engine's device -> the (head, tail)
    MAC tensors [F, 2, 2*Pp, KOD] of both stages: the head partitions the
    first 2*B2 samples at the block size, the tail the rest at B2. The
    JAX package packs its tail frequency-minor (``pack_tail_fminor_j``);
    the port keeps fmajor's frequency-major pack for both stages, which
    is what ring_mac reads."""
    head = pad_parts(
        partition_fd(td, engine.block, engine.head_parts, 0, engine.xf1),
        engine.pp1)
    tail = pad_parts(
        partition_fd(td, engine.b2, engine.tail_parts, 2 * engine.b2,
                     engine.xf2),
        engine.pp2)
    return (pack_mac_rhs_j(double_reversed_j(head, axis=2)),
            pack_mac_rhs_j(double_reversed_j(tail, axis=2)))


def _upload(engine, td, wire: str) -> torch.Tensor:
    """[K, O, L] host f32 (or an IRBank) -> the same on the engine's
    device over `wire` (upload_bank_td), after checking the bank size
    against the engine's. Logs the wire used."""
    td = td if isinstance(td, np.ndarray) else bank_time_domain(td)
    if engine.num_irs is not None and td.shape[0] != engine.num_irs:
        raise ValueError(f"bank has {td.shape[0]} IRs, engine was built "
                         f"for num_irs={engine.num_irs}")
    engine.num_irs = td.shape[0]
    dev, used = upload_bank_td(td, wire, engine.device)
    Log.info("device_prep", "bank upload: %d IRs, %.1f MB over the %s wire",
             td.shape[0], td.size * (2 if used == "pcm16" else 4) / 1e6,
             used)
    return dev


def prepare_fmajor_bank_device(engine, td, wire: str = "f32"
                               ) -> FMajorBank:
    """[K, O, L] host f32 (or an IRBank) -> FMajorBank on the engine's
    device, spectra and packs computed there; the samples cross over
    `wire` (upload_bank_td: 'auto', 'f32' or 'pcm16'). Mirrors
    engine.prepare_bank(spectra) to the FFT's rounding."""
    return _fmajor_bank(engine, _upload(engine, td, wire))


def prepare_cascade_bank_device(engine, td, wire: str = "f32"
                                ) -> CascadeBank:
    """[K, O, L] host f32 (or an IRBank) -> CascadeBank on the cascade
    engine's device, both stages' spectra and packs computed there; the
    samples cross over `wire` (upload_bank_td). Mirrors
    engine.prepare_bank(bank) to the FFT's rounding."""
    from tpu_audio_torch.engine.cascade import CascadeBank

    head, tail = cascade_columns(engine, _upload(engine, td, wire))
    return CascadeBank(head_rhs2=head.to(engine.mac_dtype),
                       tail_rhs2=tail.to(engine.mac_dtype))
