"""In-place delay-line shift fused with the all-K partition MAC: the
hand-written Hopper kernel and its plain PyTorch version.

Port of the Pallas TPU kernel ``tpu_audio/ops/pallas_mac.py:mac_shift``,
the MAC of the fmajor engine's roll mode (``tpu_audio/engine/fmajor.py``).
For every frequency bin f and delay-line row vi::

    fdl'[f, vi, c, 0] = x_new[f, vi, c]
    fdl'[f, vi, c, s] = fdl[f, vi, c, s - 1]            (s >= 1, within plane c)
    m[f, vi, kod]     = sum_{c, s} fdl'[f, vi, c, s] * rhs[f, c, s, kod]

``fdl`` keeps the engine's layout ``[F, VI, 2, Pp]`` and ``x_new`` is
``[F, VI, 2, 1]`` (the Pallas kernel took ``[F, 2, VI, P]`` and
``[F, 2, VI, 1]``); ``rhs`` is the natural-order bank ``[F, 2, Pp, KOD]``.

``fdl``, ``x_new`` and ``rhs`` are all float32 or all bfloat16 (the
engine's ``mac_dtype='bf16'``, where the line is stored and shifted in
bf16); m is float32 either way, the products of two bf16 values being
exact in f32 (the JAX engine's bf16 roll mode is the roll plus an einsum
with ``preferred_element_type=float32``, ``tpu_audio/engine/fmajor.py:
920-923``). On the card the bf16 form multiplies on the tensor cores
(``mma.sync``, f32 accumulators), the f32 form on the CUDA cores.

``mac_shift`` writes the shifted line over ``fdl`` IN PLACE — the Pallas
call aliases its delay line in and out (``input_output_aliases={0: 0}``) —
and returns ``(fdl, m)`` with that same tensor. It launches the CUDA kernel
for the operands' dtype (``csrc/mac_shift.cu``) for a CUDA tensor and takes the plain version only
for a CPU tensor. The kernel is compiled at first use and bound with
``ctypes`` (ops/cuda_build.py); nothing CUDA-specific happens at import
time.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_audio_torch.ops.cuda_build import CudaLibrary

LIBRARY = CudaLibrary(
    "mac_shift", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the kernel's instantiation per operand dtype, and the Pp it must divide
ENTRIES = {torch.float32: ("launch", 2), torch.bfloat16: ("bf16_launch", 4)}


def _check(fdl: torch.Tensor, x_new: torch.Tensor, rhs: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    for name, t in (("fdl", fdl), ("x_new", x_new), ("rhs", rhs)):
        if not isinstance(t, torch.Tensor) or t.dtype not in ENTRIES:
            raise TypeError(f"{name} must be a float32 or bfloat16 tensor, "
                            f"got {getattr(t, 'dtype', type(t))}")
    if not fdl.dtype == x_new.dtype == rhs.dtype:
        raise TypeError(f"fdl, x_new and rhs must share a dtype, got "
                        f"{fdl.dtype}, {x_new.dtype}, {rhs.dtype}")
    if not (fdl.device == x_new.device == rhs.device):
        raise ValueError(f"fdl, x_new and rhs must share a device, got "
                         f"{fdl.device}, {x_new.device}, {rhs.device}")
    if fdl.dim() != 4 or fdl.shape[2] != 2:
        raise ValueError(f"fdl must be [F, VI, 2, Pp], got {tuple(fdl.shape)}")
    f, vi, _, pp = fdl.shape
    if tuple(x_new.shape) != (f, vi, 2, 1):
        raise ValueError(f"x_new must be [F, VI, 2, 1] = [{f}, {vi}, 2, 1], "
                         f"got {tuple(x_new.shape)}")
    if rhs.dim() != 4 or rhs.shape[:3] != (f, 2, pp):
        raise ValueError(f"rhs must be [F, 2, Pp, KOD] = [{f}, 2, {pp}, KOD], "
                         f"got {tuple(rhs.shape)}")
    kod = rhs.shape[3]
    if min(f, vi, pp, kod) == 0 or kod % 4:
        raise ValueError(f"mac_shift needs nonzero sizes and KOD % 4 == 0, "
                         f"got F={f} VI={vi} Pp={pp} KOD={kod}")
    if not (fdl.is_contiguous() and x_new.is_contiguous()
            and rhs.is_contiguous()):
        raise ValueError("fdl, x_new and rhs must be contiguous")
    if rhs.data_ptr() % 16:
        raise ValueError("rhs must be 16-byte aligned")
    if x_new.untyped_storage().data_ptr() == fdl.untyped_storage().data_ptr():
        raise ValueError("x_new must not share memory with fdl (fdl is "
                         "written while x_new is read)")


def mac_shift_reference(fdl: torch.Tensor, x_new: torch.Tensor,
                        rhs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, pure: returns (the shifted line as a new
    tensor in the line's dtype, m), one batched-per-bin contraction over q
    = c*Pp + s, in float64 for float64 inputs and in float32 otherwise
    (bf16 operands are upcast first: their products are exact in f32)."""
    f, vi, _, pp = fdl.shape
    shifted = torch.cat([x_new, fdl[..., :-1]], dim=-1)
    lhs = shifted
    if fdl.dtype == torch.bfloat16:
        lhs, rhs = shifted.float(), rhs.float()
    m = torch.einsum("fvq,fqk->fvk", lhs.reshape(f, vi, 2 * pp),
                     rhs.reshape(f, 2 * pp, rhs.shape[3]))
    return shifted, m


def mac_shift(fdl: torch.Tensor, x_new: torch.Tensor, rhs: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shift `fdl` in place and return (fdl, m [F, VI, KOD] f32).

    A CUDA tensor launches the kernel's instantiation for its dtype on the
    current stream (no sync) or raises (the kernel also needs an even Pp in
    f32, a Pp divisible by 4 in bf16); a CPU tensor takes
    mac_shift_reference, at any Pp, and copies the shifted line back into
    `fdl`."""
    _check(fdl, x_new, rhs)
    if fdl.device.type == "cpu":
        shifted, m = mac_shift_reference(fdl, x_new, rhs)
        fdl.copy_(shifted)
        return fdl, m
    if fdl.device.type != "cuda":
        raise ValueError(f"mac_shift runs on CUDA or CPU, not {fdl.device}")
    f, vi, _, pp = fdl.shape
    kod = rhs.shape[3]
    # the kernel copies 16-byte vectors of each fdl row: rows must start on
    # 16 bytes (the engine pads Pp to a multiple of 8)
    entry, multiple = ENTRIES[fdl.dtype]
    if pp % multiple or fdl.data_ptr() % 16:
        raise ValueError(f"the mac_shift kernel needs an even Pp (a "
                         f"multiple of 4 in bf16) and a 16-byte aligned "
                         f"fdl, got Pp={pp} in {fdl.dtype}")
    m = torch.empty((f, vi, kod), dtype=torch.float32, device=fdl.device)
    with torch.cuda.device(fdl.device):
        stream = torch.cuda.current_stream().cuda_stream
        LIBRARY.launch(fdl.data_ptr(), x_new.data_ptr(), rhs.data_ptr(),
                       m.data_ptr(), f, vi, pp, kod, stream, entry=entry,
                       context=f"{fdl.dtype} F={f} VI={vi} Pp={pp} "
                               f"KOD={kod}")
    mac_shift.launches += 1
    if fdl.dtype == torch.bfloat16:
        mac_shift.launches_bf16 += 1
    return fdl, m


# launches of the kernel, and of its bf16 instantiation among them
mac_shift.launches = 0
mac_shift.launches_bf16 = 0
