"""Ring-pointer all-K partition MAC: the hand-written Hopper kernel and its
plain PyTorch version.

Port of the Pallas TPU kernel ``tpu_audio/ops/pallas_mac.py:ring_mac``, the
MAC of the fmajor engine's ring mode (``tpu_audio/engine/fmajor.py``). For
every frequency bin f, delay-line row vi and bank output column kod::

    m[f, vi, kod] = sum_{c, s} fdl[f, vi, c, s] * rhs2[f, c, Pp - w + s, kod]

with ``w = wptr mod Pp`` the newest ring slot. ``fdl`` keeps the engine's
layout ``[F, VI, 2, Pp]`` (the Pallas kernel took ``[F, 2, VI, Pp]``);
``rhs2`` is the doubled, time-reversed bank ``[F, 2, 2*Pp, KOD]``.

``fdl`` and ``rhs2`` are both float32 or both bfloat16 (the engines'
``mac_dtype='bf16'``); m is float32 either way. The JAX engine runs the
bf16 MAC as an einsum on bf16 operands with ``preferred_element_type=
float32`` (``tpu_audio/engine/fmajor.py:908-923``): the products of two
bf16 values are exact in f32, so the bf16 form is the f32 MAC of the
operands upcast, which is what the plain version computes. On the card
the bf16 form multiplies on the tensor cores (``mma.sync`` bf16 operands,
f32 accumulators, each 32-q chunk's sum added into f32 totals), the f32
form on the CUDA cores in full f32.

``ring_mac`` launches the CUDA kernel for the operands' dtype
(``csrc/ring_mac.cu``: one pass over the delay line at every KOD <= 64,
whatever the line's length, in row tiles that follow VI: 128 rows when VI
is a multiple of 128, smaller tiles, or several bins to a tile, below) for
a CUDA tensor and takes the plain version only for a CPU tensor. The kernel is compiled at first use and bound with
``ctypes`` (ops/cuda_build.py); nothing CUDA-specific happens at import
time.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_audio_torch.ops.cuda_build import CudaLibrary

LIBRARY = CudaLibrary(
    "ring_mac", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# the kernel's instantiation per operand dtype, and the Pp it must divide
ENTRIES = {torch.float32: ("launch", 2), torch.bfloat16: ("bf16_launch", 4)}


def _check(w, fdl: torch.Tensor, rhs2: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if not isinstance(w, torch.Tensor) or w.dtype != torch.int32 \
            or w.numel() != 1:
        raise TypeError("w must be a one-element int32 tensor")
    if fdl.dtype not in ENTRIES or rhs2.dtype != fdl.dtype:
        raise TypeError(f"fdl and rhs2 must be both float32 or both "
                        f"bfloat16, got {fdl.dtype} and {rhs2.dtype}")
    if not (fdl.device == rhs2.device == w.device):
        raise ValueError(f"w, fdl and rhs2 must share a device, got "
                         f"{w.device}, {fdl.device}, {rhs2.device}")
    if fdl.dim() != 4 or fdl.shape[2] != 2:
        raise ValueError(f"fdl must be [F, VI, 2, Pp], got {tuple(fdl.shape)}")
    f, vi, _, pp = fdl.shape
    if rhs2.dim() != 4 or rhs2.shape[:3] != (f, 2, 2 * pp):
        raise ValueError(f"rhs2 must be [F, 2, 2*Pp, KOD] = [{f}, 2, "
                         f"{2 * pp}, KOD], got {tuple(rhs2.shape)}")
    kod = rhs2.shape[3]
    if min(f, vi, pp, kod) == 0 or kod % 4:
        raise ValueError(f"ring_mac needs nonzero sizes and KOD % 4 == 0, "
                         f"got F={f} VI={vi} Pp={pp} KOD={kod}")
    if not (fdl.is_contiguous() and rhs2.is_contiguous()):
        raise ValueError("fdl and rhs2 must be contiguous")
    if fdl.data_ptr() % 16 or rhs2.data_ptr() % 16:
        raise ValueError("fdl and rhs2 must be 16-byte aligned")


def ring_mac_reference(w, fdl: torch.Tensor, rhs2: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version: gather the window rows [Pp - w, 2Pp - w) of
    both planes, then one batched-per-bin contraction over q = c*Pp + s,
    in float64 for float64 inputs and in float32 otherwise: bf16 operands
    are upcast first (their products are exact in f32, as the JAX
    engine's preferred_element_type=float32 einsum takes them). `w` is an
    int or a one-element integer tensor."""
    f, vi, _, pp = fdl.shape
    idx = (pp - w % pp) + torch.arange(pp, device=fdl.device)
    rhs = rhs2.index_select(2, idx.reshape(-1))            # [F, 2, Pp, KOD]
    if fdl.dtype == torch.bfloat16:
        fdl, rhs = fdl.float(), rhs.float()
    return torch.einsum("fvq,fqk->fvk", fdl.reshape(f, vi, 2 * pp),
                        rhs.reshape(f, 2 * pp, rhs2.shape[3]))


def ring_mac(w: torch.Tensor, fdl: torch.Tensor, rhs2: torch.Tensor
             ) -> torch.Tensor:
    """m [F, VI, KOD] f32. `w` is a one-element int32 tensor holding the
    ring slot (any integer; reduced mod Pp) on the tensors' device.

    A CUDA tensor launches the kernel's instantiation for its dtype on the
    current stream (no sync) or raises (the kernel also needs an even Pp
    in f32, a Pp divisible by 4 in bf16); a CPU tensor takes
    ring_mac_reference, at any Pp."""
    _check(w, fdl, rhs2)
    if fdl.device.type == "cpu":
        return ring_mac_reference(w, fdl, rhs2)
    if fdl.device.type != "cuda":
        raise ValueError(f"ring_mac runs on CUDA or CPU, not {fdl.device}")
    f, vi, _, pp = fdl.shape
    kod = rhs2.shape[3]
    # the kernel copies 16-byte vectors of each fdl row: rows must start on
    # 16 bytes (the engine pads Pp to a multiple of 8)
    entry, multiple = ENTRIES[fdl.dtype]
    if pp % multiple:
        raise ValueError(f"the ring_mac kernel needs an even Pp (a "
                         f"multiple of 4 in bf16), got Pp={pp} in "
                         f"{fdl.dtype}")
    m = torch.empty((f, vi, kod), dtype=torch.float32, device=fdl.device)
    with torch.cuda.device(fdl.device):
        stream = torch.cuda.current_stream().cuda_stream
        LIBRARY.launch(w.data_ptr(), fdl.data_ptr(), rhs2.data_ptr(),
                       m.data_ptr(), f, vi, pp, kod, stream, entry=entry,
                       context=f"{fdl.dtype} F={f} VI={vi} Pp={pp} "
                               f"KOD={kod}")
    ring_mac.launches += 1
    if fdl.dtype == torch.bfloat16:
        ring_mac.launches_bf16 += 1
    return m


# launches of the kernel, and of its bf16 instantiation among them
ring_mac.launches = 0
ring_mac.launches_bf16 = 0
