"""CUDA device selection.

Counterpart of ``tpu_audio/utils/device.py:select_tpu`` and of the
reference's ``selectGpu()`` (reference src/gpu.cu:38-90): enumerate the
CUDA devices, score each by SM count x cores per SM x clock, log a
property table and make the best one current.

There is no CPU fallback: ``select_gpu`` raises when CUDA is absent. The
CPU runs the port only where a caller passes ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import torch

from tpu_audio_torch.utils.log import Log

# FP32 cores per SM by compute capability (reference smToCores,
# src/gpu.cu:5-36, extended to the architectures after it)
_CORES_PER_SM = {
    (3, 0): 192, (3, 5): 192, (3, 7): 192, (5, 0): 128, (5, 2): 128,
    (5, 3): 128, (6, 0): 64, (6, 1): 128, (6, 2): 128, (7, 0): 64,
    (7, 2): 64, (7, 5): 64, (8, 0): 64, (8, 6): 128, (8, 7): 128,
    (8, 9): 128, (9, 0): 128, (10, 0): 128, (12, 0): 128,
}


def pin_full_f32() -> None:
    """Keep every float32 matrix product and convolution in full float32.

    TF32 keeps ~10 mantissa bits; the engine's value-carrying contractions
    (the MAC, the coefficient mixes, the dry mix) must not round there —
    the counterpart of the JAX engine pinning an explicit precision on
    every contraction."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def device_score(props) -> int:
    cores = _CORES_PER_SM.get((props.major, props.minor), 128)
    clock = getattr(props, "clock_rate", 0) or 1  # kHz where torch has it
    return props.multi_processor_count * cores * clock


def device_summary(index: int, props) -> str:
    return (f"cuda:{index} {props.name} cc={props.major}.{props.minor} "
            f"sms={props.multi_processor_count} "
            f"mem={props.total_memory / 2**30:.1f}GiB")


def select_gpu(verbose: bool = True) -> torch.device:
    """Return the highest-scoring CUDA device and make it current.

    Pins full-f32 math first (pin_full_f32), then raises RuntimeError when
    no CUDA device is visible."""
    pin_full_f32()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible; the port runs on CUDA "
                           "(pass device='cpu' explicitly for the plain "
                           "CPU path)")
    props = [torch.cuda.get_device_properties(i)
             for i in range(torch.cuda.device_count())]
    if verbose:
        Log.info("device", "%d CUDA device(s)", len(props))
        for i, p in enumerate(props):
            Log.newline(device_summary(i, p))
    best = max(range(len(props)), key=lambda i: (device_score(props[i]), -i))
    torch.cuda.set_device(best)
    if verbose:
        Log.info("device", "selected: %s", device_summary(best, props[best]))
    return torch.device("cuda", best)


def resolve_device(device) -> torch.device:
    """None or "cuda" -> select_gpu(); anything else is taken as given
    (full-f32 math pinned either way)."""
    if device is None or str(device) == "cuda":
        return select_gpu(verbose=False)
    pin_full_f32()
    return torch.device(device)
