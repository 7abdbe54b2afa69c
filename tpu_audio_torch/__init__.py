"""tpu-audio on PyTorch and CUDA: the port of ``tpu_audio`` to NVIDIA GPUs.

The package mirrors ``tpu_audio``'s module tree and names. It imports
``torch`` and never ``jax``: every module here stands alone, and the JAX
package is the reference that the port's tests hold it against. The
device-side hot loop (the fmajor engine's ring-pointer partition MAC) is a
hand-written CUDA kernel for Hopper (``csrc/ring_mac.cu``), built with
``nvcc`` into ``_build/`` at first use.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
