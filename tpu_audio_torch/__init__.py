"""tpu-audio on PyTorch and CUDA: the port of ``tpu_audio`` to NVIDIA GPUs.

The package mirrors ``tpu_audio``'s module tree and names. It imports
``torch`` and never ``jax``: every module here stands alone, and the JAX
package is the reference that the port's tests hold it against. The
device-side hot loops (the fmajor engine's all-K partition MAC: ring mode's
``csrc/ring_mac.cu``, roll mode's fused shift + MAC ``csrc/mac_shift.cu``)
are hand-written CUDA kernels for Hopper, built with ``nvcc`` into
``_build/`` at first use.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
