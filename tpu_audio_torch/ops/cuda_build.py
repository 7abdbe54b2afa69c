"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel lives in ``tpu_audio_torch/csrc/<name>.cu`` behind a plain C
interface: ``int <name>_launch(...)`` returns a cudaError_t and
``const char* <name>_error_string(int)`` names it; a kernel with another
instantiation exports it beside, as ``int <name>_<entry>(...)`` with the
same parameters (``ring_mac_bf16_launch``). The source is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``tpu_audio_torch/_build/``, keyed by a hash of the source, the headers
beside it and in ``csrc/`` and the flags (a stale build is never loaded), and
bound with ``ctypes``. Nothing
happens at import time: a library is built at its first launch, or ahead
of time by ``build_all``, which starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One kernel source: its build, its ctypes binding and its launch.

    `argtypes` are the ctypes types of ``<name>_launch``'s parameters
    (``ctypes.c_void_p`` for every pointer and the stream, ``ctypes.c_int``
    for every int). `source` defaults to ``csrc/<name>.cu``; another file
    exporting the same C interface (an earlier version of the kernel, to
    time against) builds into a library of its own."""

    def __init__(self, name: str, argtypes: list, source: Path | None = None):
        self.name = name
        self.source = Path(source) if source else CSRC / f"{name}.cu"
        self.argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._lib = None
        self._entries = {}

    def digest(self) -> str:
        """Hash of the source, every header it may include (those beside
        it, which nvcc finds first, and csrc's) and the flags: what a build
        depends on."""
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted({*self.source.parent.glob("*.cuh"),
                              *CSRC.glob("*.cuh")}):
            digest.update(header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return digest.hexdigest()[:16]

    def build(self) -> tuple[Path, float, str]:
        """Compile the source unless a build of this exact source, headers
        and flags exists. Returns (library path, seconds spent compiling —
        0.0 when the library already existed, the ptxas report)."""
        lib = BUILD_DIR / f"lib{self.name}_{self.digest()}.so"
        if lib.exists():
            return lib, 0.0, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(self.source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{self.source}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return lib, time.perf_counter() - t0, proc.stderr

    def _load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, _, _ = self.build()
                lib = ctypes.CDLL(str(path))
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = lib
        return self._lib

    def _entry(self, entry: str):
        """The bound ``<name>_<entry>`` function of the loaded library."""
        fn = self._entries.get(entry)
        if fn is None:
            fn = getattr(self._load(), f"{self.name}_{entry}")
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._entries[entry] = fn
        return fn

    def launch(self, *args, context: str = "", entry: str = "launch") -> None:
        """Call ``<name>_<entry>(*args)`` (``<name>_launch`` by default);
        raise RuntimeError on a nonzero cudaError_t (a refused launch never
        runs, and a later synchronize would not report it)."""
        err = self._entry(entry)(*args)
        lib = self._lib
        if err != 0:
            what = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {err} ({what}; {context})")


def build_all(libraries: list[CudaLibrary]
              ) -> list[tuple[Path, float, str]]:
    """Build every library at once, one nvcc process each; results in the
    order given."""
    with ThreadPoolExecutor(max_workers=max(1, len(libraries))) as pool:
        return list(pool.map(CudaLibrary.build, libraries))
