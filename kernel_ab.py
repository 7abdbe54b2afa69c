#!/usr/bin/env python3
"""Time another source of a port kernel against the checkout's, on one GPU.

    python3 kernel_ab.py ring_mac=OLD/ring_mac.cu [mac_shift=OLD/mac_shift.cu]
        [--rounds 3] [--time-only]

Each KERNEL=PATH names a kernel of tpu_audio_torch/csrc and another source
exporting the same C interface (an earlier version of it, say, unpacked from
git into a git-ignored directory). Both are built (one nvcc per source, all
started together), checked once against the float64 plain version at every
64-voice shape, and timed there with CUDA events, interleaved other, this,
this, other, `--rounds` times, 200 launches a run. The shapes are the
main path's at 64 voices, 4 s IRs and 256-frame blocks (F=257, VI=128,
Pp=696) at KOD 16, 36 and 64 (4, 9 and 16 IRs). Prints every run, the
medians, and the card's name and power limit; exits non-zero without a
card or when a build disagrees with the plain version. --time-only skips
the check of the other source, for diagnostic builds that leave out part
of the work on purpose (the copies, say, or the FMAs).
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

from chip_smoke import cuda_ms

F, VI, PP = 257, 128, 696
KODS = (16, 36, 64)
W = 5
REPS = 200


def ring_mac_case(dev, kod, rng):
    """(launch(library), check(library) -> error / scale) for ring_mac."""
    import torch

    from tpu_audio_torch.ops.ring_mac import ring_mac_reference

    fdl = torch.tensor(rng.standard_normal((F, VI, 2, PP), dtype=np.float32),
                       device=dev)
    rhs2 = torch.tensor(rng.standard_normal((F, 2, 2 * PP, kod),
                                            dtype=np.float32), device=dev)
    w = torch.tensor(W, dtype=torch.int32, device=dev)
    m = torch.empty((F, VI, kod), device=dev)
    want = ring_mac_reference(W, fdl.double(), rhs2.double())

    def launch(lib):
        lib.launch(w.data_ptr(), fdl.data_ptr(), rhs2.data_ptr(), m.data_ptr(),
                   F, VI, PP, kod, torch.cuda.current_stream().cuda_stream)

    def check(lib):
        launch(lib)
        torch.cuda.synchronize()
        return ((m.double() - want).abs().max() / want.abs().max()).item()

    return launch, check


def mac_shift_case(dev, kod, rng):
    """(launch(library), check(library) -> error / scale) for mac_shift; the
    check restores the line first, since every launch shifts it."""
    import torch

    from tpu_audio_torch.ops.mac_shift import mac_shift_reference

    fdl0 = torch.tensor(rng.standard_normal((F, VI, 2, PP), dtype=np.float32),
                        device=dev)
    fdl = fdl0.clone()
    xn = torch.tensor(rng.standard_normal((F, VI, 2, 1), dtype=np.float32),
                      device=dev)
    rhs = torch.tensor(rng.standard_normal((F, 2, PP, kod), dtype=np.float32),
                       device=dev)
    m = torch.empty((F, VI, kod), device=dev)
    want_fdl, want = mac_shift_reference(fdl0.double(), xn.double(),
                                         rhs.double())

    def launch(lib):
        lib.launch(fdl.data_ptr(), xn.data_ptr(), rhs.data_ptr(), m.data_ptr(),
                   F, VI, PP, kod, torch.cuda.current_stream().cuda_stream)

    def check(lib):
        fdl.copy_(fdl0)
        launch(lib)
        torch.cuda.synchronize()
        if not torch.equal(fdl.double(), want_fdl):
            return float("inf")
        return ((m.double() - want).abs().max() / want.abs().max()).item()

    return launch, check


CASES = {"ring_mac": ring_mac_case, "mac_shift": mac_shift_case}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("pairs", nargs="+", metavar="KERNEL=PATH")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--time-only", action="store_true",
                        help="do not check the other source's results")
    args = parser.parse_args()
    import torch

    from tpu_audio_torch.ops import mac_shift, ring_mac
    from tpu_audio_torch.ops.cuda_build import CudaLibrary, build_all
    from tpu_audio_torch.utils.device import select_gpu

    this = {"ring_mac": ring_mac.LIBRARY, "mac_shift": mac_shift.LIBRARY}
    pairs = []
    for pair in args.pairs:
        name, _, path = pair.partition("=")
        if name not in CASES or not Path(path).is_file():
            parser.error(f"{pair}: want KERNEL=PATH with KERNEL one of "
                         f"{sorted(CASES)} and PATH a file")
        other = CudaLibrary(name, this[name].argtypes, source=Path(path))
        pairs.append((name, other, this[name]))
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device visible", file=sys.stderr)
        return 1
    dev = select_gpu(verbose=False)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[dev.index]
    print(card)
    libs = list({id(lib): lib for _, other, this_lib in pairs
                 for lib in (other, this_lib)}.values())
    for lib, (path, _, ptxas) in zip(libs, build_all(libs)):
        print(f"built {lib.name} from {lib.source} -> {path.name}")
        for line in ptxas.splitlines():
            if any(key in line for key in ("Function properties",
                                           "registers", "spill")):
                print(f"    {line.strip()}")
    rng = np.random.default_rng(0)
    for name, other, this_lib in pairs:
        for kod in KODS:
            launch, check = CASES[name](dev, kod, rng)
            for role, lib in (("other", other), ("this", this_lib)):
                if role == "other" and args.time_only:
                    continue
                err = check(lib)
                print(f"{name} KOD={kod} {role}: max_abs_err / scale "
                      f"{err:.3e} (limit 1e-5)")
                if not err <= 1e-5:
                    raise AssertionError(f"{name} {role} disagrees with the "
                                         f"plain version at KOD={kod}")
            runs = {"other": [], "this": []}
            for _ in range(args.rounds):
                for role in ("other", "this", "this", "other"):
                    lib = other if role == "other" else this_lib
                    runs[role].append(
                        cuda_ms(lambda: launch(lib), REPS) * 1e3)
            for role, times in runs.items():
                print(f"{name} KOD={kod} {role} us: median "
                      f"{np.median(times):.2f}, runs "
                      f"{' '.join(f'{t:.2f}' for t in times)} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
