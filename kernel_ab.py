#!/usr/bin/env python3
"""Time another source of a port kernel against the checkout's, on one GPU.

    python3 kernel_ab.py ring_mac=OLD/ring_mac.cu [mac_shift=OLD/mac_shift.cu]
        [--dtype f32|bf16] [--rounds 3] [--time-only]

Each KERNEL=PATH names a kernel of tpu_audio_torch/csrc and another source
exporting the same C interface (an earlier version of it, say: unpack the
earlier csrc/ directory whole into a git-ignored directory, so that the
source finds its own headers beside it). Both are built (one nvcc per
source, all started together), checked once against the float64 plain
version at every shape, within 1e-5 of the output's scale (mac_shift's
shifted line bit for bit), and timed there with CUDA events, interleaved
other, this, this, other, `--rounds` times, 200 launches a run.

`--dtype` picks the instantiation: f32 (`<name>_launch`, the default) or
bf16 (`<name>_bf16_launch`, bf16 operands, f32 m). The shapes are the main
path's at 64 voices, 4 s IRs and 256-frame blocks (F=257, VI=128, Pp=696)
at KOD 16, 36 and 64 (4, 9 and 16 IRs) and, for ring_mac, the other
shapes the paths give it (KOD 16 unless named): in f32 the cascade's head
and tail at 64 and 1024 voices (chip_smoke.py's CASCADE_SHAPES), the
512-voice bounce lanes' tail, a 64-voice mesh shard (voice = 2: VI=64) at
KOD 16 and 64, and the bounce's 512 virtual voices (VI=1024); in bf16 the
2048-voice cascade's head and tail (CASCADE_2048_SHAPES) and the tails at
64 and 1280 voices (the mesh's 2560-voice run); for mac_shift, in both
dtypes, the mesh's roll shards at Pp=348 (VI=128 in f32 over part = 2,
VI=64 in bf16 over voice = 2 x part = 2; KOD 16), VI=64 at Pp=696 (a
32-voice roll, or a 64-voice one over voice = 2) at KOD 16 and 64, VI=192
(96 voices, chip_smoke.py's phase 33) and VI=8 (4 voices) at KOD 16.
Every shape also reports whether the two sources' outputs are
bit-identical, and in f32 a difference is an error: the f32 kernels keep
their results bit for bit (`tests/test_torch_cuda.py::
test_f32_kernels_are_unchanged_at_a_fixed_seed`). Prints every run, the
medians and the card's name and power limit; exits non-zero without a card
or when a build disagrees with the plain version. `--time-only` skips both
checks of the other source, for diagnostic builds that leave out part of
the work on purpose (the copies, say, or the product).
"""

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

from chip_smoke import (BLOCK, BOUNCE_SEGMENTS, CAS_PP2, CAS_RATIO,
                        CASCADE_2048_SHAPES, CASCADE_SHAPES, NUM_IRS,
                        cuda_ms)

F, VI, PP = 257, 128, 696
KODS = (16, 36, 64)
W = 5
REPS = 200
ENTRIES = {"f32": "launch", "bf16": "bf16_launch"}


def cascade_tail(voices):
    """(F, VI, Pp) of one group's tail on the ratio-16 cascade."""
    return CAS_RATIO * BLOCK + 1, 2 * voices // CAS_RATIO, CAS_PP2


def shapes(name, dtype):
    """(label, F, VI, Pp, KOD) for one kernel and dtype."""
    out = [(f"kod{kod}", F, VI, PP, kod) for kod in KODS]
    if name == "mac_shift":
        return out + [("shard_128v_pp348", F, VI, PP // 2, 16),
                      ("shard_64v_pp348", F, VI // 2, PP // 2, 16),
                      ("vi64_kod16", F, VI // 2, PP, 16),
                      ("vi64_kod64", F, VI // 2, PP, 64),
                      ("vi192_kod16", F, 3 * VI // 2, PP, 16),
                      ("vi8_kod16", F, 8, PP, 16)]
    if name != "ring_mac":
        return out
    kod = 4 * NUM_IRS
    if dtype == "f32":
        out += [(label, *shape, kod) for label, shape
                in CASCADE_SHAPES.items()]
        out += [("tail_512v", *cascade_tail(512), kod),
                *((f"shard_64v_kod{k}", F, VI // 2, PP, k) for k in (16, 64)),
                ("bounce_512v", F, VI * BOUNCE_SEGMENTS, PP, kod)]
    else:
        out += [(label, *shape, kod) for label, shape
                in CASCADE_2048_SHAPES.items()]
        out += [("tail_64v", *cascade_tail(64), kod),
                ("tail_1280v", *cascade_tail(1280), kod)]
    return out


def operand(rng, shape, dtype, dev):
    import torch

    t = torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=dev)
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def ring_mac_case(dev, dtype, f, vi, pp, kod, rng):
    """(launch(library), check(library) -> (error / scale, outputs)) for
    ring_mac."""
    import torch

    from tpu_audio_torch.ops.ring_mac import ring_mac_reference

    fdl = operand(rng, (f, vi, 2, pp), dtype, dev)
    rhs2 = operand(rng, (f, 2, 2 * pp, kod), dtype, dev)
    w = torch.tensor(W, dtype=torch.int32, device=dev)
    m = torch.empty((f, vi, kod), device=dev)
    want = ring_mac_reference(W, fdl.double(), rhs2.double())
    entry = ENTRIES[dtype]

    def launch(lib):
        lib.launch(w.data_ptr(), fdl.data_ptr(), rhs2.data_ptr(), m.data_ptr(),
                   f, vi, pp, kod, torch.cuda.current_stream().cuda_stream,
                   entry=entry)

    def check(lib):
        launch(lib)
        torch.cuda.synchronize()
        err = ((m.double() - want).abs().max() / want.abs().max()).item()
        return err, (m.clone(),)

    return launch, check


def mac_shift_case(dev, dtype, f, vi, pp, kod, rng):
    """(launch(library), check(library) -> (error / scale, outputs)) for
    mac_shift; the check restores the line first, since every launch
    shifts it, and returns an infinite error for a shifted line that is
    not the plain version's bit for bit."""
    import torch

    from tpu_audio_torch.ops.mac_shift import mac_shift_reference

    fdl0 = operand(rng, (f, vi, 2, pp), dtype, dev)
    fdl = fdl0.clone()
    xn = operand(rng, (f, vi, 2, 1), dtype, dev)
    rhs = operand(rng, (f, 2, pp, kod), dtype, dev)
    m = torch.empty((f, vi, kod), device=dev)
    want_fdl, _ = mac_shift_reference(fdl0, xn, rhs)
    _, want = mac_shift_reference(fdl0.double(), xn.double(), rhs.double())
    entry = ENTRIES[dtype]

    def launch(lib):
        lib.launch(fdl.data_ptr(), xn.data_ptr(), rhs.data_ptr(), m.data_ptr(),
                   f, vi, pp, kod, torch.cuda.current_stream().cuda_stream,
                   entry=entry)

    def check(lib):
        fdl.copy_(fdl0)
        launch(lib)
        torch.cuda.synchronize()
        if not torch.equal(fdl, want_fdl):
            return float("inf"), ()
        err = ((m.double() - want).abs().max() / want.abs().max()).item()
        return err, (m.clone(), fdl.clone())

    return launch, check


CASES = {"ring_mac": ring_mac_case, "mac_shift": mac_shift_case}


def same_bits(a, b):
    """Whether two tuples of tensors hold the same bits."""
    import torch

    return len(a) == len(b) and all(
        torch.equal(x.view(torch.uint8), y.view(torch.uint8))
        for x, y in zip(a, b))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("pairs", nargs="+", metavar="KERNEL=PATH")
    parser.add_argument("--dtype", choices=sorted(ENTRIES), default="f32")
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
    failed = []
    for name, other, this_lib in pairs:
        for label, f, vi, pp, kod in shapes(name, args.dtype):
            tag = f"{name} {args.dtype} {label} [F={f} VI={vi} Pp={pp} " \
                  f"KOD={kod}]"
            launch, check = CASES[name](dev, args.dtype, f, vi, pp, kod, rng)
            outs = {}
            for role, lib in (("other", other), ("this", this_lib)):
                err, outs[role] = check(lib)
                if role == "other" and args.time_only:
                    continue
                print(f"{tag} {role}: max_abs_err / scale {err:.3e} "
                      f"(limit 1e-5)")
                if not err <= 1e-5:
                    failed.append(f"{tag} {role} disagrees with the plain "
                                  f"version")
            same = same_bits(outs["other"], outs["this"])
            print(f"{tag}: outputs {'bit-identical' if same else 'differ'}")
            if args.dtype == "f32" and not same and not args.time_only:
                failed.append(f"{tag}: outputs differ")
            runs = {"other": [], "this": []}
            for _ in range(args.rounds):
                for role in ("other", "this", "this", "other"):
                    lib = other if role == "other" else this_lib
                    runs[role].append(
                        cuda_ms(lambda: launch(lib), REPS) * 1e3)
            for role, times in runs.items():
                print(f"{tag} {role} us: median {np.median(times):.2f}, runs "
                      f"{' '.join(f'{t:.2f}' for t in times)} [{card}]")
            del launch, check, outs
            torch.cuda.empty_cache()
    for line in failed:
        print(f"kernel_ab: {line}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
