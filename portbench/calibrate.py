"""Readings from which the comparison's limits are set.

    python3 portbench/calibrate.py --workload <cell> --seeds 12
        --control-seeds 3 --seconds 5 --first-seed 1000

runs the cell's timed path on each seed in one process (each seed's own
bank, pool and state, at the cell's own size and load, a window of
`--seconds`), judges it as a run does, and on the first `--control-seeds`
seeds judges the control too: the reference computed in the precision
the configuration names under ``control``, put in the port's place, over
the same sample. One JSON line per seed and judge, then a summary: the
largest reading of the port and the smallest of the control per number.
Needs a CUDA card; it is no cell of BENCHMARK.json.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("TPU_AUDIO_LOG", "warn")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--first-seed", type=int, default=1000)
    args = parser.parse_args()

    from portbench import harness

    harness.pin_host_threads()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    cell = harness.resolve(harness.load_manifest(), args.workload)
    gen = harness.generator(cell)
    device = torch.device("cuda", 0)
    port, control = {}, {}
    for n in range(args.seeds):
        seed = args.first_seed + n * 7919 + (n % 3) * (1 << 31)
        run = gen.run(cell, seed, args.seconds, False, device,
                      time.perf_counter())
        state = run.judge_inputs["rng"].bit_generator.state
        judges = [None]
        if n < args.control_seeds:
            judges.append(cell.config["control"])
        for which in judges:
            run.judge_inputs["rng"].bit_generator.state = state
            t0 = time.perf_counter()
            verdict = gen.judge(run, cell, control=which)
            readings = {name: value for name, value, _ in verdict["rows"]}
            into = port if which is None else control
            for name, value in readings.items():
                into.setdefault(name, []).append(value)
            print(json.dumps({"seed": seed, "judge": which or "port",
                              "correct": verdict["correct"],
                              "blocks": len(run.deliver_stamps),
                              "judge_s": time.perf_counter() - t0,
                              **readings}), flush=True)
    summary = {"port_max": {k: max(v) for k, v in port.items()},
               "control_min": {k: min(v) for k, v in control.items()},
               "device": torch.cuda.get_device_name(device)}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
