"""One traced run of each of the first two deferred cells (PERF.md, Open
questions): no cell of BENCHMARK.json, a probe of how idle the card is.

    python3 portbench/deferred.py --seed <n>

- ``ring_f32.bounce_64v``: ``render_offline`` of 64 per-voice stems of 30 s
  of noise at 0.01 with the tail, auto segments, the CLI's pcm16 output
  wire, on the fmajor_ring_f32 configuration; one warm bounce of 2 s
  first, then the timed one under torch.profiler and BounceStages;
- ``ring_f32.stream_64v``: the ring_f32.stream_1024v cell's path at 64
  voices, one traced run through the harness.

Prints one JSON line per probe with the device's busy and window seconds
and its idle share.
"""

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
os.environ.setdefault("TPU_AUDIO_LOG", "warn")

BOUNCE_VOICES, BOUNCE_SECONDS = 64, 30.0


def bounce(seed: int, device) -> dict:
    import torch

    from portbench import harness, synth, trace
    from portbench.bounce_stages import BounceStages
    from portbench.generators.closed_stream import _set_params
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime import offline

    cfg = harness.resolve(harness.load_manifest(),
                          "ring_f32.stream_1024v").config
    rate, law = cfg["sample_rate"], cfg["bank"]
    irs = synth.make_irs(seed, law["num_irs"], law["ir_seconds"], rate,
                         law["decay"], law["gain"], device)
    bank = IRBank(sample_rate=rate)
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=BOUNCE_VOICES,
                              block=cfg["block"], sample_rate=rate,
                              device=device, **cfg["model"])
    _set_params(model.control, cfg["params"], len(irs))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = (torch.randn((BOUNCE_VOICES, 2, int(BOUNCE_SECONDS * rate)),
                     generator=gen, device=device) * 0.01).cpu().numpy()
    model.render_offline(x[..., : 2 * rate], wire="pcm16")
    torch.cuda.synchronize()
    probe = trace.Probe(device)
    slice_ = trace.Slice(probe)
    with BounceStages(offline) as stages:
        slice_.start()
        t0 = time.perf_counter()
        model.render_offline(x, wire="pcm16")
        wall = time.perf_counter() - t0
        slice_.stop()
    prof = slice_.summary()
    return {"probe": "ring_f32.bounce_64v",
            **stages.report(wall, BOUNCE_SECONDS, BOUNCE_VOICES),
            "busy_s": prof["busy_s"], "window_s": prof["window_s"],
            "device_idle_pct": 100 * (1 - prof["busy_s"] / prof["window_s"]),
            "top_ops": harness.breakdown(prof)["device_ops"][:5]}


def stream64(seed: int, device) -> dict:
    from portbench import harness

    cell = harness.resolve(harness.load_manifest(), "ring_f32.stream_1024v")
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.traffic["voices"] = 64
    result = harness.run_cell(cell, seed, 5.0, True, device, T_PROC)
    return {"probe": "ring_f32.stream_64v", **result}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()
    from portbench import harness

    harness.pin_host_threads()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    print(json.dumps(bounce(args.seed, device)), flush=True)
    print(json.dumps(stream64(args.seed + 1, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
