"""Inputs of a run, made from its seed: the IR bank and the block pool.

Frozen copies, made here so that later changes to the repository's other
scripts cannot move the yardstick:

- the IR law of ``chip_smoke.py:synthetic_bank``: exponential-decay noise,
  ``env = exp(-t / (decay * L))`` times a gain, one [2, L] pair per IR;
- the block pool of ``chip_smoke.py:CycleSource``: a few distinct
  pre-drawn per-voice noise blocks, so that the source costs a lookup and
  not a million normal draws per block. Here the order in which the pool's
  blocks are handed out is drawn from the seed as well, so that no two
  stretches of a voice's input are alike.

The IRs and the pool are drawn on the run's device with a
``torch.Generator`` in one call each, then copied to the host, where the
model's bank and the source take them.
"""

from __future__ import annotations

import numpy as np
import torch

ORDER_LENGTH = 1 << 16   # block order entries; the source wraps past them


def _child_seeds(seed: int) -> list[int]:
    """Four independent 64-bit seeds (IRs, pool, order, the sample the
    comparison draws) from one run seed (any integer, negative or beyond
    32 bits included)."""
    seq = np.random.SeedSequence(seed % (1 << 128))
    return [int(s) for s in seq.generate_state(4, np.uint64)]


def make_irs(seed: int, num_irs: int, seconds: float, rate: int,
             decay: float, gain: float, device) -> np.ndarray:
    """[K, 2, L] float32 IRs on the host, drawn on `device`."""
    length = int(seconds * rate)
    gen = torch.Generator(device=device)
    gen.manual_seed(_child_seeds(seed)[0])
    noise = torch.randn((num_irs, 2, length), generator=gen, device=device)
    t = torch.arange(length, dtype=torch.float32, device=device)
    env = torch.exp(-t / (decay * length)) * gain
    return (noise * env).cpu().numpy()


def make_pool(seed: int, blocks: int, voices: int, block: int,
              amplitude: float, device) -> np.ndarray:
    """[N, V, 2, B] float32 blocks of noise at `amplitude` on the host,
    drawn on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_child_seeds(seed)[1])
    pool = torch.randn((blocks, voices, 2, block), generator=gen,
                       device=device)
    return (pool * amplitude).cpu().numpy()


def block_order(seed: int, pool_blocks: int) -> np.ndarray:
    """The pool index of stream block n is ``order[n % ORDER_LENGTH]``."""
    rng = np.random.default_rng(_child_seeds(seed)[2])
    return rng.integers(0, pool_blocks, size=ORDER_LENGTH).astype(np.int64)


def sample_rng(seed: int) -> np.random.Generator:
    """The generator from which the comparison draws its voices and
    blocks."""
    return np.random.default_rng(_child_seeds(seed)[3])
