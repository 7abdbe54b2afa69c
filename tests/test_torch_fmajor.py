"""The port's fmajor engine (tpu_audio_torch/engine/fmajor.py) against the
JAX engine, block for block, on identical banks, inputs and parameters, in
both delay-line modes (ring, roll) and both MAC strategies (allk, selected).

The JAX engine is built with backend="fft" (its default "auto" picks a
matmul DFT at these sizes) so both sides run an FFT. Tolerances: packs are
bit-equal (same numpy code); engine outputs agree to 2e-5 absolute (both
f32, different summation orders in the MAC and the transforms); the golden
against float64 fftconvolve holds to 2e-4 as in tests/test_engine.py.

Ring mode stores the materialized fade snapshot `base` in bfloat16 in both
packages. Both round the same f32 values, but those values differ between
the packages in the last bits, so now and then one entry rounds to the
neighbouring bf16 value (a step of 2^-8 relative); blocks that read a
materialized ring-mode base are held to BF16_ATOL = 2e-4, and the bf16
snapshot itself to one bf16 step of its own scale. Roll mode keeps `base`
in f32 and is held to 2e-5 throughout.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import fmajor as jax_fmajor
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine import fmajor

torch.set_num_threads(1)

ATOL = 2e-5
BF16_ATOL = 2e-4


def _irs(num_irs=3, ir_len=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


class Pair:
    """The same engine geometry in both packages, one bank, one parameter
    set (two ControlPlanes driven identically)."""

    def __init__(self, num_voices=2, block=32, ir_len=300, num_irs=3,
                 seed=0, max_predelay=64, ring=True, mac_strategy="allk",
                 swap_snapshot=True):
        irs = _irs(num_irs, ir_len, seed)
        jbank, tbank = JaxIRBank(), IRBank()
        for ir in irs:
            jbank.append(ir)
            tbank.append(ir)
        self.irs = irs
        p = tbank.max_partitions(block)
        kwargs = dict(max_predelay=max_predelay, ring=ring,
                      mac_strategy=mac_strategy, num_irs=num_irs,
                      swap_snapshot=swap_snapshot)
        self.jax = jax_fmajor.FMajorPartitionedConvolution(
            num_voices, block, p, backend="fft", **kwargs)
        self.port = fmajor.FMajorPartitionedConvolution(
            num_voices, block, p, device="cpu", **kwargs)
        spectra = tbank.partitioned_spectra(block)
        np.testing.assert_array_equal(spectra, jbank.partitioned_spectra(block))
        self.spectra = spectra
        self.jbank = self.jax.prepare_bank(spectra)
        self.tbank = self.port.prepare_bank(spectra)
        self.jcp = JaxControlPlane(num_voices, num_irs, max_predelay)
        self.tcp = ControlPlane(num_voices, num_irs, max_predelay,
                                device="cpu")
        self.v, self.b = num_voices, block
        self.ring = ring
        self.selected = mac_strategy == "selected"
        self.j_steps = {
            "steady": jax.jit(self.jax.step_coef_steady),
            "general": jax.jit(self.jax.step_coef)}
        self.t_steps = {"steady": self.port.step_coef_steady,
                        "general": self.port.step_coef}
        self.j_steady = self.j_steps["steady"]
        if not self.selected:
            self.j_indexed = self.j_steps["indexed"] = jax.jit(
                self.jax.step_coef_indexed)
            self.t_steps["indexed"] = self.port.step_coef_indexed
            self.j_collapse = jax.jit(self.jax.collapse_pure)
        self.j_mcollapse = jax.jit(self.jax.collapse)
        self.j_materialize = jax.jit(self.jax.materialize_base)

    def set(self, **values):
        for cp in (self.jcp, self.tcp):
            for name, value in values.items():
                getattr(cp, name)[:] = value

    def init(self):
        jp = jax.tree.map(jnp.asarray, self.jcp.snapshot())
        return (self.jax.init_converged(self.jbank, jp),
                self.port.init_converged(self.tbank,
                                         self.tcp.snapshot_device()))

    def step(self, jst, tst, x, indexed=False, kind=None):
        """One block on both sides: kind is "steady", "indexed" or
        "general" (the materialized-snapshot fade step)."""
        kind = kind or ("indexed" if indexed else "steady")
        jp = jax.tree.map(jnp.asarray, self.jcp.snapshot())
        tp = self.tcp.snapshot_device()
        jst, jo = self.j_steps[kind](jst, self.jbank, jp, jnp.asarray(x))
        tst, to = self.t_steps[kind](tst, self.tbank, tp, torch.tensor(x))
        self.jcp.end_block()
        self.tcp.end_block()
        return jst, tst, np.asarray(jo), to.numpy()

    def reselect(self, jst, tst, new, materialize=False):
        """A re-select on both sides: collapse_pure, or the materializing
        collapse (with the new selection, which 'selected' re-gathers)."""
        old = self.tcp.select.copy()
        self.set(select=new, vsteps=self.tcp.speed)
        changed = old != self.tcp.select
        new_sel = self.tcp.select.copy()
        if materialize:
            jst = self.j_mcollapse(jst, self.jbank, jnp.asarray(old),
                                   jnp.asarray(changed), jnp.asarray(new_sel))
            tst = self.port.collapse(tst, self.tbank, torch.tensor(old),
                                     torch.tensor(changed),
                                     torch.tensor(new_sel))
            return jst, tst
        jst = self.j_collapse(jst, jnp.asarray(old), jnp.asarray(changed))
        tst = self.port.collapse_pure(tst, torch.tensor(old),
                                      torch.tensor(changed))
        return jst, tst

    def materialize(self, jst, tst):
        return (self.j_materialize(jst, self.jbank),
                self.port.materialize_base(tst, self.tbank))


def _assert_states_close(jst, tst):
    for name in ("fdl", "prev_in", "wet_ring", "coef_a", "coef_c", "base_g",
                 "sel_spectra"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=ATOL, err_msg=name)
    assert int(tst.wptr) == int(jst.wptr)
    np.testing.assert_array_equal(tst.base_pure.numpy(),
                                  np.asarray(jst.base_pure))
    jbase = np.asarray(jst.base).astype(np.float32)
    tbase = tst.base.float().numpy()
    assert tst.base.shape == jst.base.shape
    assert str(tst.base.dtype).split(".")[-1] == str(jst.base.dtype)
    # bf16 (ring): one rounding step of the snapshot's own scale
    tol = (2.0 ** -8 * max(np.abs(jbase).max(), 1e-30)
           if tst.base.dtype == torch.bfloat16 else ATOL)
    np.testing.assert_allclose(tbase, jbase, atol=tol, err_msg="base")


def test_packs_equal_the_jax_packs():
    rng = np.random.default_rng(1)
    k, o, p, f = 3, 2, 10, 17
    spectra = (rng.standard_normal((k, o, p, f))
               + 1j * rng.standard_normal((k, o, p, f))).astype(np.complex64)
    np.testing.assert_array_equal(fmajor.pack_mac_rhs(spectra, 16),
                                  jax_fmajor.pack_mac_rhs(spectra, 16))
    np.testing.assert_array_equal(fmajor.double_reversed(spectra, 2),
                                  jax_fmajor.double_reversed(spectra, 2))
    np.testing.assert_array_equal(fmajor.pack_spectra_rev2(spectra, 16),
                                  jax_fmajor.pack_spectra_rev2(spectra, 16))
    pair = Pair()  # P = 10 partitions padded to Pp = 16
    assert pair.port.pp == pair.jax.pp == 16
    np.testing.assert_array_equal(pair.tbank.rhs2.numpy(),
                                  np.asarray(pair.jbank.rhs2))
    assert pair.tbank.num_irs == pair.jbank.num_irs == 3
    carried = fmajor.bank_from_numpy(
        device="cpu", **{f_.name: np.asarray(getattr(pair.jbank, f_.name))
                         for f_ in fields(pair.jbank)})
    np.testing.assert_array_equal(carried.rhs2.numpy(),
                                  np.asarray(pair.jbank.rhs2))


def test_init_state_layouts_match_jax():
    pair = Pair()
    jst = pair.jax.init_state()
    tst = pair.port.init_state()
    for name in ("fdl", "prev_in", "wet_ring", "coef_a", "coef_c", "wptr",
                 "base_g", "base_pure"):
        j, t = np.asarray(getattr(jst, name)), getattr(tst, name).numpy()
        assert t.shape == j.shape and t.dtype == j.dtype, name
        np.testing.assert_array_equal(t, j, err_msg=name)
    assert pair.port.t_modulus == pair.jax.t_modulus
    assert pair.port.ring_slots == pair.jax.ring_slots


def test_steady_matches_jax_block_for_block_past_a_wrap():
    """Nonzero per-voice predelays (block and sub-block parts), wet and dry
    pans, per-channel selections; driven past two wraps of the block
    counter (t_modulus = lcm(Pp, ring slots) = 16 here)."""
    pair = Pair()
    pair.set(wet=0.8, dry=0.2, level=0.9,
             predelay=[[17, 3], [40, 0]],
             pan_wet=[[0.3, -0.4], [-1.0, 0.5]],
             pan_dry=[[-0.2, 0.6], [0.0, 0.0]],
             select=[[0, 1], [2, 0]])
    jst, tst = pair.init()
    rng = np.random.default_rng(2)
    n = 2 * pair.port.t_modulus + 5
    for t in range(n):
        x = (rng.standard_normal((2, 2, 32)) * 0.05).astype(np.float32)
        jst, tst, jo, to = pair.step(jst, tst, x)
        np.testing.assert_allclose(to, jo, atol=ATOL, err_msg=f"block {t}")
    assert int(tst.wptr) == n % pair.port.t_modulus
    _assert_states_close(jst, tst)


def test_collapse_pure_and_indexed_fade_match_jax_through_interrupts():
    """A re-select from converged state, an interrupting re-select mid-fade
    (the span grows to a 2-entry mixture), a third re-select of one channel
    only, then the decay back to the steady step."""
    pair = Pair()
    pair.set(wet=0.7, dry=0.1, speed=6, predelay=[[5, 5], [33, 33]],
             pan_wet=[[0.2, -0.2], [0.0, 0.4]])
    jst, tst = pair.init()
    rng = np.random.default_rng(3)
    events = {3: [[1, 1], [2, 2]], 6: [[2, 0], [0, 1]], 9: [[2, 0], [0, 2]]}
    for t in range(90):
        if t in events:
            jst, tst = pair.reselect(jst, tst, events[t])
            _assert_states_close(jst, tst)
        x = (rng.standard_normal((2, 2, 32)) * 0.05).astype(np.float32)
        # the last fade has decayed below 1e-6 by block 80
        jst, tst, jo, to = pair.step(jst, tst, x, indexed=3 <= t < 80)
        np.testing.assert_allclose(to, jo, atol=ATOL, err_msg=f"block {t}")
    assert float(tst.coef_a.max()) < 1e-6
    _assert_states_close(jst, tst)


def test_resumes_from_a_jax_mid_fade_state():
    """state_from_numpy carries a JAX state captured mid-fade (span
    coefficients, coef_a/coef_c, ring pointer, wet ring) into the port,
    which then continues block for block with the JAX engine."""
    pair = Pair(seed=4)
    pair.set(wet=0.9, speed=20, predelay=[[70, 0], [0, 9]])
    jst = pair.jax.init_converged(
        pair.jbank, jax.tree.map(jnp.asarray, pair.jcp.snapshot()))
    rng = np.random.default_rng(5)
    for t in range(12):
        if t in (4, 7):
            old = pair.jcp.select.copy()
            pair.set(select=(old + 1) % 3, vsteps=20)
            jst = pair.j_collapse(jst, jnp.asarray(old),
                                  jnp.asarray(np.ones((2, 2), bool)))
        x = (rng.standard_normal((2, 2, 32)) * 0.05).astype(np.float32)
        jst, _ = pair.j_indexed(jst, pair.jbank,
                                jax.tree.map(jnp.asarray, pair.jcp.snapshot()),
                                jnp.asarray(x))
        pair.jcp.end_block()
        pair.tcp.end_block()  # keep the port's countdown in step
    assert float(np.asarray(jst.coef_a).max()) > 0.1  # a fade is in flight
    tst = fmajor.state_from_numpy(
        device="cpu", **{f.name: np.asarray(getattr(jst, f.name))
                         for f in fields(jst)})
    _assert_states_close(jst, tst)
    for t in range(20):
        x = (rng.standard_normal((2, 2, 32)) * 0.05).astype(np.float32)
        jst, tst, jo, to = pair.step(jst, tst, x, indexed=True)
        np.testing.assert_allclose(to, jo, atol=ATOL, err_msg=f"block {t}")


def _golden(x, ir, wet, pan_wet, level, predelay, dry, pan_dry):
    """float64 offline composition for one voice at constant parameters
    (after tests/test_engine.py:expected_offline): channel i's IR pair
    convolves input i, wet pan x level per output, wet delayed by the
    predelay of channel 0, clamped; the dry 2x2 pan mix added after."""
    t = x.shape[-1]
    out = np.zeros((2, t))
    for o in range(2):
        acc = np.zeros(t)
        for i in range(2):
            gl = 1 - pan_wet[i] if pan_wet[i] >= 0 else 1.0
            gr = 1 + pan_wet[i] if pan_wet[i] <= 0 else 1.0
            conv = fftconvolve(x[i].astype(np.float64),
                               ir[i][o].astype(np.float64))[:t]
            delayed = np.zeros(t)
            delayed[predelay:] = conv[: t - predelay]
            acc += delayed * wet[i] * (gl if o == 0 else gr) * level[i]
        out[o] = np.clip(acc, -1, 1)
        for i in range(2):
            gl = 1 - pan_dry[i] if pan_dry[i] >= 0 else 1.0
            gr = 1 + pan_dry[i] if pan_dry[i] <= 0 else 1.0
            out[o] += x[i] * dry[i] * (gl if o == 0 else gr) * level[i]
    return out


def test_port_matches_fftconvolve_golden():
    # 500 samples: a ragged last partition
    pair = Pair(ir_len=500, seed=6, max_predelay=128)
    pair.set(wet=0.7, dry=0.25, level=0.8, predelay=[[100, 100], [37, 0]],
             pan_wet=[[-0.5, 0.25], [0.0, 0.0]], pan_dry=[[0.1, -0.1],
                                                          [0.0, 0.0]],
             select=[[1, 1], [0, 2]])
    _, tst = pair.init()
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 2, 32 * 24)) * 0.05).astype(np.float32)
    outs = []
    for t in range(24):
        tst, out = pair.port.step_coef_steady(
            tst, pair.tbank, pair.tcp.snapshot_device(),
            torch.tensor(x[..., 32 * t: 32 * (t + 1)]))
        outs.append(out.numpy())
    got = np.concatenate(outs, axis=-1)
    cp = pair.tcp
    for v in range(2):
        ir = [pair.irs[cp.select[v, i]] for i in range(2)]
        want = _golden(x[v], ir, cp.wet[v], cp.pan_wet[v], cp.level[v],
                       int(cp.predelay[v, 0]), cp.dry[v], cp.pan_dry[v])
        np.testing.assert_allclose(got[v], want, atol=2e-4)


def test_paths_outside_the_slice_raise():
    """bf16 MAC tensors (engine and carried bank) and the 'merged'
    per-voice MAC, refused before they were ported, now build as the JAX
    engine does and carry a JAX bf16 bank bit for bit (their steps are
    held to the JAX engine in tests/test_torch_bf16.py); working-set slot
    updates from a spectra payload still raise (the port's faults carry
    the time-domain IR only)."""
    pair = Pair()
    p = pair.port.partitions
    for kwargs in ({"mac_dtype": "bf16", "num_irs": 3},
                   {"mac_dtype": "bf16", "mac_strategy": "selected"},
                   {"pv_mac": "merged", "num_irs": 3}):
        built = fmajor.FMajorPartitionedConvolution(2, 32, p, device="cpu",
                                                    **kwargs)
        want = jax_fmajor.FMajorPartitionedConvolution(2, 32, p, **kwargs)
        assert built.mac_strategy == want.mac_strategy
        assert built.pv_mac == want.pv_mac
        assert str(built.mac_dtype).split(".")[-1] == \
            jnp.dtype(want.mac_dtype).name
        clone = built.with_voices(4)
        assert (clone.mac_dtype, clone.pv_mac) == (built.mac_dtype,
                                                   built.pv_mac)
    with pytest.raises(ValueError, match="time-domain"):
        pair.port.update_bank_slot(pair.tbank, 1, pair.spectra[:1])
    jbf16 = jax_fmajor.FMajorPartitionedConvolution(
        2, 32, pair.port.partitions, max_predelay=64, num_irs=3,
        mac_dtype="bf16").prepare_bank(pair.spectra)
    carried = fmajor.bank_from_numpy(
        device="cpu", **{f_.name: np.asarray(getattr(jbf16, f_.name))
                         for f_ in fields(jbf16)})
    for f_ in fields(jbf16):
        want = np.asarray(getattr(jbf16, f_.name))
        got = getattr(carried, f_.name)
        assert str(got.dtype).split(".")[-1] == want.dtype.name, f_.name
        if want.dtype.name == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f_.name)
    # what the JAX engine rejects, the port rejects the same way
    for kwargs in ({"mac_strategy": "nope"}, {"pv_mac": "nope"},
                   {"mac_strategy": "selected", "swap_snapshot": False},
                   {"mac_strategy": "auto"}):
        with pytest.raises(ValueError):
            fmajor.FMajorPartitionedConvolution(2, 32, 10, device="cpu",
                                                **kwargs)


# -- roll mode, the materialized snapshot, 'selected' --------------------------------


def _x(rng, v=2, b=32):
    return (rng.standard_normal((v, 2, b)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_banks_and_states_carry_every_leaf(ring, strategy):
    """prepare_bank packs the leaves this mode and strategy read, with the
    JAX engine's placeholders elsewhere; bank_from_numpy takes every JAX
    bank leaf; init_state matches leaf for leaf (shape, dtype, values)."""
    pair = Pair(ring=ring, mac_strategy=strategy)
    assert pair.port.t_modulus == pair.jax.t_modulus
    assert pair.port.mac_strategy == pair.jax.mac_strategy == strategy
    carried = fmajor.bank_from_numpy(
        device="cpu", **{f_.name: np.asarray(getattr(pair.jbank, f_.name))
                         for f_ in fields(pair.jbank)})
    for f_ in fields(pair.jbank):
        want = np.asarray(getattr(pair.jbank, f_.name))
        for bank in (pair.tbank, carried):
            np.testing.assert_array_equal(getattr(bank, f_.name).numpy(),
                                          want, err_msg=f_.name)
    assert pair.tbank.num_irs == carried.num_irs == pair.jbank.num_irs == 3
    jst, tst = pair.jax.init_state(), pair.port.init_state()
    for f_ in fields(jst):
        j, t = np.asarray(getattr(jst, f_.name)), getattr(tst, f_.name)
        assert tuple(t.shape) == j.shape, f_.name
        assert str(t.dtype).split(".")[-1] == str(j.dtype), f_.name
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32), err_msg=f_.name)


@pytest.mark.parametrize("ring", [False, True])
def test_steady_matches_jax_in_both_modes_past_the_line_and_a_wrap(ring):
    """Nonzero predelays, pans and per-channel selections, driven past two
    trips through the delay line (2 Pp blocks) and so past several wraps
    of the block counter (roll mode: t_modulus = ring slots = 4)."""
    pair = Pair(ring=ring)
    pair.set(wet=0.8, dry=0.2, level=0.9, predelay=[[17, 3], [40, 0]],
             pan_wet=[[0.3, -0.4], [-1.0, 0.5]], select=[[0, 1], [2, 0]])
    jst, tst = pair.init()
    rng = np.random.default_rng(2)
    n = 2 * pair.port.pp + 5
    assert n > 2 * pair.port.t_modulus
    for t in range(n):
        jst, tst, jo, to = pair.step(jst, tst, _x(rng))
        np.testing.assert_allclose(to, jo, atol=ATOL, err_msg=f"block {t}")
    assert int(tst.wptr) == n % pair.port.t_modulus
    _assert_states_close(jst, tst)


def test_roll_equals_ring_through_an_indexed_fade():
    """The port's roll mode (mac_shift) and ring mode (ring_mac) are the
    same engine: steady blocks past two trips through the line, then a
    span re-select and its indexed fade."""
    roll, ring = Pair(ring=False, seed=9), Pair(ring=True, seed=9)
    states = []
    for pair in (roll, ring):
        pair.set(wet=0.6, speed=6, predelay=[[9, 9], [0, 50]])
        states.append(pair.port.init_converged(
            pair.tbank, pair.tcp.snapshot_device()))
    rng = np.random.default_rng(10)
    for t in range(2 * roll.port.pp + 20):
        x = torch.tensor(_x(rng))
        outs = []
        for i, pair in enumerate((roll, ring)):
            if t == 2 * roll.port.pp:
                old = pair.tcp.select.copy()
                pair.tcp.select[:] = [[2, 1], [1, 0]]
                pair.tcp.vsteps[:] = 6
                states[i] = pair.port.collapse_pure(
                    states[i], torch.tensor(old),
                    torch.ones((2, 2), dtype=torch.bool))
            step = (pair.port.step_coef_indexed if t >= 2 * roll.port.pp
                    else pair.port.step_coef_steady)
            states[i], out = step(states[i], pair.tbank,
                                  pair.tcp.snapshot_device(), x)
            pair.tcp.end_block()
            outs.append(out.numpy())
        np.testing.assert_allclose(outs[0], outs[1], atol=3e-5,
                                   err_msg=f"block {t}")


@pytest.mark.parametrize("ring", [False, True])
def test_general_fade_and_materializing_collapse_match_jax(ring):
    """A span re-select and its indexed fade, an interrupting re-select
    through the materializing collapse (which turns the virtual snapshot
    into `base`), general fade steps, a second materializing interrupt of
    one channel and a wet change mid-fade, then the decay back to steady."""
    pair = Pair(ring=ring)
    atol = BF16_ATOL if ring else ATOL
    pair.set(wet=0.7, dry=0.1, speed=6, predelay=[[5, 5], [33, 33]],
             pan_wet=[[0.2, -0.2], [0.0, 0.4]])
    jst, tst = pair.init()
    rng = np.random.default_rng(3)
    for t in range(80):
        if t == 3:
            jst, tst = pair.reselect(jst, tst, [[1, 1], [2, 2]])
        if t in (6, 9):
            new = [[2, 0], [0, 1]] if t == 6 else [[2, 0], [0, 2]]
            jst, tst = pair.reselect(jst, tst, new, materialize=True)
            _assert_states_close(jst, tst)
        if t == 12:
            pair.set(wet=0.95)
        kind = ("steady" if t < 3 or t >= 75 else
                "indexed" if t < 6 else "general")
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind=kind)
        np.testing.assert_allclose(to, jo, atol=ATOL if t < 6 else atol,
                                   err_msg=f"block {t}")
    assert float(tst.coef_a.max()) < 1e-6
    _assert_states_close(jst, tst)


@pytest.mark.parametrize("ring", [False, True])
def test_materialized_fade_equals_the_span_fade(ring):
    """The two representations of one fade: collapse_pure + the indexed
    step, against the materializing collapse + the general step (the
    port's own test of test_fmajor.py's virtual-snapshot case). Roll mode
    is f32 throughout; ring mode's materialized snapshot is bf16."""
    span, mat = Pair(ring=ring, seed=11), Pair(ring=ring, seed=11)
    states = []
    for pair in (span, mat):
        pair.set(wet=0.8, speed=20)
        states.append(pair.init()[1])
    rng = np.random.default_rng(12)
    for t in range(14):
        x = torch.tensor(_x(rng))
        outs = []
        for i, pair in enumerate((span, mat)):
            if t in (0, 5):
                old = pair.tcp.select.copy()
                pair.tcp.select[:] = 1 if t == 0 else 2
                pair.tcp.vsteps[:] = 20
                args = (torch.tensor(old), torch.ones((2, 2), dtype=torch.bool))
                states[i] = (pair.port.collapse_pure(states[i], *args)
                             if pair is span else
                             pair.port.collapse(states[i], pair.tbank, *args))
            step = (pair.port.step_coef_indexed if pair is span
                    else pair.port.step_coef)
            states[i], out = step(states[i], pair.tbank,
                                  pair.tcp.snapshot_device(), x)
            pair.tcp.end_block()
            outs.append(out.numpy())
        np.testing.assert_allclose(outs[0], outs[1],
                                   atol=4e-3 if ring else 3e-6,
                                   err_msg=f"block {t}")


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_materialize_base_equals_a_no_change_collapse(ring, strategy):
    """materialize_base is collapse(changed=all-False) leaf for leaf, bit
    for bit, and matches the JAX materialize_base (mirrors
    tests/test_fmajor.py's test of the same name)."""
    pair = Pair(num_voices=3, ring=ring, mac_strategy=strategy)
    pair.set(wet=0.7, select=[[0, 1], [1, 2], [2, 0]])
    jst, tst = pair.init()
    rng = np.random.default_rng(13)
    for _ in range(3):
        jst, tst, _, _ = pair.step(jst, tst, _x(rng, v=3))
    if strategy == "allk":  # a genuinely virtual mid-fade snapshot
        jst, tst = pair.reselect(jst, tst, [[1, 1], [0, 2], [2, 2]])
    else:
        jst, tst = pair.reselect(jst, tst, [[1, 1], [0, 2], [2, 2]],
                                 materialize=True)
    jst, tst, _, _ = pair.step(jst, tst, _x(rng, v=3), kind="general")
    sel = torch.tensor(pair.tcp.select)
    ref = pair.port.collapse(tst, pair.tbank, sel,
                             torch.zeros((3, 2), dtype=torch.bool), sel)
    jgot, got = pair.materialize(jst, tst)
    for f_ in fields(got):
        a, b = getattr(got, f_.name), getattr(ref, f_.name)
        assert a.dtype == b.dtype and torch.equal(a, b), f_.name
    assert not bool(got.base_pure.any())
    _assert_states_close(jgot, got)


@pytest.mark.parametrize("ring", [False, True])
def test_selected_matches_jax_selected(ring):
    """'selected' through steady blocks, materializing re-selects (the
    per-voice spectra re-gathered), an interrupt, a wet change and the
    decay; then a regather against a second bank."""
    pair = Pair(ring=ring, mac_strategy="selected")
    atol = BF16_ATOL if ring else ATOL
    pair.set(wet=0.7, dry=0.1, speed=6, select=[[0, 1], [2, 0]],
             predelay=[[20, 0], [3, 3]])
    jst, tst = pair.init()
    _assert_states_close(jst, tst)
    rng = np.random.default_rng(21)
    for t in range(60):
        if t in (8, 11):
            new = [[2, 1], [2, 1]] if t == 8 else [[0, 0], [2, 2]]
            jst, tst = pair.reselect(jst, tst, new, materialize=True)
        if t == 20:
            pair.set(wet=0.9)
        kind = "general" if 8 <= t < 55 else "steady"
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind=kind)
        np.testing.assert_allclose(to, jo, atol=ATOL if t < 8 else atol,
                                   err_msg=f"block {t}")
    _assert_states_close(jst, tst)
    other = pair.spectra[::-1] * 0.5
    jnew = pair.jax.prepare_bank(other)
    tnew = pair.port.prepare_bank(other)
    sel = pair.tcp.select
    jst = pair.jax.regather_selection(jst, jnew, jnp.asarray(sel))
    tst = pair.port.regather_selection(tst, tnew, torch.tensor(sel))
    _assert_states_close(jst, tst)


@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_resumes_from_a_jax_state_with_a_materialized_base(ring, strategy):
    """state_from_numpy carries a JAX state whose fade snapshot is
    MATERIALIZED (base_pure False, coef_a > 0; bf16 bits in ring mode) into
    the port, which then continues block for block with the JAX engine on
    the general step."""
    pair = Pair(seed=4, ring=ring, mac_strategy=strategy)
    pair.set(wet=0.9, speed=20, predelay=[[70, 0], [0, 9]])
    j_collapse = jax.jit(pair.jax.collapse)
    jst = pair.jax.init_converged(
        pair.jbank, jax.tree.map(jnp.asarray, pair.jcp.snapshot()))
    rng = np.random.default_rng(5)
    for t in range(10):
        if t in (2, 6):
            old = pair.jcp.select.copy()
            pair.set(select=(old + 1) % 3, vsteps=20)
            jst = j_collapse(jst, pair.jbank, jnp.asarray(old),
                             jnp.asarray(np.ones((2, 2), bool)),
                             jnp.asarray(pair.jcp.select))
        jst, _ = pair.j_steps["general" if t >= 2 else "steady"](
            jst, pair.jbank, jax.tree.map(jnp.asarray, pair.jcp.snapshot()),
            jnp.asarray(_x(rng)))
        pair.jcp.end_block()
        pair.tcp.end_block()  # keep the port's countdown in step
    assert float(np.asarray(jst.coef_a).max()) > 0.1  # a fade is in flight
    assert not np.asarray(jst.base_pure).any()        # ... materialized
    tst = fmajor.state_from_numpy(
        device="cpu", **{f.name: np.asarray(getattr(jst, f.name))
                         for f in fields(jst)})
    np.testing.assert_array_equal(
        tst.base.float().numpy(), np.asarray(jst.base).astype(np.float32))
    _assert_states_close(jst, tst)
    for t in range(16):
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind="general")
        np.testing.assert_allclose(to, jo, atol=ATOL, err_msg=f"block {t}")
