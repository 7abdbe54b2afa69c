"""The port's fmajor engine (tpu_audio_torch/engine/fmajor.py) against the
JAX engine, block for block, on identical banks, inputs and parameters.

The JAX engine is built with backend="fft" (its default "auto" picks a
matmul DFT at these sizes) so both sides run an FFT. Tolerances: packs are
bit-equal (same numpy code); engine outputs agree to 2e-5 absolute (both
f32, different summation orders in the MAC and the transforms); the golden
against float64 fftconvolve holds to 2e-4 as in tests/test_engine.py.
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
                 seed=0, max_predelay=64):
        irs = _irs(num_irs, ir_len, seed)
        jbank, tbank = JaxIRBank(), IRBank()
        for ir in irs:
            jbank.append(ir)
            tbank.append(ir)
        self.irs = irs
        p = tbank.max_partitions(block)
        self.jax = jax_fmajor.FMajorPartitionedConvolution(
            num_voices, block, p, max_predelay=max_predelay, backend="fft",
            num_irs=num_irs)
        self.port = fmajor.FMajorPartitionedConvolution(
            num_voices, block, p, max_predelay=max_predelay,
            num_irs=num_irs, device="cpu")
        spectra = tbank.partitioned_spectra(block)
        np.testing.assert_array_equal(spectra, jbank.partitioned_spectra(block))
        self.jbank = self.jax.prepare_bank(spectra)
        self.tbank = self.port.prepare_bank(spectra)
        self.jcp = JaxControlPlane(num_voices, num_irs, max_predelay)
        self.tcp = ControlPlane(num_voices, num_irs, max_predelay)
        self.v, self.b = num_voices, block
        self.j_steady = jax.jit(self.jax.step_coef_steady)
        self.j_indexed = jax.jit(self.jax.step_coef_indexed)
        self.j_collapse = jax.jit(self.jax.collapse_pure)

    def set(self, **values):
        for cp in (self.jcp, self.tcp):
            for name, value in values.items():
                getattr(cp, name)[:] = value

    def init(self):
        jp = jax.tree.map(jnp.asarray, self.jcp.snapshot())
        return (self.jax.init_converged(self.jbank, jp),
                self.port.init_converged(self.tbank,
                                         self.tcp.snapshot_device()))

    def step(self, jst, tst, x, indexed=False):
        jp = jax.tree.map(jnp.asarray, self.jcp.snapshot())
        tp = self.tcp.snapshot_device()
        jstep = self.j_indexed if indexed else self.j_steady
        tstep = (self.port.step_coef_indexed if indexed
                 else self.port.step_coef_steady)
        jst, jo = jstep(jst, self.jbank, jp, jnp.asarray(x))
        tst, to = tstep(tst, self.tbank, tp, torch.tensor(x))
        self.jcp.end_block()
        self.tcp.end_block()
        return jst, tst, np.asarray(jo), to.numpy()

    def reselect(self, jst, tst, new):
        old = self.tcp.select.copy()
        self.set(select=new, vsteps=self.tcp.speed)
        changed = old != self.tcp.select
        jst = self.j_collapse(jst, jnp.asarray(old), jnp.asarray(changed))
        tst = self.port.collapse_pure(tst, torch.tensor(old),
                                      torch.tensor(changed))
        return jst, tst


def _assert_states_close(jst, tst):
    for name in ("fdl", "prev_in", "wet_ring", "coef_a", "coef_c", "base_g"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   atol=ATOL, err_msg=name)
    assert int(tst.wptr) == int(jst.wptr)
    np.testing.assert_array_equal(tst.base_pure.numpy(),
                                  np.asarray(jst.base_pure))


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
    pair = Pair()
    _, tst = pair.init()
    params = pair.tcp.snapshot_device()
    x = torch.zeros((2, 2, 32))
    with pytest.raises(NotImplementedError):
        pair.port.step_coef(tst, pair.tbank, params, x)  # general fade
    with pytest.raises(NotImplementedError):
        pair.port.collapse(tst, pair.tbank, None, None)
    with pytest.raises(NotImplementedError):
        pair.port.materialize_base(tst, pair.tbank)
    for kwargs in ({"mac_strategy": "selected", "num_irs": 3},
                   {"mac_strategy": "auto", "num_irs": 17},
                   {"mac_dtype": "bf16", "num_irs": 3}):
        with pytest.raises(NotImplementedError):
            fmajor.FMajorPartitionedConvolution(2, 32, 10, device="cpu",
                                                **kwargs)
    jst = pair.jax.init_state()
    leaves = {f.name: np.asarray(getattr(jst, f.name)) for f in fields(jst)}
    leaves["coef_a"] = np.full((2, 2), 0.5, np.float32)
    leaves["base_pure"] = np.zeros((2, 2), bool)
    with pytest.raises(NotImplementedError):
        fmajor.state_from_numpy(device="cpu", **leaves)
