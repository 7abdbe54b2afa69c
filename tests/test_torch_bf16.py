"""bf16 MAC tensors in the port (mac_dtype='bf16': the delay lines and the
MAC tensors stored in bfloat16) against the JAX package, on the CPU.

The kernel functions (ring_mac, mac_shift on bf16 operands; on the CPU
their plain versions, which upcast to f32) are held against the function
the JAX engine computes: the Pallas ring_mac in interpret mode, and the
einsum with preferred_element_type=float32 on the same bf16 operands
(tpu_audio/engine/fmajor.py:908-923), within 1e-5 of the output's scale.
Not against the JAX package's ring_mac_reference / mac_shift_reference,
whose einsum on bf16 operands returns bf16.

Engines and sessions: the JAX bank and state carry over bit for bit; steps
(fmajor ring and roll, 'allk' and 'selected', steady, indexed and general),
the cascade against JAX tail_mac='mxu', 'merged' against 'dot', sessions,
the bounce and the CLI, within 2e-3 of the output's scale (the ring
bf16-snapshot precedent, tests/test_fmajor.py:319): both packages round
f32 values that differ in their last bits (FFTs of two libraries) to bf16,
and now and then one rounds to the neighbouring bf16 value, 2^-8 relative.
The worst case measured here is 1.2e-3 of scale (the cascade, whose JAX
tail MAC also rounds its fresh-column correction to bf16); the fmajor
steps stay under 2e-4. bf16 against the f32 engine: above 40 dB SNR
(tests/test_fmajor.py:226-259). Device prep: within one bf16 step of the
host prep (tests/test_device_prep.py:67-69).
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import fmajor as jax_fmajor
from tpu_audio.engine.cascade import CascadeConvolution as JaxCascade
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.ops.pallas_mac import ring_mac as pallas_ring_mac
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.offline import render_offline as jax_render_offline
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine import fmajor
from tpu_audio_torch.engine.cascade import (
    CascadeConvolution, cascade_bank_from_numpy,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.ops.mac_shift import mac_shift
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.runtime.backends import WavSource
from tpu_audio_torch.runtime.offline import render_offline
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

KERNEL_REL = 1e-5
ENGINE_REL = 2e-3
BF16_STEP = 2.0 ** -8


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"
    return err / scale


def _bits(t):
    """A bf16 tensor or JAX array as its int16 bits."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


def _bf16(rng, shape):
    """The same bf16 values on both sides (both round to nearest even)."""
    x = rng.standard_normal(shape).astype(np.float32)
    j, t = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).to(torch.bfloat16)
    np.testing.assert_array_equal(_bits(t), _bits(j))
    return j, t


def _f32_einsum(spec, *ops):
    """The JAX engine's bf16 MAC: bf16 operands, f32 products and sums."""
    return np.asarray(jnp.einsum(spec, *ops,
                                 preferred_element_type=jnp.float32))


# -- the kernel functions --------------------------------------------------------


F, VI, P = 8, 6, 20
# the card kernels' tensor-core tile edges, (VI, Pp, KOD): Pp 4 (Q = 8, less
# than one k16 step), KOD 12 and 20 (half an n8 tile), 68 (two column
# groups), VI 1 and 17 (below and across one m16 tile)
MMA_EDGES = [(VI, 4, 16), (VI, P, 12), (VI, P, 20), (VI, P, 68), (1, P, 16),
             (17, P, 36), (17, 4, 12)]


@pytest.mark.parametrize("w,kod,vi,p", [
    *(pytest.param(w, kod, VI, P, id=f"{w}-{kod}")
      for w in (0, 1, P - 1) for kod in (4, 16, 36)),
    *(pytest.param(w, kod, vi, p, id=f"vi{vi}-p{p}-{w}-{kod}")
      for vi, p, kod in MMA_EDGES for w in (0, 1, p - 1))])
def test_bf16_ring_mac_matches_the_jax_bf16_mac(w, kod, vi, p):
    rng = np.random.default_rng(w * 100 + kod if (vi, p) == (VI, P)
                                else [vi, p, w, kod])
    fdl_j, _ = _bf16(rng, (F, 2, vi, p))                   # Pallas layout
    rhs2_j, rhs2_t = _bf16(rng, (F, 2, 2 * p, kod))
    fdl_t = torch.tensor(np.asarray(fdl_j).astype(np.float32)).to(
        torch.bfloat16).transpose(1, 2).contiguous()       # [F, VI, 2, P]
    want_kernel = np.asarray(pallas_ring_mac(w, fdl_j, rhs2_j, f_tile=2,
                                             interpret=True))
    window = jax.lax.dynamic_slice_in_dim(rhs2_j, p - w, p, axis=2)
    want = _f32_einsum("fcvp,fcpk->fvk", fdl_j, window)
    got = ring_mac(torch.tensor(w, dtype=torch.int32), fdl_t, rhs2_t)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "einsum", KERNEL_REL)
    _close(got.numpy(), want_kernel, "pallas", KERNEL_REL)


@pytest.mark.parametrize("kod,vi,p", [
    *(pytest.param(kod, VI, P, id=str(kod)) for kod in (4, 16, 36)),
    *(pytest.param(kod, vi, p, id=f"vi{vi}-p{p}-{kod}")
      for vi, p, kod in MMA_EDGES)])
def test_bf16_mac_shift_matches_the_jax_roll_and_einsum(kod, vi, p):
    """JAX runs bf16 roll mode as the roll plus the einsum
    (fmajor.py:817, 920-923): the shifted line bit for bit, m within 1e-5
    of scale."""
    rng = np.random.default_rng(kod if (vi, p) == (VI, P) else [vi, p, kod])
    fdl_j, fdl_t = _bf16(rng, (F, vi, 2, p))
    xn_j, xn_t = _bf16(rng, (F, vi, 2, 1))
    rhs_j, rhs_t = _bf16(rng, (F, 2, p, kod))
    shifted = jnp.concatenate([xn_j, fdl_j[..., :-1]], axis=-1)
    want = _f32_einsum("fvcp,fcpk->fvk", shifted, rhs_j)
    out, m = mac_shift(fdl_t, xn_t, rhs_t)
    assert out is fdl_t and out.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(shifted))
    _close(m.numpy(), want, "m", KERNEL_REL)


@pytest.mark.parametrize("case", ["ring_mixed", "ring_f16", "shift_mixed_rhs",
                                  "shift_mixed_x_new"])
def test_kernels_refuse_a_mixed_pair(case):
    fdl = torch.zeros((2, 4, 2, 8), dtype=torch.bfloat16)
    w = torch.zeros((), dtype=torch.int32)
    with pytest.raises(TypeError):
        if case == "ring_mixed":
            ring_mac(w, fdl, torch.zeros((2, 2, 16, 4)))
        elif case == "ring_f16":
            ring_mac(w, fdl.half(), torch.zeros((2, 2, 16, 4)).half())
        elif case == "shift_mixed_rhs":
            mac_shift(fdl, torch.zeros((2, 4, 2, 1), dtype=torch.bfloat16),
                      torch.zeros((2, 2, 8, 4)))
        else:
            mac_shift(fdl, torch.zeros((2, 4, 2, 1)),
                      torch.zeros((2, 2, 8, 4), dtype=torch.bfloat16))


# -- the fmajor engine -------------------------------------------------------------


def _irs(num_irs=3, ir_len=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _banks(irs):
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    return jbank, tbank


class _Pair:
    """One bf16 fmajor geometry in both packages, the same bank, two
    control planes driven identically."""

    def __init__(self, ring=True, mac_strategy="allk", pv_mac="dot",
                 mac_dtype="bf16"):
        _, tb = _banks(_irs())
        self.spectra = tb.partitioned_spectra(32)
        kwargs = dict(max_predelay=64, ring=ring, mac_strategy=mac_strategy,
                      num_irs=3, mac_dtype=mac_dtype, pv_mac=pv_mac)
        p = tb.max_partitions(32)
        self.jax = jax_fmajor.FMajorPartitionedConvolution(
            2, 32, p, backend="fft", **kwargs)
        self.port = fmajor.FMajorPartitionedConvolution(2, 32, p,
                                                        device="cpu", **kwargs)
        self.jbank = self.jax.prepare_bank(self.spectra)
        self.tbank = self.port.prepare_bank(self.spectra)
        self.jcp = JaxControlPlane(2, 3, 64)
        self.tcp = ControlPlane(2, 3, 64, device="cpu")
        for cp in (self.jcp, self.tcp):
            cp.wet[:] = 0.8
            cp.dry[:] = 0.1
            cp.speed[:] = 6
            cp.predelay[:] = [[5, 5], [33, 33]]
            cp.pan_wet[:] = [[0.2, -0.2], [0.0, 0.4]]

    def jparams(self):
        return jax.tree.map(jnp.asarray, self.jcp.snapshot())

    def init(self):
        return (self.jax.init_converged(self.jbank, self.jparams()),
                self.port.init_converged(self.tbank,
                                         self.tcp.snapshot_device()))

    def step(self, jst, tst, x, kind):
        name = {"steady": "step_coef_steady", "indexed": "step_coef_indexed",
                "general": "step_coef"}[kind]
        jst, jo = getattr(self.jax, name)(jst, self.jbank, self.jparams(),
                                          jnp.asarray(x))
        tst, to = getattr(self.port, name)(tst, self.tbank,
                                           self.tcp.snapshot_device(),
                                           torch.tensor(x))
        self.jcp.end_block()
        self.tcp.end_block()
        return jst, tst, np.asarray(jo), to.numpy()

    def reselect(self, jst, tst, new, pure):
        old = self.tcp.select.copy()
        for cp in (self.jcp, self.tcp):
            cp.select[:] = new
            cp.vsteps[:] = cp.speed
        changed = old != self.tcp.select
        if pure:
            return (self.jax.collapse_pure(jst, jnp.asarray(old),
                                           jnp.asarray(changed)),
                    self.port.collapse_pure(tst, torch.tensor(old),
                                            torch.tensor(changed)))
        new_sel = self.tcp.select.copy()
        return (self.jax.collapse(jst, self.jbank, jnp.asarray(old),
                                  jnp.asarray(changed), jnp.asarray(new_sel)),
                self.port.collapse(tst, self.tbank, torch.tensor(old),
                                   torch.tensor(changed),
                                   torch.tensor(new_sel)))


def _x(rng, v=2, b=32):
    return (rng.standard_normal((v, 2, b)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_bf16_bank_and_state_carry_bit_for_bit(ring, strategy):
    """prepare_bank packs the same bf16 bits as the JAX engine; the JAX
    state after a re-select carries over bit for bit, every leaf in the
    JAX dtype."""
    pair = _Pair(ring, strategy)
    for f in fields(pair.jbank):
        want, got = np.asarray(getattr(pair.jbank, f.name)), \
            getattr(pair.tbank, f.name)
        assert str(got.dtype).split(".")[-1] == want.dtype.name, f.name
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(_bits(got), _bits(want), f.name)
        else:
            np.testing.assert_array_equal(got.numpy(), want, f.name)
    jst, tst = pair.init()
    rng = np.random.default_rng(1)
    for t in range(4):
        if t == 2:
            jst, tst = pair.reselect(jst, tst, [[1, 2], [2, 0]],
                                     pure=strategy == "allk")
        jst, tst, _, _ = pair.step(jst, tst, _x(rng), "steady")
    leaves = {f.name: np.asarray(getattr(jst, f.name)) for f in fields(jst)}
    carried = fmajor.state_from_numpy(device="cpu", **leaves)
    for name, want in leaves.items():
        got = getattr(carried, name)
        assert str(got.dtype).split(".")[-1] == want.dtype.name, name
        if want.dtype.name == "bfloat16":
            np.testing.assert_array_equal(_bits(got), _bits(want), name)
        else:
            np.testing.assert_array_equal(got.numpy().reshape(want.shape),
                                          want, name)
    assert tst.fdl.dtype == torch.bfloat16
    assert tst.sel_spectra.dtype == torch.bfloat16


@pytest.mark.parametrize("ring", [True, False])
@pytest.mark.parametrize("strategy", ["allk", "selected"])
def test_bf16_steps_match_jax(ring, strategy):
    """Steady blocks; a re-select and an interrupt (collapse_pure and the
    indexed step for 'allk', the materializing collapse and the general
    step for 'selected'); for 'allk' then a materialized snapshot and the
    general step through another re-select: block for block within 2e-3
    of scale."""
    pair = _Pair(ring, strategy)
    jst, tst = pair.init()
    rng = np.random.default_rng(2)
    allk = strategy == "allk"
    events = {4: [[1, 1], [2, 2]], 7: [[2, 0], [0, 1]]}
    worst = 0.0
    for t in range(70):
        kind = "steady"
        if t in events:
            jst, tst = pair.reselect(jst, tst, events[t], pure=allk)
        if 4 <= t < 40:
            kind = "indexed" if allk else "general"
        if allk and t == 40:
            jst = pair.jax.materialize_base(jst, pair.jbank)
            tst = pair.port.materialize_base(tst, pair.tbank)
            jst, tst = pair.reselect(jst, tst, [[0, 0], [1, 1]], pure=False)
        if allk and t >= 40:
            kind = "general"
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind)
        worst = max(worst, _close(to, jo, f"{kind} block {t}", ENGINE_REL))
    assert worst < 2e-4, worst


@pytest.mark.parametrize("ring", [True, False])
def test_bf16_merged_per_voice_mac_matches_dot_and_jax(ring):
    """pv_mac='merged' (a [4, Pp] x [Pp, 8] product per (f, v), the i == i'
    diagonal kept) against the port's 'dot' form on the same exact
    products (1e-5 of scale) and against the JAX 'merged' engine (2e-3),
    through the 'selected' strategy's materializing collapse and general
    step."""
    pairs = {pv: _Pair(ring, "selected", pv) for pv in ("dot", "merged")}
    states = {pv: p.init() for pv, p in pairs.items()}
    rng = np.random.default_rng(3)
    for t in range(30):
        x = _x(rng)
        outs = {}
        for pv, pair in pairs.items():
            jst, tst = states[pv]
            if t == 3:
                jst, tst = pair.reselect(jst, tst, [[2, 1], [0, 0]],
                                         pure=False)
            kind = "general" if t >= 3 else "steady"
            jst, tst, jo, to = pair.step(jst, tst, x, kind)
            states[pv] = (jst, tst)
            outs[pv] = (jo, to)
        _close(outs["merged"][1], outs["dot"][1], f"merged vs dot {t}",
               KERNEL_REL)
        _close(outs["merged"][1], outs["merged"][0], f"vs jax {t}",
               ENGINE_REL)


@pytest.mark.parametrize("ring", [True, False])
def test_bf16_tracks_the_f32_engine(ring):
    """The bf16 wet path against the f32 engine at wet 1, dry 0: above
    40 dB SNR."""
    outs = {}
    for dtype in ("f32", "bf16"):
        pair = _Pair(ring, mac_dtype=dtype)
        pair.tcp.wet[:] = 1.0
        pair.tcp.dry[:] = 0.0
        _, tst = pair.init()
        rng = np.random.default_rng(4)
        out = []
        for _ in range(20):
            tst, o = pair.port.step_coef_steady(
                tst, pair.tbank, pair.tcp.snapshot_device(),
                torch.tensor(_x(rng)))
            out.append(o.numpy())
        outs[dtype] = np.concatenate(out, axis=-1)
    err = outs["bf16"] - outs["f32"]
    snr = 10 * np.log10((outs["f32"] ** 2).mean() / (err ** 2).mean())
    assert snr > 40.0, snr


@pytest.mark.parametrize("ring", [True, False])
def test_bf16_device_prep_within_one_bf16_step(ring):
    """The model's device prep (torch.fft, then the bf16 cast) against the
    host prep: every bf16 leaf within one bf16 step of its scale, f32
    leaves to the FFT's rounding; a working-set slot packed and written in
    place in bf16 equals the prepped bank's slot the same way."""
    _, tb = _banks(_irs())
    eng = fmajor.FMajorPartitionedConvolution(
        2, 32, tb.max_partitions(32), max_predelay=64, ring=ring,
        num_irs=3, mac_dtype="bf16", device="cpu")
    host = eng.prepare_bank(tb.partitioned_spectra(32))
    dev = dp.prepare_fmajor_bank_device(eng, tb)
    for f in fields(host):
        want, got = getattr(host, f.name), getattr(dev, f.name)
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        rel = BF16_STEP if want.dtype == torch.bfloat16 else 1e-6
        if want.numel() > 1:
            _close(got.float().numpy(), want.float().numpy(), f.name, rel)
    slot = eng.pack_bank_slot(_irs()[1])
    assert slot.columns.dtype == torch.bfloat16
    cols = host.rhs2 if ring else host.mac_rhs
    before = cols.clone()
    eng.write_bank_slot(host, 1, slot)
    assert cols.dtype == torch.bfloat16
    _close(cols[..., 4:8].float().numpy(), before[..., 4:8].float().numpy(),
           "slot", BF16_STEP)
    torch.testing.assert_close(cols[..., :4], before[..., :4], rtol=0, atol=0)


# -- the cascade ---------------------------------------------------------------------


def test_bf16_cascade_matches_jax_mxu():
    """The bf16 cascade, both stages on the bf16 ring_mac (exact products,
    f32 sums), against the JAX engine with tail_mac='mxu', block for block
    through a re-select and an interrupt (collapse_pure, the indexed
    step), on both predelay sides."""
    b, m, v, k = 32, 4, 4, 3
    irs = _irs(k, 1200)
    jb, tb = _banks(irs)
    parts = tb.max_partitions(b)
    worst = 0.0
    for side in ("write", "read"):
        kwargs = dict(max_predelay=64, num_irs=k, mac_dtype="bf16",
                      tail_mac="mxu", predelay_side=side)
        je = JaxCascade(v, b, parts, ratio=m, backend="fft", **kwargs)
        te = CascadeConvolution(v, b, parts, ratio=m, device="cpu", **kwargs)
        jbank = je.prepare_bank(jb)
        tbank = te.prepare_bank(tb)
        carried = cascade_bank_from_numpy(te, np.asarray(jbank.head_rhs2),
                                          np.asarray(jbank.tail_rhs2))
        for name in ("head_rhs2", "tail_rhs2"):
            assert getattr(tbank, name).dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(getattr(tbank, name)),
                                          _bits(getattr(carried, name)))
        jcp, tcp = JaxControlPlane(v, k, 64), ControlPlane(v, k, 64,
                                                           device="cpu")
        for cp in (jcp, tcp):
            cp.wet[:] = 0.8
            cp.dry[:] = 0.1
            cp.speed[:] = 6
            cp.predelay[:, 0] = [0, 9, 37, 63]
            cp.select[:, 0] = np.arange(v) % k
        js = je.init_converged(jbank, jax.tree.map(jnp.asarray,
                                                   jcp.snapshot()))
        ts = te.init_converged(tbank, tcp.snapshot_device())
        rng = np.random.default_rng(5)
        for t in range(60):
            if t in (8, 11):
                old = tcp.select.copy()
                for cp in (jcp, tcp):
                    cp.select[:] = (old + 1) % k
                    cp.vsteps[:] = cp.speed
                ch = old != tcp.select
                js = je.collapse_pure(js, jnp.asarray(old), jnp.asarray(ch),
                                      jax.tree.map(jnp.asarray,
                                                   jcp.snapshot()))
                ts = te.collapse_pure(ts, torch.tensor(old),
                                      torch.tensor(ch),
                                      tcp.snapshot_device())
            name = "step_coef_indexed" if t >= 8 else "step_coef_steady"
            x = _x(rng, v)
            js, jo = getattr(je, name)(js, jbank, jax.tree.map(
                jnp.asarray, jcp.snapshot()), jnp.asarray(x))
            ts, to = getattr(te, name)(ts, tbank, tcp.snapshot_device(),
                                       torch.tensor(x))
            jcp.end_block()
            tcp.end_block()
            worst = max(worst, _close(to.numpy(), np.asarray(jo),
                                      f"{side} block {t}", ENGINE_REL))
        assert ts.fdl1.dtype == ts.fdl2.dtype == torch.bfloat16
    assert worst > 0.0


def test_bf16_cascade_slot_write_in_place():
    """The bf16 'allk' cascade's working-set slot: packed in bf16 on the
    device and written in place into both stages' columns, equal to the
    device-prepped bank's slot within one bf16 step, the other slots
    untouched."""
    irs = _irs(3, 1200)
    _, tb = _banks(irs)
    eng = CascadeConvolution(4, 32, tb.max_partitions(32), ratio=4,
                             max_predelay=64, num_irs=3, mac_dtype="bf16",
                             device="cpu")
    bank = dp.prepare_cascade_bank_device(eng, tb)
    before = {n: getattr(bank, n).clone() for n in ("head_rhs2", "tail_rhs2")}
    slot = eng.pack_bank_slot(irs[1])
    assert slot.head.dtype == slot.tail.dtype == torch.bfloat16
    eng.write_bank_slot(bank, 1, slot)
    for name, old in before.items():
        new = getattr(bank, name)
        assert new.dtype == torch.bfloat16
        _close(new[..., 4:8].float().numpy(), old[..., 4:8].float().numpy(),
               name, BF16_STEP)
        torch.testing.assert_close(new[..., :4], old[..., :4], rtol=0, atol=0)
        torch.testing.assert_close(new[..., 8:], old[..., 8:], rtol=0, atol=0)


# -- sessions, the bounce, the CLI ------------------------------------------------------


def _models(engine, **kwargs):
    irs = _irs(3, 1200 if engine == "cascade" else 300, seed=9)
    jb, tb = _banks(irs)
    common = dict(num_voices=4, block=32, max_predelay=64, engine=engine,
                  mac_dtype="bf16", **kwargs)
    if engine == "cascade":
        common.update(cascade_ratio=4)
    jm = JaxReverb(jb, backend="fft", bank_prep="device", **common)
    tm = ConvolutionReverb(tb, device="cpu", **common)
    if engine == "cascade":
        # the JAX model's 'auto' picks the 'vpu' tail MAC at 4 voices,
        # which rounds each product to bf16; hold the port to 'mxu'
        jm.engine.tail_mac = "mxu"
    for cp, cls in ((jm.control, JaxCCMapping), (tm.control, CCMapping)):
        cp.wet[:] = 0.8
        cp.dry[:] = 0.2
        cp.speed[:] = 8
        cp.predelay[:] = 40
        for v in range(4):
            for ch in range(2):
                cp.set_mapping(v, ch, cls(message=0xB0, select=0x15))
    return jm, tm


@pytest.mark.parametrize("engine", ["fmajor", "cascade"])
def test_bf16_session_and_bounce_match_jax(engine):
    """ConvolutionReverb(mac_dtype='bf16') streams a re-select and an
    interrupt through its session, and bounces statically, as the JAX
    model does, within 2e-3 of scale."""
    jm, tm = _models(engine)
    x = (np.random.default_rng(6).standard_normal((4, 2, 32 * 60))
         * 0.05).astype(np.float32)
    events = [(5, "", bytes([0xB0, 0x15, 64])),
              (8, "", bytes([0xB0, 0x15, 127]))]
    outs = {}
    for name, model, src, sched in (
            ("jax", jm, JaxWavSource, JaxMidiSchedule),
            ("port", tm, WavSource, MidiSchedule)):
        blocks = []

        class Sink:
            def write(self, block):
                blocks.append(np.array(block))

            def close(self):
                pass

        model.process(src(x, 4, 32), Sink(), midi=sched(list(events)),
                      warmup=0)
        outs[name] = np.concatenate(blocks, axis=-1)
    assert np.abs(outs["jax"]).max() > 0.05
    _close(outs["port"], outs["jax"], "session", ENGINE_REL)
    jm2, tm2 = _models(engine)
    want = jax_render_offline(jm2, x, segments=2, wire="f32")
    got = render_offline(tm2, x, segments=2, wire="f32")
    _close(got, want, "bounce", ENGINE_REL)


@pytest.mark.parametrize("engine", ["fmajor", "cascade"])
def test_bf16_cli_matches_the_jax_cli(tmp_path, engine):
    """--mac-dtype bf16 through both CLIs: WAVs within 2e-3 of their scale
    (plus 1 LSB of 16-bit PCM)."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav
    from tpu_audio_torch.app.main import main as port_main

    rng = np.random.default_rng(4)
    paths = []
    for k in range(3):
        ir = rng.uniform(-0.3, 0.3, (1500 + 200 * k, 2)).astype(np.float32)
        paths.append(str(tmp_path / f"ir{k}.wav"))
        write_wav(paths[-1], ir, 44100)
    write_index(tmp_path / "bank.index", paths)
    (tmp_path / "settings.txt").write_text(
        SETTINGS.format(index=tmp_path / "bank.index"))
    (tmp_path / "events.txt").write_text("4 B0 15 40\n7 B0 15 7F\n")
    x = rng.uniform(-0.2, 0.2, (32 * 60, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    common = ["--settings", str(tmp_path / "settings.txt"),
              "--input", str(tmp_path / "in.wav"), "--midi",
              str(tmp_path / "events.txt"), "--block-size", "32", "--quiet",
              "--engine", engine, "--voices", "4", "--mac-dtype", "bf16"]
    if engine == "cascade":
        common += ["--cascade-ratio", "4"]
    assert jax_main(common + ["--output", str(tmp_path / "jax.wav")]) == 0
    assert port_main(common + ["--output", str(tmp_path / "port.wav"),
                               "--device", "cpu"]) == 0
    blob = {}
    for name in ("jax", "port"):
        raw = (tmp_path / f"{name}.wav").read_bytes()
        blob[name] = np.frombuffer(raw[raw.index(b"data") + 8:],
                                   "<i2").astype(np.int32)
    assert blob["port"].shape == blob["jax"].shape
    scale = np.abs(blob["jax"]).max()
    assert scale > 1000
    assert np.abs(blob["port"] - blob["jax"]).max() <= ENGINE_REL * scale + 1


SETTINGS = """
conv.count 2
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].value.select 1
conv[0].value.predelay 40
conv[0].value.dry 0.3
conv[0].value.wet 0.7
conv[0].value.speed 6
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.message 176
conv[1].cc.select 21
conv[1].value.select 0
conv[1].value.predelay 40
conv[1].value.dry 0.3
conv[1].value.wet 0.7
conv[1].value.speed 6
"""
