"""The cascade's 'selected' strategy in the port (tpu_audio_torch/engine/
cascade.py: per-voice materialized MAC columns of both stages and a
materialized fade snapshot) against the JAX engine, in f32: the gathers, the
steps (steady and the general fade step), the materializing collapse through
an interrupt, materialize_base, regather_selection, a session with a
re-select, an interrupted fade and a swap_bank, the static bounce, the CLI
on a 17-IR bank, and the automated bounce's refusal; then bf16 against the
JAX engine's bf16 and the port's own f32 engine.

Shapes are tests/test_cascade.py's (B=32, ratio 4, V=4, 1200-sample IRs).
The JAX engine is built with backend="fft", so both sides run an FFT.
Tolerances: gathers bit for bit (axis moves of the same bank); steps,
states, sessions and bounces within 2e-5 of the output's scale (f32 sums in
another order: the port writes the fresh column before the per-voice MAC,
JAX adds a correction for it); the CLI WAVs within 1 LSB of 16-bit PCM; the
bf16 engine within 2e-3 of scale of the JAX bf16 engine (the ring
bf16-snapshot precedent, tests/test_fmajor.py:319) and above 40 dB SNR
against f32 (tests/test_fmajor.py:226-259), its state dtypes unchanged by a
collapse.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.cascade import CascadeConvolution as JaxCascade
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.offline import render_offline as jax_render_offline
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.runtime.stream import StreamSession as JaxSession
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine.cascade import (
    CascadeConvolution, cascade_bank_from_numpy, cascade_state_from_numpy,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.ops.ring_mac import ring_mac
from tpu_audio_torch.runtime.backends import WavSource
from tpu_audio_torch.runtime.offline import render_offline
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

torch.set_num_threads(1)

B, M, V, K, IR_LEN, MAXPD = 32, 4, 4, 3, 1200, 64
REL = 2e-5
ENGINE_REL = 2e-3   # bf16 against the JAX bf16 engine


def _irs(num_irs=K, ir_len=IR_LEN, seed=0):
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


def _engines(parts, **kwargs):
    kwargs.setdefault("max_predelay", MAXPD)
    kwargs.setdefault("num_irs", K)
    kwargs.setdefault("mac_strategy", "selected")
    return (JaxCascade(V, B, parts, ratio=M, backend="fft", **kwargs),
            CascadeConvolution(V, B, parts, ratio=M, device="cpu", **kwargs))


def _close(got, want, what, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"
    return err / scale


def _to_jax(name, leaf):
    """A port state leaf in the JAX layout: fdl2 [M, F2, 2Vg, d, P2p] ->
    [M, Vg, I, d, P2p, F2]; sel_tail / base_tail [M, F2, 2Vg, d, 2P2p, OD]
    -> [M, Vg, I, d, 2P2p, OD, F2]."""
    if name == "fdl2":
        m, f2, rows, d, pp2 = leaf.shape
        return leaf.reshape(m, f2, rows // 2, 2, d, pp2).permute(
            0, 2, 3, 4, 5, 1)
    if name in ("sel_tail", "base_tail"):
        m, f2, rows, d, q, od = leaf.shape
        return leaf.reshape(m, f2, rows // 2, 2, d, q, od).permute(
            0, 2, 3, 4, 5, 6, 1)
    return leaf


def _assert_states_close(jst, tst, rel=REL):
    assert tst.step == int(jst.t) == int(tst.t)
    for f in fields(tst):
        if f.name in ("t", "step"):
            continue
        got = _to_jax(f.name, getattr(tst, f.name))
        want = np.asarray(getattr(jst, f.name))
        assert got.shape == want.shape, f.name
        if got.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f.name)
        elif np.abs(want).max() == 0:
            assert float(got.abs().max()) == 0.0, f.name
        else:
            _close(got.float().numpy(), want.astype(np.float32), f.name,
                   rel)


def _configure(cp):
    cp.wet[:] = 0.8
    cp.dry[:] = 0.15
    cp.level[:] = 0.9
    cp.speed[:] = 6
    cp.pan_wet[:] = [[-0.5, 0.25], [0.0, 0.75]] * (V // 2)
    cp.predelay[:, 0] = [0, 9, 37, 63]
    cp.select[:, 0] = np.arange(V) % K
    cp.select[:, 1] = (np.arange(V) + 1) % K


class _Pair:
    """One 'selected' cascade geometry in both packages, the port's bank
    carried from the JAX bank, two control planes driven identically."""

    def __init__(self, side="write", **kwargs):
        self.irs = _irs()
        jbank_ir, tbank_ir = _banks(self.irs)
        self.jeng, self.teng = _engines(tbank_ir.max_partitions(B),
                                        predelay_side=side, **kwargs)
        self.jbank = self.jeng.prepare_bank(jbank_ir)
        self.tbank = cascade_bank_from_numpy(
            self.teng, np.asarray(self.jbank.head_rhs2),
            np.asarray(self.jbank.tail_rhs2))
        self.jcp = JaxControlPlane(V, K, MAXPD)
        self.tcp = ControlPlane(V, K, MAXPD, device="cpu")
        for cp in (self.jcp, self.tcp):
            _configure(cp)
        self.j_steps = {"steady": jax.jit(self.jeng.step_coef_steady),
                        "general": jax.jit(self.jeng.step_coef)}
        self.t_steps = {"steady": self.teng.step_coef_steady,
                        "general": self.teng.step_coef}

    def jparams(self):
        return jax.tree.map(jnp.asarray, self.jcp.snapshot())

    def init(self):
        return (self.jeng.init_converged(self.jbank, self.jparams()),
                self.teng.init_converged(self.tbank,
                                         self.tcp.snapshot_device()))

    def step(self, jst, tst, x, kind):
        jst, jo = self.j_steps[kind](jst, self.jbank, self.jparams(),
                                     jnp.asarray(x))
        tst, to = self.t_steps[kind](tst, self.tbank,
                                     self.tcp.snapshot_device(),
                                     torch.tensor(x))
        self.jcp.end_block()
        self.tcp.end_block()
        return jst, tst, np.asarray(jo), to.numpy()

    def reselect(self, jst, tst, new):
        """The materializing collapse on both sides, with the post-change
        selection and parameters."""
        old = self.tcp.select.copy()
        for cp in (self.jcp, self.tcp):
            cp.select[:] = new
            cp.vsteps[:] = cp.speed
        changed = old != self.tcp.select
        new_sel = self.tcp.select.copy()
        jst = self.jeng.collapse(jst, self.jbank, jnp.asarray(old),
                                 jnp.asarray(changed), jnp.asarray(new_sel),
                                 self.jparams())
        tst = self.teng.collapse(tst, self.tbank, torch.tensor(old),
                                 torch.tensor(changed), torch.tensor(new_sel),
                                 self.tcp.snapshot_device())
        return jst, tst


def _x(rng, blocks=1):
    return (rng.standard_normal((V, 2, B * blocks)) * 0.05).astype(np.float32)


# -- gathers, state, guards -------------------------------------------------------


def test_gathers_and_init_state_match_jax():
    """init_converged gathers each voice's columns of both stages: the same
    values as the JAX gathers, bit for bit, in the port's tail layout; the
    'allk' placeholders and the strategy's attributes as JAX's."""
    pair = _Pair()
    assert pair.teng.mac_strategy == pair.jeng.mac_strategy == "selected"
    assert pair.teng.swap_snapshot == pair.jeng.swap_snapshot is True
    assert pair.teng.fade_protocol == "selected"
    jst, tst = pair.init()
    assert tst.sel_tail.shape == (M, pair.teng.f2, 2 * V // M, 2,
                                  2 * pair.teng.pp2, 4)
    for name in ("sel_head", "sel_tail"):
        np.testing.assert_array_equal(
            _to_jax(name, getattr(tst, name)).numpy(),
            np.asarray(getattr(jst, name)), err_msg=name)
    _assert_states_close(jst, tst, 0.0)
    # a gather of every IR, against the columns a ring_mac of the bank picks
    sel = torch.tensor([[0, 1], [2, 0], [1, 2], [0, 0]], dtype=torch.int32)
    head = pair.teng._gather_head(pair.tbank, sel)
    k = pair.tbank.num_irs
    r = pair.tbank.head_rhs2.reshape(pair.teng.f1, 2, -1, k, 4)
    for v in range(V):
        for i in range(2):
            np.testing.assert_array_equal(head[:, v, i].numpy(),
                                          r[:, :, :, sel[v, i]].numpy())


def test_guards():
    pair = _Pair()
    _, tst = pair.init()
    params = pair.tcp.snapshot_device()
    x = torch.zeros(V, 2, B)
    with pytest.raises(ValueError, match="indexed"):
        pair.teng.step_coef_indexed(tst, pair.tbank, params, x)
    with pytest.raises(ValueError, match="span collapse"):
        pair.teng.collapse_pure(tst, params.select,
                                torch.ones((V, 2), dtype=torch.bool), params)
    with pytest.raises(ValueError, match="new_select"):
        pair.teng.collapse(tst, pair.tbank, params.select,
                           torch.ones((V, 2), dtype=torch.bool))
    with pytest.raises(ValueError, match="params"):
        pair.teng.collapse(tst, pair.tbank, params.select,
                           torch.ones((V, 2), dtype=torch.bool),
                           params.select)
    with pytest.raises(ValueError, match="'allk'"):
        pair.teng.update_bank_slot(pair.tbank, 0, pair.irs[0])
    # the step never launches ring_mac
    before = ring_mac.launches
    pair.teng.step_coef_steady(tst, pair.tbank, params, x)
    assert ring_mac.launches == before


# -- the steps ---------------------------------------------------------------------


@pytest.mark.parametrize("side", ["write", "read"])
def test_steps_and_collapse_match_jax_through_an_interrupt(side):
    """Steady blocks, a re-select (the materializing collapse: base := c *
    sel, sel re-gathered), an interrupt mid-fade (base := a*base + c*sel),
    the general step until the fades decay, then steady again; outputs
    block for block and every state leaf at the events."""
    pair = _Pair(side)
    jst, tst = pair.init()
    rng = np.random.default_rng(3)
    events = {6: [[1, 1], [2, 2], [0, 1], [1, 0]],
              9: [[2, 0], [0, 1], [0, 1], [2, 2]]}
    fading = False
    for t in range(85):
        if t in events:
            jst, tst = pair.reselect(jst, tst, events[t])
            _assert_states_close(jst, tst)
            fading = True
        kind = "general" if fading and t < 75 else "steady"
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind)
        _close(to, jo, f"{side} block {t}")
    assert float(tst.coef_a.max()) < 1e-6
    assert not bool(tst.base_pure.any())
    _assert_states_close(jst, tst)


def test_materialize_and_regather_match_jax():
    """materialize_base clears purity with no bank read (the zero snapshot
    stays zero), and regather_selection re-points the columns at another
    bank: both as the JAX engine, and the steps after them too."""
    pair = _Pair()
    jst, tst = pair.init()
    rng = np.random.default_rng(5)
    for _ in range(3):
        jst, tst, _, _ = pair.step(jst, tst, _x(rng), "steady")
    jst = pair.jeng.materialize_base(jst, pair.jbank)
    tst = pair.teng.materialize_base(tst, pair.tbank)
    _assert_states_close(jst, tst)
    assert not bool(tst.base_pure.any())
    jnew_ir, _ = _banks([0.5 * pair.irs[k] for k in (2, 0, 1)])
    jnew = pair.jeng.prepare_bank(jnew_ir)
    tnew = cascade_bank_from_numpy(pair.teng, np.asarray(jnew.head_rhs2),
                                   np.asarray(jnew.tail_rhs2))
    jst = pair.jeng.regather_selection(jst, jnew,
                                       jnp.asarray(pair.jcp.select))
    tst = pair.teng.regather_selection(tst, tnew,
                                       torch.tensor(pair.tcp.select))
    _assert_states_close(jst, tst)
    pair.jbank, pair.tbank = jnew, tnew
    jst, tst = pair.reselect(jst, tst, [[1, 1]] * V)
    for t in range(12):
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), "general")
        _close(to, jo, f"block {t}")


def test_state_carries_from_a_jax_mid_fade_state():
    """cascade_state_from_numpy carries a JAX 'selected' state captured
    mid-fade, its materialized snapshot included, and the port continues
    block for block."""
    pair = _Pair()
    jst, tst = pair.init()
    rng = np.random.default_rng(7)
    for t in range(8):
        if t == 3:
            jst, tst = pair.reselect(jst, tst, [[2, 2]] * V)
        jst, tst, _, _ = pair.step(jst, tst, _x(rng),
                                   "general" if t >= 3 else "steady")
    assert float(np.asarray(jst.coef_a).max()) > 0.1
    carried = cascade_state_from_numpy(
        pair.teng, {f.name: np.asarray(getattr(jst, f.name))
                    for f in fields(jst)})
    _assert_states_close(jst, carried, 0.0)
    for t in range(10):
        jst, carried, jo, to = pair.step(jst, carried, _x(rng), "general")
        _close(to, jo, f"block {t}")


# -- the session, the bounce, the CLI --------------------------------------------------


def _session_runs(mac_dtype="f32"):
    """StreamSession over a 'selected' cascade in both packages: a MIDI
    re-select, an interrupt, and a swap_bank applied mid-fade. Returns the
    JAX sink data, the port's, and the port's general blocks."""
    irs = _irs()
    jbank_ir, tbank_ir = _banks(irs)
    jnew_ir, tnew_ir = _banks([0.5 * irs[k] for k in (2, 0, 1)])
    jeng, teng = _engines(tbank_ir.max_partitions(B), mac_dtype=mac_dtype)
    x = (np.random.default_rng(4).standard_normal((V, 2, B * 70))
         * 0.05).astype(np.float32)
    midi = [(5, "", bytes([0xB0, 0x15, 64])), (9, "", bytes([0xB0, 0x15, 127]))]
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            cp, engine = JaxControlPlane(V, K, MAXPD), jeng
            banks = (jeng.prepare_bank(jbank_ir), jeng.prepare_bank(jnew_ir))
            mapping, source = JaxCCMapping, JaxWavSource(x, V, B)
        else:
            cp, engine = ControlPlane(V, K, MAXPD, device="cpu"), teng
            banks = (dp.prepare_cascade_bank_device(teng, tbank_ir),
                     dp.prepare_cascade_bank_device(teng, tnew_ir))
            mapping, source = CCMapping, WavSource(x, V, B)
        _configure(cp)
        for ch in range(2):
            cp.set_mapping(0, ch, mapping(message=0xB0, select=0x15))
        sink = _KeepSink()
        if side == "jax":
            sess = JaxSession(engine, banks[0], cp, source, sink, warmup=0,
                              donate=False)
            schedule = JaxMidiSchedule(list(midi))
        else:
            sess = StreamSession(engine, banks[0], cp, source, sink, warmup=0)
            schedule = MidiSchedule(list(midi))
        state = sess.run(engine.init_converged(
            banks[0], jax.tree.map(jnp.asarray, cp.snapshot())
            if side == "jax" else cp.snapshot_device()),
            max_blocks=12, midi=schedule)
        sess.swap_bank(banks[1])
        sess.run(state)
        assert sess._pending_bank is None
        runs[side] = (sink.data, getattr(sess, "general_blocks", None))
    (want, _), (got, general) = runs["jax"], runs["port"]
    assert got.shape == want.shape == (V, 2, B * 70)
    assert np.abs(want).max() > 0.1
    return want, got, general


def test_session_with_reselects_and_swap_matches_jax():
    """StreamSession over a 'selected' cascade in both packages: a MIDI
    re-select, an interrupt, and a swap_bank applied mid-fade (the virtual
    snapshots materialized against the old bank, the columns re-gathered
    from the new one); the same general blocks and the sink data within
    2e-5 of scale."""
    want, got, general = _session_runs()
    assert general >= 20
    _close(got, want, "session")


class _KeepSink:
    def __init__(self):
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block))

    def close(self):
        pass

    @property
    def data(self):
        return np.concatenate(self.blocks, axis=-1)


def _models(num_irs=17, **kwargs):
    """A 17-IR bank, which mac_strategy='auto' sends to 'selected', in a
    ConvolutionReverb(engine='cascade') of each package."""
    irs = _irs(num_irs, seed=11)
    jb, tb = _banks(irs)
    common = dict(num_voices=V, block=B, max_predelay=MAXPD,
                  engine="cascade", cascade_ratio=M, **kwargs)
    jm = JaxReverb(jb, backend="fft", **common)
    tm = ConvolutionReverb(tb, device="cpu", **common)
    for cp in (jm.control, tm.control):
        _configure(cp)
        cp.select[:, 0] = [16, 3, 9, 0]
    assert tm.engine.mac_strategy == jm.engine.mac_strategy == "selected"
    return jm, tm


def test_static_bounce_matches_jax_and_the_automated_one_raises():
    jm, tm = _models()
    x = (np.random.default_rng(9).standard_normal((V, 2, B * 40))
         * 0.05).astype(np.float32)
    want = jax_render_offline(jm, x, segments=2, wire="f32")
    got = render_offline(tm, x, segments=2, wire="f32")
    assert np.abs(want).max() > 0.05
    _close(got, want, "bounce")
    sched = MidiSchedule([(2, "", bytes([0xB0, 0x15, 0x40]))])
    with pytest.raises(ValueError, match="coef-fade"):
        render_offline(tm, x, schedule=sched)


def test_cli_on_a_17_ir_bank_matches_the_jax_cli(tmp_path):
    """--engine cascade over a 17-IR index: both CLIs build the 'selected'
    cascade (mac_strategy 'auto'), stream a re-select and an interrupt,
    and write WAVs within 1 LSB."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav
    from tpu_audio_torch.app.main import main as port_main

    rng = np.random.default_rng(4)
    paths = []
    for k in range(17):
        ir = rng.uniform(-0.3, 0.3, (1500 + 20 * k, 2)).astype(np.float32)
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
              "--engine", "cascade", "--voices", "4", "--cascade-ratio", "4"]
    assert jax_main(common + ["--output", str(tmp_path / "jax.wav")]) == 0
    assert port_main(common + ["--output", str(tmp_path / "port.wav"),
                               "--device", "cpu"]) == 0
    blob = {}
    for name in ("jax", "port"):
        raw = (tmp_path / f"{name}.wav").read_bytes()
        blob[name] = np.frombuffer(raw[raw.index(b"data") + 8:], "<i2")
    assert blob["port"].shape == blob["jax"].shape
    assert np.abs(blob["jax"]).max() > 1000
    assert int(np.abs(blob["port"].astype(np.int32) - blob["jax"]).max()) <= 1


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


# -- bf16 -------------------------------------------------------------------------


def test_bf16_selected_tracks_f32_and_keeps_its_dtypes():
    """The bf16 'selected' cascade (bf16 lines and columns, exact products
    summed in f32) against the port's f32 one through a re-select: above
    40 dB SNR, and the collapse leaves every state dtype as it was."""
    _, tb = _banks(_irs())
    outs = {}
    for dtype in ("f32", "bf16"):
        eng = CascadeConvolution(V, B, tb.max_partitions(B), ratio=M,
                                 max_predelay=MAXPD, num_irs=K,
                                 mac_strategy="selected", mac_dtype=dtype,
                                 device="cpu")
        bank = eng.prepare_bank(tb)
        cp = ControlPlane(V, K, MAXPD, device="cpu")
        _configure(cp)
        state = eng.init_converged(bank, cp.snapshot_device())
        dtypes = {f.name: getattr(getattr(state, f.name), "dtype", None)
                  for f in fields(state)}
        rng = np.random.default_rng(8)
        out = []
        for t in range(50):
            if t == 5:
                old = cp.select.copy()
                cp.select[:] = (old + 1) % K
                cp.vsteps[:] = cp.speed
                state = eng.collapse(
                    state, bank, torch.tensor(old),
                    torch.tensor(old != cp.select),
                    torch.tensor(cp.select), cp.snapshot_device())
                assert {f.name: getattr(getattr(state, f.name), "dtype",
                                        None)
                        for f in fields(state)} == dtypes
            step = eng.step_coef if t >= 5 else eng.step_coef_steady
            state, o = step(state, bank, cp.snapshot_device(),
                            torch.tensor(_x(rng)))
            cp.end_block()
            out.append(o.numpy())
        outs[dtype] = np.concatenate(out, axis=-1)
        if dtype == "bf16":
            assert state.sel_tail.dtype == state.fdl2.dtype == torch.bfloat16
    err = outs["bf16"] - outs["f32"]
    snr = 10 * np.log10((outs["f32"] ** 2).mean() / (err ** 2).mean())
    assert snr > 40.0, snr


def _bits(t):
    return t.view(torch.int16).numpy()


def test_bf16_selected_matches_jax():
    """The bf16 'selected' cascade against the JAX one on the same inputs:
    the JAX bf16 bank carried bit for bit, then steady blocks, a re-select
    and an interrupt (the materializing collapse), the general step,
    materialize_base, regather_selection onto another bank and a re-select
    there, block for block within 2e-3 of scale, the re-gathered columns
    bit for bit; then a session through a re-select, an interrupt and a
    swap_bank within the same limit. The two differ by design: JAX's
    pv_head / pv_tail multiply in bf16 before the f32 sum
    (tpu_audio/engine/cascade.py:677, 880-884), and its tail adds the fresh
    column as a correction delta = new - old taken in bf16 (:866), which
    rounds once the tail ring has wrapped; the port writes the column and
    takes exact products (JAX's 'mxu' form of its 'allk' tail). Measured
    worst case (CPU, numpy seed 12): at most 2.2e-5 of scale until the
    tail ring wraps (block 37), then 1.35e-3 in the steps; 7.1e-4 in the
    session."""
    pair = _Pair(mac_dtype="bf16")
    np.testing.assert_array_equal(
        _bits(pair.tbank.head_rhs2),
        np.asarray(pair.jbank.head_rhs2).view(np.int16))
    np.testing.assert_array_equal(        # JAX's tail is frequency-last
        _bits(pair.tbank.tail_rhs2),
        np.moveaxis(np.asarray(pair.jbank.tail_rhs2).view(np.int16), -1, 0))
    jst, tst = pair.init()
    dtypes = {f.name: getattr(getattr(tst, f.name), "dtype", None)
              for f in fields(tst)}
    assert dtypes["fdl1"] == dtypes["sel_tail"] == torch.bfloat16
    rng = np.random.default_rng(12)
    events = {6: [[1, 1], [2, 2], [0, 1], [1, 0]],
              9: [[2, 0], [0, 1], [0, 1], [2, 2]]}
    worst = 0.0
    for t in range(60):
        if t in events:
            jst, tst = pair.reselect(jst, tst, events[t])
        if t == 40:
            jst = pair.jeng.materialize_base(jst, pair.jbank)
            tst = pair.teng.materialize_base(tst, pair.tbank)
            jnew_ir, _ = _banks([0.5 * pair.irs[k] for k in (2, 0, 1)])
            jnew = pair.jeng.prepare_bank(jnew_ir)
            tnew = cascade_bank_from_numpy(
                pair.teng, np.asarray(jnew.head_rhs2),
                np.asarray(jnew.tail_rhs2))
            jst = pair.jeng.regather_selection(
                jst, jnew, jnp.asarray(pair.jcp.select))
            tst = pair.teng.regather_selection(
                tst, tnew, torch.tensor(pair.tcp.select))
            for name in ("sel_head", "sel_tail"):
                np.testing.assert_array_equal(
                    _bits(_to_jax(name, getattr(tst, name))),
                    np.asarray(getattr(jst, name)).view(np.int16))
            pair.jbank, pair.tbank = jnew, tnew
            jst, tst = pair.reselect(jst, tst, [[1, 1]] * V)
        kind = "general" if t >= 6 else "steady"
        jst, tst, jo, to = pair.step(jst, tst, _x(rng), kind)
        worst = max(worst, _close(to, jo, f"block {t}", ENGINE_REL))
    assert {f.name: getattr(getattr(tst, f.name), "dtype", None)
            for f in fields(tst)} == dtypes
    want, got, general = _session_runs("bf16")
    assert general >= 20
    session = _close(got, want, "session", ENGINE_REL)
    print(f"bf16 'selected' vs JAX: steps {worst:.2e}, session "
          f"{session:.2e} of scale")
    assert worst > 0.0 and session > 0.0
