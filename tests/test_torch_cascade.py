"""The port's cascade engine (tpu_audio_torch/engine/cascade.py) against the
JAX engine on identical banks, inputs and parameters: the tail MAC, the
banks, the steps under both predelay sides, a session with a deferred bank
swap, the CLI, the working set and the guards.

Shapes are tests/test_cascade.py's (B=32, ratio 4, V=4, K=3, 1200-sample
IRs). The JAX engine is built with backend="fft", so both sides run an FFT.
Tolerances: the tail MAC to 1e-5 of its scale (f32 sums in another order,
the port adding the fresh column before the MAC); banks to 1e-6 of scale
(f32 FFTs of two libraries; the host packs are the same numpy code and
bit-equal); steps, states and sessions to 2e-5 of the output's scale; the
CLI WAVs to 1 LSB of 16-bit PCM (the JAX CLI runs its matmul DFT); the
working set's residency counters exactly.
"""

from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import device_prep as jax_dp
from tpu_audio.engine.cascade import CascadeConvolution as JaxCascade
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.models.reverb import _fit_cascade_ratio as jax_fit_ratio
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.runtime.stream import StreamSession as JaxSession
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine.cascade import (
    CascadeConvolution, cascade_bank_from_numpy, cascade_state_from_numpy,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.models.reverb import _fit_cascade_ratio
from tpu_audio_torch.ops.ring_mac import ring_mac_reference
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

torch.set_num_threads(1)

B, M, V, K, IR_LEN, MAXPD = 32, 4, 4, 3, 1200, 64
DEEP_PD = 8 * B + 17          # q up to 8 with a sub-block spill (NH = 10)
ATOL = 2e-5


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


def _engines(parts, voices=V, **kwargs):
    kwargs.setdefault("max_predelay", MAXPD)
    kwargs.setdefault("num_irs", K)
    return (JaxCascade(voices, B, parts, ratio=M, backend="fft", **kwargs),
            CascadeConvolution(voices, B, parts, ratio=M, device="cpu",
                               **kwargs))


def _close(got, want, what, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"


def _jax_fdl2(fdl2):
    """The port's fdl2 [M, F2, 2*Vg, d, P2p] in the JAX layout [M, Vg, I,
    d, P2p, F2]."""
    m, f2, rows, d, pp2 = fdl2.shape
    return fdl2.reshape(m, f2, rows // 2, 2, d, pp2).permute(0, 2, 3, 4, 5, 1)


def _jax_tail_cols(cols):
    """A 'selected' tail column leaf of the port [M, F2, 2*Vg, d, 2P2p, OD]
    in the JAX layout [M, Vg, I, d, 2P2p, OD, F2] (the 'allk' size-1
    placeholder as the JAX one)."""
    if cols.numel() == 1:
        return cols.reshape((1,) * 7)
    m, f2, rows, d, q, od = cols.shape
    return cols.reshape(m, f2, rows // 2, 2, d, q, od).permute(
        0, 2, 3, 4, 5, 6, 1)


def _assert_states_close(jst, tst, tol):
    assert tst.step == int(jst.t) == int(tst.t)
    for f in fields(tst):
        name = f.name
        if name in ("t", "step"):
            continue
        got = getattr(tst, name)
        got = _jax_fdl2(got) if name == "fdl2" else got
        got = _jax_tail_cols(got) if name in ("sel_tail", "base_tail") else got
        want = np.asarray(getattr(jst, name))
        assert str(got.dtype).split(".")[-1] == want.dtype.name, name
        if got.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        elif got.dtype == torch.bfloat16:
            np.testing.assert_allclose(got.float().numpy(),
                                       want.astype(np.float32), atol=tol,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got.numpy(), want, atol=tol,
                                       err_msg=name)


def _configure(cp, voices=V, maxpd=MAXPD):
    cp.wet[:] = 0.8
    cp.dry[:] = 0.15
    cp.level[:] = 0.9
    cp.pan_wet[:] = ([[-0.5, 0.25]] * (voices // 2)
                     + [[0.0, 0.75]] * (voices - voices // 2))
    cp.predelay[:, 0] = np.minimum([0, 9, 37, 63] * (voices // 4), maxpd)
    cp.select[:, 0] = np.arange(voices) % K
    cp.select[:, 1] = (np.arange(voices) + 1) % K


# -- the tail MAC and the banks ------------------------------------------------------


@pytest.mark.parametrize("form", ["vpu", "mxu"])
def test_tail_mac_matches_jax(form):
    """Group g's tail MAC on the port's layout (the fresh column written,
    then ring_mac_reference, selection and span term) against JAX
    _tail_mac_allk on the pre-update line plus its fresh-column term."""
    irs = _irs()
    jbank_ir, _ = _banks(irs)
    jeng, teng = _engines(IR_LEN // B + 1, tail_mac=form)
    assert jeng.tail_mac == teng.tail_mac == form
    jbank = jeng.prepare_bank(jbank_ir)
    tbank = cascade_bank_from_numpy(teng, np.asarray(jbank.head_rhs2),
                                    np.asarray(jbank.tail_rhs2))
    rng = np.random.default_rng(5)
    vg, pp2, f2, g = V // M, jeng.pp2, jeng.f2, 3
    old = rng.standard_normal((vg, 2, 2, pp2, f2)).astype(np.float32)
    fresh = rng.standard_normal((vg, 2, 2, 1, f2)).astype(np.float32)
    select = rng.integers(0, K, (V, 2)).astype(np.int32)
    base_g = rng.standard_normal((V, 2, K)).astype(np.float32)
    scale = rng.uniform(0.2, 1.0, (V, 2, 2)).astype(np.float32)
    for w2 in (0, 1, pp2 // 2 + 1, pp2 - 1):
        old_col = old[:, :, :, w2: w2 + 1]

        def group(arr):
            return jnp.asarray(arr).reshape((vg, M) + arr.shape[1:])[:, g]

        params = jax.tree.map(jnp.asarray,
                              JaxControlPlane(V, K, MAXPD).snapshot())
        params = params.__class__(**{**vars(params),
                                     "select": jnp.asarray(select)})
        state = jeng.init_state()
        state = state.__class__(**{**vars(state),
                                   "base_g": jnp.asarray(base_g)})
        want = jeng._tail_mac_allk(state, jbank, params, jnp.asarray(old),
                                   jnp.asarray(fresh - old_col),
                                   jnp.int32(w2), vg, group,
                                   group(scale), True)
        new = old.copy()
        new[:, :, :, w2: w2 + 1] = fresh
        # [Vg, I, d, P2p, F2] -> the port's [F2, 2*Vg, d, P2p]
        fdl = torch.tensor(np.ascontiguousarray(
            np.transpose(new, (4, 0, 1, 2, 3))).reshape(f2, vg * 2, 2, pp2))
        m2 = ring_mac_reference(w2, fdl, tbank.tail_rhs2)
        y_sel, y_base = teng._allk_terms(
            m2, torch.tensor(select).reshape(vg, M, 2)[:, g],
            torch.tensor(base_g).reshape(vg, M, 2, K)[:, g], True)
        s = torch.tensor(scale).reshape(vg, M, 2, 2)[:, g][:, :, :, None]
        for got, ref in ((y_sel * s, want[0]), (y_base * s, want[1])):
            # [F2, Vg, I, O, d] against JAX [Vg, I, O, d, F2]
            _close(got.permute(1, 2, 3, 4, 0).numpy(), ref,
                   f"{form} w2={w2}", 1e-5)


def test_banks_match_jax_and_carry_across():
    """The device-prepared bank (the model's path) against JAX prepare_bank
    and prepare_cascade_bank_device through cascade_bank_from_numpy; the
    host pack is the JAX package's numpy code, bit for bit."""
    irs = _irs()
    jbank_ir, tbank_ir = _banks(irs)
    jeng, teng = _engines(tbank_ir.max_partitions(B))
    host = jeng.prepare_bank(jbank_ir)
    jdev = jax_dp.prepare_cascade_bank_device(jeng, jbank_ir, wire="f32")
    tdev = dp.prepare_cascade_bank_device(teng, tbank_ir)
    thost = teng.prepare_bank(tbank_ir)
    assert tdev.num_irs == host.num_irs == K
    for jb in (host, jdev):
        carried = cascade_bank_from_numpy(teng, np.asarray(jb.head_rhs2),
                                          np.asarray(jb.tail_rhs2))
        for name in ("head_rhs2", "tail_rhs2"):
            _close(getattr(tdev, name), getattr(carried, name), name, 1e-6)
    carried = cascade_bank_from_numpy(teng, np.asarray(host.head_rhs2),
                                      np.asarray(host.tail_rhs2))
    for name in ("head_rhs2", "tail_rhs2"):
        np.testing.assert_array_equal(getattr(thost, name).numpy(),
                                      getattr(carried, name).numpy())
    head, tail = teng._pack_bank_host(
        tbank_ir.partitioned_spectra(B, max_partitions=teng.head_parts),
        np.zeros((K, 2, teng.tail_parts, teng.b2 + 1), np.complex64))
    np.testing.assert_array_equal(head, thost.head_rhs2.numpy())
    assert tail.shape == tuple(thost.tail_rhs2.shape) and not tail.any()


def test_geometry_and_init_state_match_jax():
    jeng, teng = _engines(IR_LEN // B + 1)
    for name in ("b2", "head_parts", "tail_parts", "pp1", "pp2", "f1", "f2",
                 "tail_slot0", "ring_slots", "head_slots", "t_modulus",
                 "history_blocks", "swap_snapshot",
                 "collapse_pure_takes_params"):
        assert getattr(teng, name) == getattr(jeng, name), name
    jst, tst = jeng.init_state(), teng.init_state()
    _assert_states_close(jst, tst, 0.0)
    clone, jclone = teng.with_voices(8), jeng.with_voices(8)
    assert (clone.num_voices, clone.ratio, clone.xf2) == (8, M, teng.xf2)
    assert clone.history_blocks == jclone.history_blocks
    assert teng.with_voices(512).tail_mac == jeng.with_voices(512).tail_mac


# -- the steps ---------------------------------------------------------------------


@pytest.mark.parametrize("side", ["write", "read"])
def test_steps_match_jax_block_for_block(side):
    """Steady and indexed steps with collapse_pure, block for block and
    state leaf for state leaf: a re-select, an interrupt, a predelay edit
    past t = 4*NH (where the JAX read side's first retime broke), and one
    event that edits predelay and re-selects at once."""
    irs = _irs()
    jbank_ir, tbank_ir = _banks(irs)
    jeng, teng = _engines(tbank_ir.max_partitions(B),
                          max_predelay=DEEP_PD, predelay_side=side)
    jbank = jeng.prepare_bank(jbank_ir)
    tbank = cascade_bank_from_numpy(teng, np.asarray(jbank.head_rhs2),
                                    np.asarray(jbank.tail_rhs2))
    jcp, tcp = (JaxControlPlane(V, K, DEEP_PD),
                ControlPlane(V, K, DEEP_PD, device="cpu"))
    for cp in (jcp, tcp):
        _configure(cp, maxpd=DEEP_PD)
        cp.predelay[:, 0] = [DEEP_PD, 9, 100, 63]
    nh = teng.head_slots
    assert 4 * nh < 45
    j_steps = {"steady": jax.jit(jeng.step_coef_steady),
               "indexed": jax.jit(jeng.step_coef_indexed)}
    t_steps = {"steady": teng.step_coef_steady,
               "indexed": teng.step_coef_indexed}
    j_collapse = jax.jit(jeng.collapse_pure)
    jst = jeng.init_converged(jbank, jax.tree.map(jnp.asarray,
                                                  jcp.snapshot()))
    tst = teng.init_converged(tbank, tcp.snapshot_device())
    rng = np.random.default_rng(13)
    outs = []
    for t in range(64):
        reselect = t in (7, 11, 56)
        if t in (45, 56):   # predelay edits, both directions
            for cp in (jcp, tcp):
                cp.predelay[:, 0] = ([5, 200, 40, DEEP_PD] if t == 45
                                     else [DEEP_PD, 0, 33, 64])
        if reselect:
            old = tcp.select.copy()
            for cp in (jcp, tcp):
                cp.select[:, t % 2] = (cp.select[:, t % 2] + 1) % K
                cp.vsteps[:] = 9
            changed = old != tcp.select
            jst = j_collapse(jst, jnp.asarray(old), jnp.asarray(changed),
                             jax.tree.map(jnp.asarray, jcp.snapshot()))
            tst = teng.collapse_pure(tst, torch.tensor(old),
                                     torch.tensor(changed),
                                     tcp.snapshot_device())
        kind = "steady" if t < 7 else "indexed"
        x = (rng.standard_normal((V, 2, B)) * 0.05).astype(np.float32)
        jst, jo = j_steps[kind](jst, jbank, jax.tree.map(
            jnp.asarray, jcp.snapshot()), jnp.asarray(x))
        tst, to = t_steps[kind](tst, tbank, tcp.snapshot_device(),
                                torch.tensor(x))
        for cp in (jcp, tcp):
            cp.end_block()
        outs.append((np.asarray(jo), to.numpy()))
        if t in (30, 63):
            _assert_states_close(jst, tst, ATOL)
    want = np.concatenate([o[0] for o in outs], axis=-1)
    got = np.concatenate([o[1] for o in outs], axis=-1)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= ATOL * np.abs(want).max()
    # carried across: the JAX state resumes on the port
    carried = cascade_state_from_numpy(
        teng, {f.name: np.asarray(getattr(jst, f.name)) for f in fields(jst)})
    _assert_states_close(jst, carried, 0.0)


# -- the session, the model and the CLI ----------------------------------------------


class _KeepSink:
    """Keeps every block across runs (a session closes its sink at the end
    of each run)."""

    def __init__(self):
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block))

    def close(self):
        pass

    @property
    def data(self):
        return np.concatenate(self.blocks, axis=-1)


def test_session_with_deferred_swap_matches_jax():
    """StreamSession over both engines: a MIDI re-select, an interrupt and a
    swap_bank requested mid-fade, which the span-only cascade defers until
    the fades decay; the same indexed blocks, the same swap block, and the
    sink data within 2e-5."""
    irs = _irs()
    jbank_ir, tbank_ir = _banks(irs)
    jnew_ir, tnew_ir = _banks([0.5 * irs[k] for k in (2, 0, 1)])
    jeng, teng = _engines(tbank_ir.max_partitions(B))
    x = (np.random.default_rng(4).standard_normal((V, 2, B * 90))
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
        cp.speed[:] = 8
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
        state = sess.run(engine.init_state(), max_blocks=12, midi=schedule)
        sess.swap_bank(banks[1])
        applied = []
        apply = sess._apply_pending_bank

        def watch(state, apply=apply, sess=sess, applied=applied):
            state = apply(state)
            applied.append(sess._pending_bank is None)
            return state

        sess._apply_pending_bank = watch
        sess.run(state)
        assert sess._pending_bank is None
        assert side == "jax" or sess.bank is banks[1]
        runs[side] = (sink.data, sess.indexed_blocks, 12 + applied.index(True))
    (want, j_indexed, j_swap), (got, t_indexed, t_swap) = (runs["jax"],
                                                          runs["port"])
    assert t_indexed == j_indexed >= 10
    assert t_swap == j_swap > 12 + 8      # deferred past the fade
    assert got.shape == want.shape == (V, 2, B * 90)
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= ATOL * np.abs(want).max()


@pytest.mark.parametrize("requested,voices,parts", [
    (16, 4, 63), (16, 64, 700), (16, 48, 700), (8, 6, 100), (16, 1024, 690),
    (4, 3, 7)])
def test_fit_cascade_ratio_matches_jax(requested, voices, parts):
    assert (_fit_cascade_ratio(requested, voices, parts)
            == jax_fit_ratio(requested, voices, parts))


SETTINGS = """
conv.count 2
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].cc.predelay 22
conv[0].value.select 1
conv[0].value.predelay 40
conv[0].value.dry 0.3
conv[0].value.wet 0.7
conv[0].value.speed 6
conv[0].value.panWet 0.25
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.message 176
conv[1].cc.select 21
conv[1].cc.predelay 22
conv[1].value.select 0
conv[1].value.predelay 40
conv[1].value.dry 0.3
conv[1].value.wet 0.7
conv[1].value.speed 6
conv[1].value.panWet -0.5
"""

# a re-select, an interrupting one, then a predelay edit
MIDI = "4 B0 15 40\n7 B0 15 7F\n40 B0 16 60\n"


@pytest.mark.parametrize("side", ["write", "read"])
def test_cli_cascade_matches_the_jax_cli_within_one_lsb(tmp_path, side):
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
    (tmp_path / "events.txt").write_text(MIDI)
    x = rng.uniform(-0.2, 0.2, (32 * 90, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    common = ["--settings", str(tmp_path / "settings.txt"),
              "--input", str(tmp_path / "in.wav"), "--midi",
              str(tmp_path / "events.txt"), "--block-size", "32", "--quiet",
              "--engine", "cascade", "--voices", "4", "--predelay-side", side]
    assert jax_main(common + ["--output", str(tmp_path / "jax.wav")]) == 0
    assert port_main(common + ["--output", str(tmp_path / "port.wav"),
                               "--device", "cpu"]) == 0
    blob = {}
    for name in ("jax", "port"):
        raw = (tmp_path / f"{name}.wav").read_bytes()
        blob[name] = np.frombuffer(raw[raw.index(b"data") + 8:], "<i2")
    assert blob["port"].shape == blob["jax"].shape
    assert blob["port"].size >= 32 * 90 * 2
    assert np.abs(blob["jax"]).max() > 1000
    assert int(np.abs(blob["port"].astype(np.int32) - blob["jax"]).max()) <= 1
    if side == "write":
        # the partitioned engine runs through the same flags since its port
        part = common[:-2] + ["--engine", "partitioned"]
        assert jax_main(part + ["--output", str(tmp_path / "jax_p.wav")]) == 0
        assert port_main(part + ["--output", str(tmp_path / "port_p.wav"),
                                 "--device", "cpu"]) == 0
        for name in ("jax_p", "port_p"):
            raw = (tmp_path / f"{name}.wav").read_bytes()
            blob[name] = np.frombuffer(raw[raw.index(b"data") + 8:], "<i2")
        assert blob["port_p"].shape == blob["jax_p"].shape
        assert int(np.abs(blob["port_p"].astype(np.int32)
                          - blob["jax_p"]).max()) <= 1


def test_model_builds_the_cascade_like_jax():
    irs = _irs(ir_len=2000)
    jbank_ir, tbank_ir = _banks(irs)
    jm = JaxReverb(jbank_ir, num_voices=8, block=B, max_predelay=MAXPD,
                   engine="cascade", backend="fft", cascade_ratio=16,
                   predelay_side="read")
    tm = ConvolutionReverb(tbank_ir, num_voices=8, block=B,
                           max_predelay=MAXPD, engine="cascade",
                           cascade_ratio=16, predelay_side="read",
                           tail_mac="mxu", device="cpu")
    assert isinstance(tm.engine, CascadeConvolution)
    assert (tm.engine.ratio, tm.engine.predelay_side, tm.engine.pp2) == (
        jm.engine.ratio, jm.engine.predelay_side, jm.engine.pp2) == (
        8, "read", jm.engine.pp2)
    assert tm.engine.tail_mac == "mxu"
    assert tm.bank_bytes() == 4 * (tm.spectra.head_rhs2.numel()
                                   + tm.spectra.tail_rhs2.numel())
    st = tm.init_state()
    np.testing.assert_array_equal(st.coef_c.numpy(), tm.control.wet)


# -- the working set -----------------------------------------------------------------

WS_V, WS_KFULL, WS_CAP = 2, 6, 3
WS_CCS = {(0, 0): 0x15, (0, 1): 0x16, (1, 0): 0x17, (1, 1): 0x18}


def _value_for(full, k=WS_KFULL):
    return next(v for v in range(128) if v * k // 128 == full)


def _ws_irs():
    rng = np.random.default_rng(6)
    return [(rng.standard_normal((2, 700 - 37 * k)) * 0.3).astype(np.float32)
            for k in range(WS_KFULL)]


@pytest.mark.parametrize("async_paging", [False, True])
def test_working_set_cascade_matches_jax(async_paging):
    """ConvolutionReverb(engine='cascade', bank_capacity=3) against the JAX
    model: misses, hits and a starved select re-issued by the poll (async:
    drained at every block end, so each deferred select applies at a
    schedule-independent block). Identical residency and counters, sink
    data within 2e-5, the resident banks within 1e-6 of scale."""
    jbank_ir, tbank_ir = _banks(_ws_irs())
    x = (np.random.default_rng(8).standard_normal((WS_V, 2, B * 120))
         * 0.05).astype(np.float32)
    script = [(6, (0, 0), 4), (9, (0, 1), 5), (12, (1, 0), 4), (20, (1, 1), 3),
              (30, (1, 0), 5), (80, (0, 1), 1)]
    events = [(blk, "", bytes([0xB0, WS_CCS[vc], _value_for(full)]))
              for blk, vc, full in script]
    common = dict(num_voices=WS_V, block=B, max_predelay=MAXPD,
                  engine="cascade", bank_capacity=WS_CAP,
                  async_paging=async_paging)
    jm = JaxReverb(jbank_ir, backend="fft", bank_prep="device", **common)
    tm = ConvolutionReverb(tbank_ir, device="cpu", **common)
    assert isinstance(tm.engine, CascadeConvolution) and tm.engine.ratio == 2
    data = []
    for model, jax_side in ((jm, True), (tm, False)):
        ws, cp = model.working_set, model.control
        ws.min_age_blocks = 20
        cp.wet[:] = 0.8
        cp.speed[:] = 6
        for (v, c), cc in WS_CCS.items():
            cp.set_mapping(v, c, (JaxCCMapping if jax_side else CCMapping)(
                message=0xB0, select=cc))
        if async_paging:
            cp.block_hooks.append(ws.drain)
        if jax_side:
            sink = JaxWavSink("/dev/null", keep_data=True)
            sess = model.session(JaxWavSource(x, WS_V, B), sink, warmup=0)
            sess.run(model.init_state(), midi=JaxMidiSchedule(list(events)))
        else:
            sink = WavSink("/dev/null", keep_data=True)
            sess = model.session(WavSource(x, WS_V, B), sink, warmup=0)
            sess.run(model.init_state(), midi=MidiSchedule(list(events)))
        ws.close()
        data.append(sink.data)
    jws, tws = jm.working_set, tm.working_set
    for name in ("slot_to_full", "misses", "hits", "starved", "deferred",
                 "warmups"):
        assert getattr(tws, name) == getattr(jws, name), name
    assert tm.control.select.tolist() == jm.control.select.tolist()
    assert tws.misses >= 2 and tws.starved >= 1
    assert (tws.deferred >= 2) == async_paging
    assert tm.spectra is tws.bank
    want, got = data
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= ATOL * np.abs(want).max()
    for name in ("head_rhs2", "tail_rhs2"):
        carried = cascade_bank_from_numpy(
            tm.engine, np.asarray(jws.bank.head_rhs2),
            np.asarray(jws.bank.tail_rhs2))
        _close(getattr(tws.bank, name), getattr(carried, name), name, 1e-6)


def test_update_bank_slot_equals_a_rebuild():
    """The time-domain slot update (an IR longer than the resident ones)
    against a device prep of the bank with that IR in the slot, and
    against the JAX engine's update_bank_slot."""
    rng = np.random.default_rng(7)
    irs = [(rng.standard_normal((2, 900)) * 0.3).astype(np.float32)
           for _ in range(4)]
    jeng = JaxCascade(4, B, 900 // B + 1, ratio=2, max_predelay=MAXPD,
                      num_irs=3, backend="fft")
    teng = CascadeConvolution(4, B, 900 // B + 1, ratio=2,
                              max_predelay=MAXPD, num_irs=3, device="cpu")
    jsub, tsub = _banks(irs[:3])
    tbank = dp.prepare_cascade_bank_device(teng, tsub)
    updated = teng.update_bank_slot(tbank, 1, irs[3])
    assert updated is tbank
    _, tsub2 = _banks([irs[0], irs[3], irs[2]])
    want = dp.prepare_cascade_bank_device(
        CascadeConvolution(4, B, 900 // B + 1, ratio=2, max_predelay=MAXPD,
                           num_irs=3, device="cpu"), tsub2)
    jupd = jeng.update_bank_slot(jeng.prepare_bank(jsub), 1, irs[3])
    jcarried = cascade_bank_from_numpy(teng, np.asarray(jupd.head_rhs2),
                                       np.asarray(jupd.tail_rhs2))
    for name in ("head_rhs2", "tail_rhs2"):
        _close(getattr(updated, name), getattr(want, name), name, 1e-6)
        _close(getattr(updated, name), getattr(jcarried, name), name, 1e-6)


# -- guards ------------------------------------------------------------------------


def test_guards_match_jax():
    irs = _irs()
    jbank_ir, tbank_ir = _banks(irs)
    parts = tbank_ir.max_partitions(B)
    for args, match in (((3, B, 40), "divisible"), ((V, B, 2 * M), "fmajor")):
        for cls, extra in ((JaxCascade, {}), (CascadeConvolution,
                                              {"device": "cpu"})):
            with pytest.raises(ValueError, match=match):
                cls(*args, ratio=M, **extra)
    for kwargs in ({"mac_dtype": "f16"}, {"predelay_side": "both"},
                   {"tail_mac": "tpu"}, {"mac_strategy": "nope"},
                   {"mac_strategy": "auto"}):
        with pytest.raises(ValueError):
            JaxCascade(V, B, parts, ratio=M, **kwargs)
        with pytest.raises(ValueError):
            CascadeConvolution(V, B, parts, ratio=M, device="cpu", **kwargs)
    # bf16 and 'selected' (refused before they were ported) build as the
    # JAX engine does: the same resolved strategy, fade protocol and state
    # leaves (tests/test_torch_bf16.py and test_torch_cascade_selected.py
    # hold their steps to it)
    for kwargs in ({"mac_dtype": "bf16"}, {"mac_strategy": "selected"},
                   {"mac_strategy": "auto", "num_irs": 17}):
        built = CascadeConvolution(V, B, parts, ratio=M, device="cpu",
                                   **kwargs)
        want = JaxCascade(V, B, parts, ratio=M, **kwargs)
        assert built.mac_strategy == want.mac_strategy
        assert built.swap_snapshot == want.swap_snapshot
        assert built.fade_protocol == ("selected" if kwargs.get(
            "mac_strategy") else "spans")
        if built.num_irs is None:
            built.num_irs = want.num_irs = K
        _assert_states_close(want.init_state(), built.init_state(), 0.0)
    big_irs = [irs[k % K] for k in range(17)]
    jbig, big = _banks(big_irs)
    built = ConvolutionReverb(big, num_voices=V, block=B, max_predelay=MAXPD,
                              engine="cascade", cascade_ratio=M,
                              device="cpu")
    want = JaxReverb(jbig, num_voices=V, block=B, max_predelay=MAXPD,
                     engine="cascade", backend="fft", cascade_ratio=M)
    assert built.engine.mac_strategy == want.engine.mac_strategy == "selected"
    for engine in ("partitioned", "monolithic"):
        # ported since: the model builds the JAX model's engine class
        built = ConvolutionReverb(tbank_ir, block=B, engine=engine,
                                  fft_size=4096, device="cpu")
        want = JaxReverb(jbank_ir, block=B, engine=engine, fft_size=4096,
                         backend="fft")
        assert type(built.engine).__name__ == type(want.engine).__name__
    with pytest.raises(ValueError, match="init_state"):
        CascadeConvolution(V, B, parts, ratio=M, device="cpu").init_state()

    teng = CascadeConvolution(V, B, parts, ratio=M, device="cpu")
    tbank = teng.prepare_bank(tbank_ir)
    cp = ControlPlane(V, K, MAXPD, device="cpu")
    params = cp.snapshot_device()
    state = teng.init_converged(tbank, params)
    changed = torch.ones((V, 2), dtype=torch.bool)
    for call in (lambda: teng.step_coef(state, tbank, params,
                                        torch.zeros(V, 2, B)),
                 lambda: teng.collapse(state, tbank, params.select, changed,
                                       params.select, params),
                 lambda: teng.materialize_base(state, tbank),
                 lambda: teng.regather_selection(state, tbank,
                                                 params.select)):
        with pytest.raises(ValueError, match="span-only"):
            call()
    # a JAX bf16 bank leaf carries across bit for bit
    head = np.arange(8, dtype=np.float32).reshape(1, 1, 2, 4) * 0.3
    carried = cascade_bank_from_numpy(teng, head.astype(jnp.bfloat16),
                                      np.zeros((1, 1, 4, 1), np.float32))
    assert carried.head_rhs2.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        carried.head_rhs2.view(torch.int16).numpy(),
        head.astype(jnp.bfloat16).view(np.int16))
