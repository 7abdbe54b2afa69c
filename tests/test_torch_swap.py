"""The port's StreamSession against the JAX session on the paths beyond the
span fades: live bank swaps mid-fade (the snapshot materialized against the
old bank, then the general step), the span-only deferral of a swap, and the
'selected' strategy, in both delay-line modes where the JAX package has
them.

Both sides get the same IR banks, input blocks and MIDI timeline; the JAX
engines are built with backend="fft" so both sides run an FFT. Sink data
agree to 2e-5 absolute (both f32, different summation orders) — except
where a ring-mode session reads its materialized bf16 snapshot, held to
2e-4: both packages round the same f32 values to bf16, but those values
differ in their last bits, so an entry can round to the neighbouring bf16
value (see tests/test_torch_fmajor.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.fmajor import (
    FMajorPartitionedConvolution as JaxFMajor,
)
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.runtime.stream import StreamSession as JaxSession
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession
from tpu_audio_torch.utils.log import Log

torch.set_num_threads(1)

ATOL = 2e-5
BF16_ATOL = 2e-4
BLOCK = 64
SELECT_CC = 0x15


def _irs(num_irs, ir_len, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _spectra(irs, bank_cls):
    bank = bank_cls()
    for ir in irs:
        bank.append(ir)
    return bank.partitioned_spectra(BLOCK)


class Sessions:
    """One engine geometry in both packages driven by a session each,
    with every voice's channels mapped to the select CC."""

    def __init__(self, tmp_path, irs, num_voices=1, ring=True,
                 swap_snapshot=True, wet=1.0, dry=0.0, speed=200,
                 mac_strategy="allk"):
        spectra = _spectra(irs, IRBank)
        p, k = spectra.shape[2], len(irs)
        kwargs = dict(max_predelay=64, ring=ring, num_irs=k,
                      swap_snapshot=swap_snapshot, mac_strategy=mac_strategy)
        self.jeng = JaxFMajor(num_voices, BLOCK, p, backend="fft", **kwargs)
        self.teng = FMajorPartitionedConvolution(num_voices, BLOCK, p,
                                                 device="cpu", **kwargs)
        self.jcp = JaxControlPlane(num_voices, k, 64)
        self.tcp = ControlPlane(num_voices, k, 64, device="cpu")
        for cp, mapping in ((self.jcp, JaxCCMapping), (self.tcp, CCMapping)):
            for v in range(num_voices):
                for ch in range(2):
                    cp.set_mapping(v, ch, mapping(message=0xB0,
                                                  select=SELECT_CC))
            cp.wet[:], cp.dry[:], cp.speed[:] = wet, dry, speed
        self.tmp = tmp_path
        self.jsess = JaxSession(self.jeng, self.jeng.prepare_bank(spectra),
                                self.jcp, None, None, warmup=0, donate=False)
        self.tsess = StreamSession(self.teng, self.teng.prepare_bank(spectra),
                                   self.tcp, None, None, warmup=0)
        self.jst = self.jeng.init_converged(
            self.jsess.bank, jax.tree.map(jnp.asarray, self.jcp.snapshot()))
        self.tst = self.teng.init_converged(self.tsess.bank,
                                            self.tcp.snapshot_device())
        self.runs = 0

    def run(self, x, events=()):
        """Stream x [V, 2, T] through both sessions; returns both sinks'
        data."""
        self.runs += 1
        jsink = JaxWavSink(self.tmp / f"jax{self.runs}.wav", keep_data=True)
        tsink = WavSink(self.tmp / f"port{self.runs}.wav", keep_data=True)
        v = x.shape[0]
        self.jsess.source, self.jsess.sink = JaxWavSource(x, v, BLOCK), jsink
        self.tsess.source, self.tsess.sink = WavSource(x, v, BLOCK), tsink
        self.jst = self.jsess.run(self.jst, midi=JaxMidiSchedule(
            [(b, "", bytes([0xB0, SELECT_CC, val])) for b, val in events]))
        self.tst = self.tsess.run(self.tst, midi=MidiSchedule(
            [(b, "", bytes([0xB0, SELECT_CC, val])) for b, val in events]))
        return jsink.data, tsink.data

    def swap(self, irs):
        spectra = _spectra(irs, IRBank)
        self.jsess.swap_bank(self.jeng.prepare_bank(spectra))
        self.tsess.swap_bank(self.teng.prepare_bank(spectra))


@pytest.mark.parametrize("ring", [False, True])
def test_swap_mid_pure_fade_keeps_the_old_tail_like_jax(tmp_path, ring):
    """swap_bank during a span (virtual snapshot) fade materializes the
    snapshot against the OLD bank first: the fade-out tail keeps the old
    sound although the new bank (silent here, which makes a lost tail
    binary) replaces the select term (tests/test_fmajor.py:553)."""
    irs = _irs(2, 200, 61)
    s = Sessions(tmp_path, irs, ring=ring)
    x = (np.random.default_rng(61).standard_normal((1, 2, BLOCK * 16))
         * 0.1).astype(np.float32)
    j1, t1 = s.run(x[..., :BLOCK * 6], events=[(2, 64)])
    assert s.tsess.indexed_blocks >= 1 and s.tsess.general_blocks == 0
    assert bool(s.tst.base_pure.all())
    np.testing.assert_allclose(t1, j1, atol=ATOL)
    s.swap([np.zeros((2, 200), np.float32)] * 2)
    j2, t2 = s.run(x[..., BLOCK * 6:])
    assert not bool(s.tst.base_pure.any())  # materialized at the swap
    assert s.tsess.general_blocks == 10 and s.tsess._pending_bank is None
    np.testing.assert_allclose(t2, j2, atol=BF16_ATOL if ring else ATOL)
    assert np.abs(t2[..., :BLOCK * 2]).max() > 1e-2, "fade tail vanished"


@pytest.mark.parametrize("ring", [False, True])
def test_swap_mid_interrupted_fade_matches_jax(tmp_path, ring):
    """A swap after an INTERRUPTED fade (the span snapshot a mixture of two
    bank entries) to the same IRs reordered and scaled by 0.5, then a
    re-select during the materialized fade (the materializing collapse),
    the general step until the fades decay, and the steady step against
    the new bank (tests/test_fmajor.py:600, carried past the swap)."""
    irs = _irs(3, 200, 62)
    s = Sessions(tmp_path, irs, ring=ring, speed=20)
    x = (np.random.default_rng(62).standard_normal((1, 2, BLOCK * 150))
         * 0.1).astype(np.float32)
    j1, t1 = s.run(x[..., :BLOCK * 6], events=[(2, 64), (4, 127)])
    assert bool(s.tst.base_pure.all())
    assert (s.tst.base_g.abs() > 1e-4).sum() >= 2  # a mixture
    np.testing.assert_allclose(t1, j1, atol=ATOL)
    s.swap([irs[k] * 0.5 for k in (2, 0, 1)])
    j2, t2 = s.run(x[..., BLOCK * 6:], events=[(3, 0)])
    assert s.tsess.indexed_blocks == 4
    assert 50 <= s.tsess.general_blocks < 144  # the fades, then steady
    np.testing.assert_allclose(t2, j2, atol=BF16_ATOL if ring else ATOL)
    assert float(s.tst.coef_a.max()) < 1e-6


def test_span_only_swap_defers_until_fades_decay(tmp_path, monkeypatch):
    """swap_snapshot=False: nothing can hold the old bank's tail, so the
    swap waits for the in-flight fade to decay (logged once), then the
    silent new bank takes over; output matches the JAX session
    (tests/test_fmajor.py:695)."""
    infos = []
    monkeypatch.setattr(Log, "info", lambda ident, fmt, *a: infos.append(
        fmt % a))
    irs = _irs(3, 200, 65)
    s = Sessions(tmp_path, irs, num_voices=2, swap_snapshot=False, wet=0.9,
                 speed=8)
    assert s.tst.base.shape == (1,) * 6  # the snapshot really is gone
    x = (np.random.default_rng(66).standard_normal((2, 2, BLOCK * 110))
         * 0.1).astype(np.float32)
    x[..., BLOCK * 100:] = 0.0
    j1, t1 = s.run(x[..., :BLOCK * 6], events=[(2, 64)])
    assert (s.tst.coef_a[0] > 1e-3).all(), "fade must be in flight"
    s.swap([np.zeros((2, 200), np.float32)] * 3)
    j2, t2 = s.run(x[..., BLOCK * 6:])
    assert s.tsess._pending_bank is None, "swap never applied"
    assert sum("bank swap deferred" in m for m in infos) == 1
    assert s.tsess.general_blocks == 0
    np.testing.assert_allclose(np.concatenate([t1, t2], -1),
                               np.concatenate([j1, j2], -1), atol=ATOL)
    assert np.abs(t2[..., :BLOCK * 30]).max() > 1e-3, "old bank fell silent"
    assert np.abs(t2[..., -BLOCK * 2:]).max() < 1e-4, "new bank not applied"


def test_a_long_deferral_is_relogged_every_500_blocks(tmp_path, monkeypatch):
    warns = []
    monkeypatch.setattr(Log, "warn", lambda ident, fmt, *a: warns.append(
        fmt % a))
    s = Sessions(tmp_path, _irs(2, 100, 67), swap_snapshot=False)
    sess = s.tsess
    sess.swap_bank(sess.bank)
    sess._a_host[:] = 1.0  # a fade that never decays
    for _ in range(1000):
        assert sess._apply_pending_bank(s.tst) is s.tst
    assert len(warns) == 2 and "after 1000 blocks" in warns[-1]
    sess._a_host[:] = 0.0
    sess._apply_pending_bank(s.tst)
    assert sess._pending_bank is None


def test_selected_session_matches_jax(tmp_path):
    """A 17-IR bank: mac_strategy='auto' resolves to 'selected' in both
    packages (ring mode, the model's default). Re-selects and an interrupt
    run the materializing collapse and the general step; a swap mid-fade
    re-gathers the per-voice spectra from the new bank."""
    irs = _irs(17, 150, 68)
    models = []
    banks = {}
    for reverb, bank_cls, mapping, kw in (
            (JaxReverb, JaxIRBank, JaxCCMapping, {"backend": "fft"}),
            (ConvolutionReverb, IRBank, CCMapping, {"device": "cpu"})):
        bank = bank_cls()
        for ir in irs:
            bank.append(ir)
        m = reverb(bank, num_voices=2, block=BLOCK, max_predelay=64, **kw)
        for v in range(2):
            for ch in range(2):
                m.control.set_mapping(v, ch, mapping(message=0xB0,
                                                     select=SELECT_CC))
        m.control.wet[:], m.control.dry[:], m.control.speed[:] = 0.8, 0.1, 10
        m.control.predelay[:] = [[7, 7], [40, 0]]
        models.append(m)
        swapped = bank_cls()
        for k in range(17):  # the same IRs reordered and scaled by 0.5
            swapped.append(irs[(k * 5) % 17] * 0.5)
        banks[id(m)] = m.engine.prepare_bank(
            swapped.partitioned_spectra(BLOCK))
    jm, tm = models
    assert jm.engine.mac_strategy == tm.engine.mac_strategy == "selected"
    x = (np.random.default_rng(69).standard_normal((2, 2, BLOCK * 80))
         * 0.05).astype(np.float32)
    events = [(4, 40), (7, 100), (40, 10)]
    outs = []
    for m, src, sink, sched in (
            (jm, JaxWavSource, JaxWavSink, JaxMidiSchedule),
            (tm, WavSource, WavSink, MidiSchedule)):
        kw = {"donate": False} if m is jm else {}
        sess = m.session(src(x[..., :BLOCK * 10], 2, BLOCK),
                         sink(tmp_path / "a.wav", keep_data=True),
                         warmup=0, **kw)
        state = sess.run(m.init_state(), midi=sched(
            [(b, "", bytes([0xB0, SELECT_CC, val])) for b, val in events]))
        first = sess.sink.data
        sess.swap_bank(banks[id(m)])
        sess.sink = sink(tmp_path / "b.wav", keep_data=True)
        sess.source = src(x[..., BLOCK * 10:], 2, BLOCK)
        sess.run(state, midi=sched(
            [(b - 10, "", bytes([0xB0, SELECT_CC, val]))
             for b, val in events if b >= 10]))
        outs.append(np.concatenate([first, sess.sink.data], -1))
        if m is tm:
            assert sess.indexed_blocks == 0
            assert sess.general_blocks >= 40
    np.testing.assert_allclose(outs[1], outs[0], atol=BF16_ATOL)
    np.testing.assert_array_equal(tm.control.select, jm.control.select)


@pytest.mark.parametrize("ring", [False, True])
def test_selected_session_materializes_a_virtual_snapshot_at_run_start(
        tmp_path, ring):
    """'selected' has no indexed step: a run that starts with a fade in
    flight whose snapshot is virtual (base_pure, here the zero snapshot
    under a stale `base` full of noise) materializes it once at run start,
    as the JAX session does, so the general step fades in from silence."""
    from dataclasses import replace

    s = Sessions(tmp_path, _irs(3, 200, 70), num_voices=2, ring=ring,
                 mac_strategy="selected", speed=20)
    stale = np.random.default_rng(70).standard_normal(
        s.tst.base.shape).astype(np.float32)
    s.jst = replace(s.jst, coef_a=jnp.full((2, 2), 0.6, jnp.float32),
                    base=jnp.asarray(stale, s.jst.base.dtype))
    s.tst = replace(s.tst, coef_a=torch.full((2, 2), 0.6),
                    base=torch.tensor(stale).to(s.tst.base.dtype))
    x = (np.random.default_rng(71).standard_normal((2, 2, BLOCK * 12))
         * 0.1).astype(np.float32)
    j, t = s.run(x)
    assert not bool(s.tst.base_pure.any())
    assert float(s.tst.base.float().abs().max()) == 0.0
    assert s.tsess.general_blocks == 12
    np.testing.assert_allclose(t, j, atol=ATOL)
