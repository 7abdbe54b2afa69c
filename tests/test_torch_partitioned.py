"""The port's partitioned engine (tpu_audio_torch/engine/partitioned.py, both
variants) and its session, checkpoint and offline paths, against the JAX
package; the monolithic engine rides the same scenarios beside it.

The same numpy inputs, made from seeds, go through both packages on the CPU.
The JAX engines are built with backend="fft" so both sides run an FFT.
Sizes: 2 voices, 64-frame blocks, fftSize 1024, IRs of 256-500 samples.
Tolerances: engine outputs and state fields within 2e-5 of their scale
(f32 sums in another order); the two partitioned variants within 2e-5 of
scale of each other at every block; the monolithic engine against them
2e-3 while the IR is settled (tests/test_engine.py's bound: input- vs
output-synchronous fades differ mid-fade by design); session sink data 2e-5
absolute; a checkpoint resume to the bit; static bounces 3e-5 (the JAX
renderer refuses these engines' automated bounce, and so does the port);
CLI WAVs within 1 LSB of the JAX CLI's, which runs its matmul DFT.
"""

import functools
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import MonolithicConvolution as JaxMonolithic
from tpu_audio.engine import PartitionedConvolution as JaxPartitioned
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.io.index import write_index
from tpu_audio.io.wav import write_wav
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.ops import smoother as jax_smoother
from tpu_audio.runtime import offline as jax_offline
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import (
    CascadeConvolution, ControlPlane, FMajorPartitionedConvolution, IRBank,
    MonolithicConvolution, PartitionedConvolution,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.ops import smoother
from tpu_audio_torch.runtime import offline
from tpu_audio_torch.runtime.backends import WavSource
from tpu_audio_torch.runtime.checkpoint import load_checkpoint
from tpu_audio_torch.runtime.stream import MidiSchedule, engine_steps

torch.set_num_threads(1)

V, B, FFT = 2, 64, 1024
KINDS = ["coef", "materialized", "monolithic"]
SELECT_CC, WET_CC = 0x15, 0x18


def _irs(num_irs=3, ir_len=256, seed=11):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * np.float32(0.5 / np.abs(ir).max()))
    return out


def _bank(jax_side, irs):
    bank = JaxIRBank() if jax_side else IRBank()
    for ir in irs:
        bank.append(ir)
    return bank


def _scaled_err(got, want):
    """max |got - want| over the scale of `want`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


# -- module 1: the smoother ----------------------------------------------------------


@pytest.mark.parametrize("vsteps", [0, 3, 40])
def test_slew_and_countdown_match_jax(vsteps):
    rng = np.random.default_rng(vsteps)
    shape = (2, 2, 2, 3, 9)
    active, target = (
        (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64) for _ in range(2))
    wet = rng.uniform(0, 1, (2, 2, 1, 1, 1)).astype(np.float32)
    vs = np.full((2, 2, 1, 1, 1), vsteps, np.int32)
    want = jax_smoother.slew_spectra(active, target, wet, vs)
    got = smoother.slew_spectra(torch.from_numpy(active),
                                torch.from_numpy(target),
                                torch.from_numpy(wet), torch.from_numpy(vs))
    assert got.dtype == torch.complex64
    assert _scaled_err(got.numpy(), want) <= 1e-6
    counts = np.array([0, 1, vsteps], np.int32)
    np.testing.assert_array_equal(
        smoother.vsteps_decrement(torch.from_numpy(counts)).numpy(),
        np.asarray(jax_smoother.vsteps_decrement(counts)))


def test_gather_spectra_matches_jax_take():
    rng = np.random.default_rng(5)
    shape = (4, 2, 3, 9)
    bank = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)
    select = rng.integers(0, 4, (3, 2)).astype(np.int32)
    got = smoother.gather_spectra(torch.from_numpy(bank),
                                  torch.from_numpy(select))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.take(bank, select, axis=0)))


@pytest.mark.parametrize("make, protocol", [
    (lambda: FMajorPartitionedConvolution(V, B, 4, device="cpu"), "spans"),
    (lambda: FMajorPartitionedConvolution(V, B, 4, mac_strategy="selected",
                                          device="cpu"), "selected"),
    (lambda: CascadeConvolution(V, B, 40, ratio=2, max_predelay=128,
                                num_irs=2, device="cpu"), "spans"),
    (lambda: PartitionedConvolution(V, B, 4, device="cpu"), "coef"),
    (lambda: PartitionedConvolution(V, B, 4, variant="materialized",
                                    device="cpu"), "slew"),
    (lambda: MonolithicConvolution(V, FFT, B, device="cpu"), "slew"),
], ids=["fmajor-allk", "fmajor-selected", "cascade", "partitioned-coef",
        "partitioned-materialized", "monolithic"])
def test_fade_protocol_picks_the_session_steps(make, protocol):
    eng = make()
    assert eng.fade_protocol == protocol
    steady, general = engine_steps(eng)
    if protocol == "slew":
        assert steady == general == eng.step
    else:
        assert (steady, general) == (eng.step_coef_steady, eng.step_coef)


# -- the engines through tests/test_engine.py's crossfade scenario -------------------


def _engine(kind, jax_side, irs, max_predelay=128):
    """(engine, device bank) of `kind` at the test geometry."""
    bank = _bank(jax_side, irs)
    if kind == "monolithic":
        reserve = FFT - bank.max_length
        spectra = bank.monolithic_spectra(FFT, reserve=reserve)
        eng = (JaxMonolithic(V, FFT, B, max_predelay, backend="fft")
               if jax_side else
               MonolithicConvolution(V, FFT, B, max_predelay, device="cpu"))
    else:
        spectra = bank.partitioned_spectra(B)
        p = bank.max_partitions(B)
        eng = (JaxPartitioned(V, B, p, max_predelay, backend="fft",
                              variant=kind)
               if jax_side else
               PartitionedConvolution(V, B, p, max_predelay, variant=kind,
                                      device="cpu"))
    return eng, (jnp.asarray(spectra) if jax_side
                 else torch.from_numpy(spectra))


def _host_state(state):
    return {f.name: np.asarray(getattr(state, f.name)) for f in fields(state)}


@functools.lru_cache(maxsize=None)
def _scenario(kind, jax_side, n_blocks=140):
    """Re-select at 50 (voice 0 both channels to IR 2, voice 1 channel 0 to
    IR 1; the coef variant collapses), a wet change at 60, from the zero
    state. Returns (output [V, 2, T], state entering block 55 (mid-fade),
    final state), all numpy."""
    eng, bank = _engine(kind, jax_side, _irs())
    cp = (JaxControlPlane(V, 3, max_predelay=128) if jax_side
          else ControlPlane(V, 3, max_predelay=128, device="cpu"))
    cp.speed[:] = 8
    cp.wet[:] = 0.6
    cp.dry[:] = 0.2
    cp.predelay[:] = 32
    cp.pan_wet[:] = [[0.3, -0.5], [0.0, 0.25]]
    x = (np.random.default_rng(7).standard_normal((V, 2, B * n_blocks))
         * 0.05).astype(np.float32)
    state, outs, mid = eng.init_state(), [], None
    step = jax.jit(eng.step) if jax_side else eng.step
    for t in range(n_blocks):
        if t == 50:
            old = cp.select.copy()
            cp.set_select(0, 0, 2)
            cp.set_select(0, 1, 2)
            cp.set_select(1, 0, 1)
            if kind == "coef":
                arr = jnp.asarray if jax_side else torch.tensor
                state = eng.collapse(state, bank, arr(old),
                                     arr(cp.select != old))
        if t == 55:
            mid = _host_state(state)
        if t == 60:
            cp.wet[:] = 0.9
        xb = x[..., t * B: (t + 1) * B]
        if jax_side:
            params = jax.tree.map(jnp.asarray, cp.snapshot())
            state, out = step(state, bank, params, jnp.asarray(xb))
        else:
            state, out = step(state, bank, cp.snapshot_device(),
                              torch.tensor(xb))
        cp.end_block()
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=-1), mid, _host_state(state)


@pytest.mark.parametrize("kind", KINDS)
def test_crossfade_scenario_matches_jax(kind):
    """Outputs at every block and every state field, mid-fade and at the
    end, placeholders included (the same shapes field for field)."""
    got, got_mid, got_end = _scenario(kind, False)
    want, want_mid, want_end = _scenario(kind, True)
    assert np.abs(want).max() > 1e-2
    assert _scaled_err(got, want) <= 2e-5
    for got_s, want_s in ((got_mid, want_mid), (got_end, want_end)):
        assert got_s.keys() == want_s.keys()
        for name in want_s:
            assert got_s[name].dtype == want_s[name].dtype, name
            if np.abs(want_s[name]).max() == 0:
                np.testing.assert_array_equal(got_s[name], want_s[name], name)
            else:
                assert _scaled_err(got_s[name], want_s[name]) <= 2e-5, name


def test_engines_agree_as_the_jax_engines_do():
    """The partitioned variants agree at every block, fades included; the
    monolithic engine agrees with them once the fade-in from zero has
    settled and before the re-select, and again after the fades converge."""
    coef, _, _ = _scenario("coef", False)
    mat, _, _ = _scenario("materialized", False)
    mono, _, _ = _scenario("monolithic", False)
    assert _scaled_err(coef, mat) <= 2e-5
    pre, tail = slice(45 * B, 50 * B), slice(-4 * B, None)
    np.testing.assert_allclose(mat[..., pre], mono[..., pre], atol=2e-3)
    np.testing.assert_allclose(mat[..., tail], mono[..., tail], atol=2e-3)
    assert np.abs(mono[..., 50 * B: 70 * B]
                  - mat[..., 50 * B: 70 * B]).max() > 1e-5  # differ mid-fade


def test_steady_step_equals_full_step_when_converged():
    eng, bank = _engine("coef", False, _irs(2, 128, seed=13))
    cp = ControlPlane(V, 2, max_predelay=128, device="cpu")
    params = cp.snapshot_device()
    x = torch.tensor((np.random.default_rng(1).standard_normal((V, 2, B))
                      * 0.1).astype(np.float32))
    state = eng.init_converged(bank, params)        # coef_a == 0 exactly
    _, full = eng.step_coef(state, bank, params, x)
    _, steady = eng.step_coef_steady(state, bank, params, x)
    torch.testing.assert_close(steady, full, rtol=0, atol=0)


@pytest.mark.parametrize("variant", ["materialized", "coef"])
def test_partitioned_golden_beyond_one_partition(variant):
    """tests/test_engine.py's offline composition at constant parameters:
    a 500-sample IR (not a multiple of the block) against fftconvolve."""
    from scipy.signal import fftconvolve

    irs = _irs(2, 500, seed=3)
    eng, bank = _engine(variant, False, irs, max_predelay=256)
    cp = ControlPlane(V, 2, max_predelay=256, device="cpu")
    cp.select[:] = 1
    cp.predelay[:] = 100
    cp.dry[:] = 0.25
    cp.wet[:] = 0.7
    cp.level[:] = 0.8
    params = cp.snapshot_device()
    state = eng.init_converged(bank, params)
    x = (np.random.default_rng(5).standard_normal((V, 2, B * 16))
         * 0.05).astype(np.float32)
    outs = []
    for t in range(16):
        state, out = eng.step(state, bank, params,
                              torch.tensor(x[..., t * B: (t + 1) * B]))
        outs.append(out.numpy())
    got = np.concatenate(outs, axis=-1)
    t_len = x.shape[-1]
    for v in range(V):
        want = np.zeros((2, t_len))
        for o in range(2):
            acc = np.zeros(t_len)
            for i in range(2):
                acc[100:] += fftconvolve(x[v, i], irs[1][o])[: t_len - 100]
            want[o] = (np.clip(acc * 0.7 * 0.8, -1, 1)
                       + (x[v, 0] + x[v, 1]) * 0.25 * 0.8)
        np.testing.assert_allclose(got[v], want, atol=2e-4)


# -- models: default engine, capacity, session, checkpoint ---------------------------


def _model(kind, jax_side, irs=None, **kwargs):
    bank = _bank(jax_side, irs or _irs())
    engine = "monolithic" if kind == "monolithic" else "partitioned"
    variant = "coef" if kind == "monolithic" else kind
    common = dict(num_voices=V, block=B, engine=engine, variant=variant,
                  fft_size=FFT, max_predelay=128, **kwargs)
    model = (JaxReverb(bank, backend="fft", **common) if jax_side
             else ConvolutionReverb(bank, device="cpu", **common))
    cp = model.control
    cp.wet[:] = 0.7
    cp.dry[:] = 0.2
    cp.speed[:] = 12
    cp.predelay[:] = 40
    cp.pan_wet[:] = [[0.25, -0.5]] * V
    mapping = JaxCCMapping if jax_side else CCMapping
    for v in range(V):
        for ch in range(2):
            cp.set_mapping(v, ch, mapping(message=0xB0, select=SELECT_CC,
                                          wet=WET_CC))
    return model


def test_from_settings_builds_the_jax_default_engine(tmp_path):
    """The same settings file builds the same engine class in both packages
    when no engine is named (the JAX default: partitioned, coef)."""
    idx = tmp_path / "bank.index"
    paths = []
    for k, ir in enumerate(_irs(2, 200)):
        write_wav(tmp_path / f"ir{k}.wav", ir.T, 44100)
        paths.append(str(tmp_path / f"ir{k}.wav"))
    write_index(idx, paths)
    settings = tmp_path / "settings.txt"
    settings.write_text(f"conv.count 2\nconv[0].index {idx}\n"
                        f"conv[1].index {idx}\nconv[0].fftSize 1024\n"
                        f"conv[1].fftSize 1024\n")
    jm = JaxReverb.from_settings(str(settings), block=B, backend="fft",
                                 verbose=False)
    tm = ConvolutionReverb.from_settings(str(settings), block=B,
                                         device="cpu", verbose=False)
    assert type(tm.engine).__name__ == type(jm.engine).__name__
    assert tm.engine.variant == jm.engine.variant == "coef"
    mono = ConvolutionReverb.from_settings(str(settings), engine="monolithic",
                                           block=B, device="cpu",
                                           verbose=False)
    assert mono.engine.fft_size == 1024        # fftSize passes through


@pytest.mark.parametrize("engine", ["partitioned", "monolithic"])
def test_bank_capacity_with_these_engines_raises(engine):
    irs = _irs(3, 200)
    with pytest.raises(ValueError, match="bank_capacity"):
        JaxReverb(_bank(True, irs), block=B, engine=engine, fft_size=FFT,
                  bank_capacity=2)
    with pytest.raises(ValueError, match="bank_capacity"):
        ConvolutionReverb(_bank(False, irs), block=B, engine=engine,
                          fft_size=FFT, bank_capacity=2, device="cpu")


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


N, SWAP = 40, 20   # blocks per session; the swap is asked for at block 20
# a re-select at 4, an interrupt at 7, a wet change at 9 and a re-select
# one block after the swap: fades in flight when the bank changes
EVENTS = [(4, "", bytes([0xB0, SELECT_CC, 64])),
          (7, "", bytes([0xB0, SELECT_CC, 127])),
          (9, "", bytes([0xB0, WET_CC, 90])),
          (SWAP + 1, "", bytes([0xB0, SELECT_CC, 0]))]


def _swapped_spectra(kind, jax_side):
    """The same IRs reordered and halved, as the model's bank type."""
    bank = _bank(jax_side, [0.5 * ir for ir in _irs()[::-1]])
    if kind == "monolithic":
        spectra = bank.monolithic_spectra(FFT, reserve=max(B, FFT // 8))
    else:
        spectra = bank.partitioned_spectra(B)
    return jnp.asarray(spectra) if jax_side else torch.from_numpy(spectra)


def _session_run(kind, jax_side, x):
    """N blocks through the model's session: the EVENTS timeline, and a
    swap_bank between two runs at block SWAP, mid-fade."""
    model = _model(kind, jax_side)
    src_cls, midi_cls = ((JaxWavSource, JaxMidiSchedule) if jax_side
                         else (WavSource, MidiSchedule))
    sink = _KeepSink()
    session = model.session(src_cls(x, V, B), sink, warmup=0)
    midi = midi_cls(list(EVENTS))
    state = session.run(model.init_state(), max_blocks=SWAP, midi=midi)
    swapped = _swapped_spectra(kind, jax_side)
    session.swap_bank(swapped)
    state = session.run(state, midi=midi, start_block=SWAP)
    if not jax_side:
        assert session.bank is swapped
    return sink.data, session, state


@pytest.mark.parametrize("kind", KINDS)
def test_session_with_reselects_and_a_swap_matches_jax(kind):
    x = (np.random.default_rng(2).standard_normal((V, 2, N * B))
         * 0.05).astype(np.float32)
    got, tsess, tstate = _session_run(kind, False, x)
    want, jsess, jstate = _session_run(kind, True, x)
    assert tsess.blocks_streamed == jsess.blocks_streamed == N
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_array_equal(tsess.control.select, jsess.control.select)
    for f in fields(tstate):
        want_f = np.asarray(getattr(jstate, f.name))
        if np.abs(want_f).max() > 0:
            assert _scaled_err(getattr(tstate, f.name).numpy(),
                               want_f) <= 2e-5, f.name
    # the coef variant switches steps on the host mirror: general fade
    # blocks, then the steady step
    if kind == "coef":
        assert 0 < tsess.general_blocks < N
    else:
        assert tsess.general_blocks == 0


@pytest.mark.parametrize("kind", KINDS)
def test_resume_from_a_checkpoint_is_bit_exact(tmp_path, kind):
    """A checkpoint at block 10 (mid-fade), loaded into a fresh model, and
    the resumed blocks equal the uninterrupted run's to the bit; the
    complex fields come back as complex64."""
    n, c = 19, 10
    x = (np.random.default_rng(4).standard_normal((V, 2, n * B))
         * 0.05).astype(np.float32)
    path = tmp_path / "ckpt"
    model = _model(kind, False)
    sink = _KeepSink()
    session = model.session(WavSource(x, V, B), sink, warmup=0)
    session.run(model.init_state(), midi=MidiSchedule(list(EVENTS[:3])),
                checkpoint_path=path, checkpoint_every=c)
    assert [s["block_index"] for s in session.checkpoint_saves] == [c]

    fresh = _model(kind, False)
    state, meta = load_checkpoint(path, fresh.engine.init_state(),
                                  fresh.control)
    assert meta == {"block_index": c}
    assert (fresh.control.vsteps > 0).any(), "the save must land mid-fade"
    complex_fields = [f.name for f in fields(state)
                      if getattr(state, f.name).dtype == torch.complex64]
    assert complex_fields
    source = WavSource(x, V, B)
    source.seek(c)
    midi = MidiSchedule(list(EVENTS[:3]))
    midi.rewind_to(c)
    resumed = _KeepSink()
    fresh.session(source, resumed, warmup=0).run(state, midi=midi,
                                                 start_block=c)
    np.testing.assert_array_equal(resumed.data, sink.data[..., c * B:])


# -- the offline bounce ----------------------------------------------------------------


def _program(t_samples, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t_samples)) * 0.1).astype(np.float32)


def _stream_converged(model, x, out_samples):
    """Block-stream the port model's engine at converged params (zero
    blocks past the input flush the tail)."""
    eng, bank = model.engine, model.spectra
    params = model.control.snapshot_device()
    state = eng.init_converged(bank, params)
    blocks = -(-out_samples // B)
    xb = np.zeros((V, 2, blocks * B), np.float32)
    xb[..., : x.shape[-1]] = x[None]
    outs = []
    for t in range(blocks):
        state, y = eng.step(state, bank, params,
                            torch.tensor(xb[..., t * B: (t + 1) * B]))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1)[..., :out_samples]


@pytest.mark.parametrize("kind", KINDS)
def test_static_bounce_matches_jax_and_the_stream(kind):
    x = _program(23 * B + 7)                   # non-block-aligned length
    model = _model(kind, False)
    out = offline.render_offline(model, x, segments=3)
    want = jax_offline.render_offline(_model(kind, True), x, segments=3)
    assert out.shape == want.shape
    assert out.shape[-1] == x.shape[1] + model.engine.history_blocks * B
    np.testing.assert_allclose(out, want, atol=3e-5)
    np.testing.assert_allclose(out, _stream_converged(model, x, out.shape[-1]),
                               atol=3e-5)


def test_chunked_bounce_and_the_refused_automation():
    x = _program(31 * B + 3)
    model = _model("coef", False)
    whole = offline.render_offline(model, x, segments=2)
    chunked = offline.render_offline(model, x, segments=2,
                                     track_chunk_blocks=12)
    np.testing.assert_allclose(chunked, whole, atol=3e-5)
    np.testing.assert_allclose(
        chunked, jax_offline.render_offline(_model("coef", True), x,
                                            segments=2, track_chunk_blocks=12),
        atol=3e-5)
    for kind in KINDS:
        with pytest.raises(ValueError, match="coef-fade engine"):
            jax_offline.render_offline(_model(kind, True), x, segments=2,
                                       schedule=JaxMidiSchedule(list(EVENTS)))
        with pytest.raises(ValueError, match="coef-fade engine"):
            offline.render_offline(_model(kind, False), x, segments=2,
                                   schedule=MidiSchedule(list(EVENTS)))


# -- the CLI -------------------------------------------------------------------------

SETTINGS = """
conv.count 2
conv[0].fftSize 1024
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].cc.wet 24
conv[0].value.select 1
conv[0].value.predelay 40
conv[0].value.dry 0.3
conv[0].value.wet 0.7
conv[0].value.speed 12
conv[0].value.panWet 0.25
conv[1].fftSize 1024
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.message 176
conv[1].cc.select 21
conv[1].cc.wet 24
conv[1].value.select 0
conv[1].value.predelay 40
conv[1].value.dry 0.3
conv[1].value.wet 0.7
conv[1].value.speed 12
conv[1].value.panWet -0.5
"""
MIDI = "4 B0 15 40\n7 B0 15 7F\n9 B0 18 50\n"


@pytest.fixture
def cli_env(tmp_path):
    paths = []
    for k, ir in enumerate(_irs(3, 300, seed=5)):
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, (0.6 * ir).T, 44100)
        paths.append(str(p))
    write_index(tmp_path / "bank.index", paths)
    (tmp_path / "settings.txt").write_text(
        SETTINGS.format(index=tmp_path / "bank.index"))
    (tmp_path / "events.txt").write_text(MIDI)
    x = np.random.default_rng(0).uniform(-0.2, 0.2, (B * 60, 2))
    write_wav(tmp_path / "in.wav", x.astype(np.float32), 44100, scale="full")
    return tmp_path


def pcm16(path):
    """Raw int16 samples of a 16-bit PCM WAV written by either package."""
    blob = open(path, "rb").read()
    return np.frombuffer(blob[blob.index(b"data") + 8:], dtype="<i2")


def cli_pair(base, args, name):
    """Run the JAX CLI and the port's on the same arguments; returns their
    16-bit samples."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio_torch.app.main import main as port_main

    assert jax_main(args + ["--output", str(base / f"jax_{name}.wav")]) == 0
    assert port_main(args + ["--output", str(base / f"port_{name}.wav"),
                             "--device", "cpu"]) == 0
    return pcm16(base / f"jax_{name}.wav"), pcm16(base / f"port_{name}.wav")


@pytest.mark.parametrize("extra", [
    ["--engine", "partitioned", "--variant", "materialized"],
    ["--engine", "partitioned", "--offline", "2"]])
def test_cli_partitioned_matches_the_jax_cli(cli_env, extra):
    base = cli_env
    args = ["--settings", str(base / "settings.txt"), "--input",
            str(base / "in.wav"), "--block-size", "64", "--quiet", *extra]
    if "--offline" not in extra:
        args += ["--midi", str(base / "events.txt")]
    want, got = cli_pair(base, args, extra[-1])
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
