"""Chunked dispatch in the port (StreamSession(chunk_blocks=N) over
engine/fmajor.py:make_chunk_step) against the JAX package's chunked
session, and against the port's own per-block session, on the CPU.

Both packages get the same IR banks, input blocks and MIDI timeline (the
JAX models built with backend="fft", and fmajor and the cascade with
bank_prep="device", so both sides run an FFT on their device). Port against JAX: within 2e-5 of the output's
scale in f32 (both f32, different summation orders), 2e-3 in bf16 (the
bf16 session tolerance of tests/test_torch_bf16.py: both packages round f32
values that differ in their last bits to bf16). Port chunked against port
per-block with every event on a chunk boundary: equal to the bit, the same
steps on the same inputs. The cases after the parity table mirror the JAX
package's chunk tests (tests/test_runtime.py).
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_audio.runtime.checkpoint as jax_ckpt
import tpu_audio_torch.runtime.stream as port_stream
from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution as JaxFMajor
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.checkpoint import load_checkpoint as jax_load
from tpu_audio.runtime.checkpoint import save_checkpoint as jax_save
from tpu_audio.runtime.recovery import run_resilient as jax_run_resilient
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.runtime.stream import StreamSession as JaxSession
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine.fmajor import (
    FMajorPartitionedConvolution, make_chunk_step,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from tpu_audio_torch.runtime.recovery import run_resilient
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

torch.set_num_threads(1)

REL, BF16_REL = 2e-5, 2e-3
SELECT_CC, WET_CC = 0x15, 0x18
CHUNK, BLOCKS = 4, 30      # 30 = 7 chunks of 4 + a partial chunk of 2
# a re-select at 8, an interrupt at 12 and a wet change at 20, all on the
# chunk grid; speed 10: the fade's countdown does not divide by the chunk
EVENTS = [(8, SELECT_CC, 64), (12, SELECT_CC, 127), (20, WET_CC, 40)]
# geometry per kind: (voices, block, IRs, IR length)
GEOMETRY = {"fmajor": (2, 64, 3, 600), "cascade": (4, 32, 2, 1200)}
KINDS = ["ring", "ring_bf16", "roll", "roll_bf16", "cascade",
         "cascade_selected", "partitioned"]


def _irs(num_irs, ir_len, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _bank(cls, irs):
    bank = cls()
    for ir in irs:
        bank.append(ir)
    return bank


def _configure(cp, mapping):
    cp.wet[:] = 0.8
    cp.dry[:] = 0.2
    cp.speed[:] = 10
    cp.predelay[:] = 40
    for v in range(cp.num_voices):
        for ch in range(2):
            cp.set_mapping(v, ch, mapping(message=0xB0, select=SELECT_CC,
                                          wet=WET_CC))


class _Roll:
    """Roll mode in either package (no model builds it): the engine, its
    bank and a control plane, driven as tests/test_torch_checkpoint.py
    drives its roll engine."""

    working_set = None

    def __init__(self, jax_side, mac_dtype):
        v, b, k, n = GEOMETRY["fmajor"]
        irs = _irs(k, n)
        kwargs = dict(max_predelay=64, ring=False, mac_strategy="allk",
                      num_irs=k, mac_dtype=mac_dtype)
        if jax_side:
            bank = _bank(JaxIRBank, irs)
            self.engine = JaxFMajor(v, b, bank.max_partitions(b),
                                    backend="fft", **kwargs)
            self.control = JaxControlPlane(v, k, 64)
            self.device = None
        else:
            bank = _bank(IRBank, irs)
            self.engine = FMajorPartitionedConvolution(
                v, b, bank.max_partitions(b), device="cpu", **kwargs)
            self.control = ControlPlane(v, k, 64, device="cpu")
            self.device = torch.device("cpu")
        self.jax_side = jax_side
        self.spectra = self.engine.prepare_bank(bank.partitioned_spectra(b))

    def init_state(self):
        params = (jax.tree.map(jnp.asarray, self.control.snapshot())
                  if self.jax_side else self.control.snapshot_device())
        return self.engine.init_converged(self.spectra, params)

    def session(self, source, sink, **kwargs):
        cls = JaxSession if self.jax_side else StreamSession
        return cls(self.engine, self.spectra, self.control, source, sink,
                   **kwargs)


def _model(kind, jax_side=False):
    mac_dtype = "bf16" if kind.endswith("bf16") else "f32"
    if kind.startswith("roll"):
        model = _Roll(jax_side, mac_dtype)
        _configure(model.control, JaxCCMapping if jax_side else CCMapping)
        return model
    geometry = "cascade" if kind.startswith("cascade") else "fmajor"
    v, b, k, n = GEOMETRY[geometry]
    bank = _bank(JaxIRBank if jax_side else IRBank, _irs(k, n))
    kwargs = {"num_voices": v, "block": b, "max_predelay": 64,
              "mac_dtype": mac_dtype}
    if kind.startswith("cascade"):
        kwargs.update(engine="cascade", cascade_ratio=4)
        if kind == "cascade_selected":
            kwargs["mac_strategy"] = "selected"
    if kind == "partitioned":
        kwargs.update(engine="partitioned", variant="coef")
        del kwargs["mac_dtype"]
    if jax_side:
        if kind != "partitioned":   # (its spectra are host-prepped in both)
            kwargs["bank_prep"] = "device"
        model = JaxReverb(bank, backend="fft", **kwargs)
    else:
        model = ConvolutionReverb(bank, device="cpu", **kwargs)
    _configure(model.control, JaxCCMapping if jax_side else CCMapping)
    return model


def _input(voices, block, blocks=BLOCKS, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((voices, 2, blocks * block)) * 0.05
            ).astype(np.float32)


def _events(jax_side, events=EVENTS):
    cls = JaxMidiSchedule if jax_side else MidiSchedule
    return cls([(blk, "", bytes([0xB0, cc, val])) for blk, cc, val in events])


def _stream(model, x, chunk, jax_side=False, **run_kwargs):
    """Stream x through a session of `model` in chunks of `chunk`;
    returns (sink data, session, final state)."""
    v, b = model.engine.num_voices, model.engine.block
    if jax_side:
        source, sink = JaxWavSource(x, v, b), JaxWavSink("/dev/null",
                                                        keep_data=True)
    else:
        source, sink = WavSource(x, v, b), WavSink("/dev/null",
                                                   keep_data=True)
    kwargs = {"donate": False} if jax_side else {}
    session = model.session(source, sink, warmup=0, chunk_blocks=chunk,
                            **kwargs)
    state = session.run(model.init_state(), midi=_events(jax_side),
                        **run_kwargs)
    return sink.data, session, state


def _assert_close(got, want, rel):
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{err:.3e} > {rel * scale:.3e}"


# -- the engines in chunks: the port against JAX and against itself --------------------


@pytest.mark.parametrize("kind", KINDS)
def test_chunked_session_matches_jax_and_the_per_block_session(kind):
    model = _model(kind)
    v, b = model.engine.num_voices, model.engine.block
    x = _input(v, b)
    chunked, session, _ = _stream(model, x, CHUNK)
    per_block, session1, _ = _stream(_model(kind), x, 1)
    want, _, _ = _stream(_model(kind, jax_side=True), x, CHUNK,
                         jax_side=True)
    assert chunked.shape == per_block.shape == (v, 2, BLOCKS * b)
    np.testing.assert_array_equal(chunked, per_block)
    _assert_close(chunked, want, BF16_REL if kind.endswith("bf16") else REL)
    assert session.blocks_streamed == BLOCKS
    # blocks, not chunks: every block from the re-select on rides a fade
    # step (the fades outlast the run), in chunks as per block
    counts = (session.indexed_blocks, session.general_blocks)
    assert counts == (session1.indexed_blocks, session1.general_blocks)
    assert sum(counts) == BLOCKS - EVENTS[0][0]


def test_chunk_step_counts_vsteps_down_on_the_device():
    """make_chunk_step: block i steps with vsteps = max(vsteps - i, 0), and
    the chunk equals the per-block steps with the host's countdown."""
    model = _model("ring")
    engine, cp = model.engine, model.control
    v, b = engine.num_voices, engine.block
    cp.vsteps[:] = 3
    params = cp.snapshot_device()
    xs = torch.tensor(_input(v, b, blocks=6).reshape(v, 2, 6, b)
                      .transpose(2, 0, 1, 3).copy())
    seen = []
    step = engine.step_coef

    def spy(state, bank, p, x):
        seen.append(p.vsteps.clone())
        return step(state, bank, p, x)

    engine.step_coef = spy
    chunk_step = make_chunk_step(engine)
    state, outs = chunk_step(engine.init_converged(model.spectra, params),
                             model.spectra, params, xs, 5)
    assert [int(s.max()) for s in seen] == [3, 2, 1, 0, 0]
    engine.step_coef = step
    state = engine.init_converged(model.spectra, params)
    for i in range(5):
        state, out = engine.step_coef(state, model.spectra,
                                      cp.snapshot_device(), xs[i])
        np.testing.assert_array_equal(outs[i].numpy(), out.numpy())
        cp.end_block()


@pytest.mark.parametrize("engine", ["monolithic", "materialized"])
def test_slew_engines_refuse_chunks(engine):
    bank = _bank(IRBank, _irs(2, 300))
    kwargs = ({"engine": "monolithic", "fft_size": 1024}
              if engine == "monolithic"
              else {"engine": "partitioned", "variant": "materialized"})
    model = ConvolutionReverb(bank, block=64, max_predelay=64, device="cpu",
                              **kwargs)
    source = WavSource(_input(1, 64, blocks=4), 1, 64)
    with pytest.raises(ValueError, match="chunk_blocks"):
        model.session(source, WavSink("/dev/null"), chunk_blocks=8)
    with pytest.raises(ValueError, match="slew"):
        make_chunk_step(model.engine)
    model.session(source, WavSink("/dev/null"), chunk_blocks=1)


# -- the JAX package's chunk tests (tests/test_runtime.py), on both packages -------------


def _small_model(jax_side, num_voices=1, num_irs=2, ir_len=128,
                 engine="partitioned", seed=0):
    """tests/test_runtime.py:small_model in either package."""
    rng = np.random.default_rng(seed)
    bank = JaxIRBank() if jax_side else IRBank()
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        bank.append(ir * (0.5 / np.abs(ir).max()))
    kwargs = dict(num_voices=num_voices, block=64, engine=engine,
                  variant="coef", fft_size=1024, max_predelay=128)
    if jax_side:
        return JaxReverb(bank, backend="fft", **kwargs)
    return ConvolutionReverb(bank, device="cpu", **kwargs)


def _sink(jax_side):
    return (JaxWavSink if jax_side else WavSink)("/dev/null", keep_data=True)


def _source(jax_side, x, v=1):
    return (JaxWavSource if jax_side else WavSource)(x, v, 64)


@pytest.mark.parametrize("chunk", [4, 8])
def test_chunked_session_matches_blockwise(chunk):
    """test_runtime.py:262-297: a partial tail (26 blocks) and a select at
    block 8, chunked against per-block, the crossfade countdown included."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((1, 2, 64 * 26)) * 0.05).astype(np.float32)
    runs = {}
    for jax_side in (True, False):
        for c in (1, chunk):
            m = _small_model(jax_side, num_irs=2, ir_len=128)
            mapping = JaxCCMapping if jax_side else CCMapping
            for ch in range(2):
                m.control.set_mapping(0, ch, mapping(message=0xB0,
                                                     select=SELECT_CC))
            m.control.dry[:] = 0.2
            m.control.wet[:] = 0.9
            m.control.speed[:] = 7
            sink = _sink(jax_side)
            m.process(_source(jax_side, x), sink,
                      midi=_events(jax_side, [(8, SELECT_CC, 64)]),
                      warmup=0, chunk_blocks=c)
            runs[jax_side, c] = (sink.data, int(m.control.vsteps[0, 0]))
    (got, vsteps), (per_block, vsteps1) = runs[False, chunk], runs[False, 1]
    assert got.shape == per_block.shape == (1, 2, 64 * 26)
    np.testing.assert_array_equal(got, per_block)
    assert vsteps == vsteps1 == runs[True, chunk][1]
    _assert_close(got, runs[True, chunk][0], REL)


def test_chunked_checkpoint_interval_alignment(tmp_path):
    """test_runtime.py:525-548: checkpoints fire on crossing when the chunk
    does not divide checkpoint_every — chunks end at 3, 6, 9, 12, so the
    multiples 4, 8, 12 save at 6, 9, 12 in both packages."""
    x = np.zeros((1, 2, 64 * 12), np.float32)
    for jax_side, module in ((True, jax_ckpt), (False, port_stream)):
        model = _small_model(jax_side, engine="fmajor", ir_len=96)
        saves = []
        orig = module.save_checkpoint

        def spy(path, state, control, meta=None, orig=orig, saves=saves):
            saves.append(meta["block_index"])
            return orig(path, state, control, meta=meta)

        session = model.session(_source(jax_side, x), _sink(jax_side),
                                warmup=0, chunk_blocks=3)
        with mock.patch.object(module, "save_checkpoint", spy):
            session.run(model.init_state(), checkpoint_path=tmp_path
                        / f"c{int(jax_side)}.npz", checkpoint_every=4)
        assert saves == [6, 9, 12], (jax_side, saves)
    assert [s["block_index"] for s in session.checkpoint_saves] == [6, 9, 12]


def test_stale_pure_checkpoint_resume_paths_agree(tmp_path):
    """test_runtime.py:671-720: a span-collapsed mid-fade checkpoint (its
    base tensor stale by design) resumed chunked (the indexed chunk step),
    per block, and with the indexed step disabled (the snapshot is then
    materialized at run start and the fade rides the general step). All
    resumes agree, and agree with the JAX package's."""
    rng = np.random.default_rng(51)
    x = (rng.standard_normal((1, 2, 64 * 20)) * 0.05).astype(np.float32)
    got = {}
    for jax_side in (True, False):
        mapping = JaxCCMapping if jax_side else CCMapping

        def build():
            m = _small_model(jax_side, engine="fmajor", ir_len=128)
            for ch in range(2):
                m.control.set_mapping(0, ch, mapping(message=0xB0,
                                                     select=SELECT_CC))
            m.control.wet[:] = 0.9
            m.control.speed[:] = 30  # long fade: in flight at the save
            return m

        kwargs = {"donate": False} if jax_side else {}
        m1 = build()
        sess1 = m1.session(_source(jax_side, x[..., : 64 * 6]),
                           _sink(jax_side), warmup=0, **kwargs)
        state = sess1.run(m1.init_state(),
                          midi=_events(jax_side, [(2, SELECT_CC, 64)]))
        assert getattr(sess1, "indexed_blocks", 0) >= 1
        assert bool(np.asarray(state.base_pure).all())
        assert (np.asarray(state.coef_a) > 1e-3).all(), "fade in flight"
        path = tmp_path / f"pure{int(jax_side)}.ckpt"
        (jax_save if jax_side else save_checkpoint)(path, state, m1.control)

        def resume(chunk, force_general=False):
            m = build()
            st, _ = (jax_load if jax_side else load_checkpoint)(
                path, m.engine.init_state(), m.control)
            sink = _sink(jax_side)
            sess = m.session(_source(jax_side, x[..., 64 * 6:]), sink,
                             warmup=0, chunk_blocks=chunk, **kwargs)
            if force_general:
                sess._step_indexed = None
            sess.run(st)
            return sink.data

        got[jax_side] = (resume(2), resume(1), resume(1, force_general=True))
    chunked, plain, general = got[False]
    np.testing.assert_array_equal(chunked, plain)
    # materialized against virtual snapshots: the bf16 snapshot's scale
    np.testing.assert_allclose(general, plain, atol=4e-3)
    for mine, theirs in zip(got[False], got[True]):
        _assert_close(mine, theirs, REL)


class _KeepSink:
    """Keeps every block across runs (a session closes its sink at the end
    of each run); with `crash_at`, raises once when that many blocks have
    been delivered."""

    def __init__(self, crash_at=None):
        self.blocks, self.crash_at = [], crash_at

    def write(self, block):
        if len(self.blocks) == self.crash_at:
            self.crash_at = None
            raise RuntimeError("boom")
        self.blocks.append(np.array(block))

    def close(self):
        pass

    @property
    def data(self):
        return np.concatenate(self.blocks, axis=-1)


def test_resilient_chunked_session_replays_chunk_local_midi(tmp_path):
    """test_runtime.py:722-768: with checkpoint_every=4 and chunk 2, a wet
    event at block 3 is applied at the chunk start 4, after the checkpoint
    at block 4 was saved; after a crash it must replay there. The recovered
    stream equals the uncrashed chunked run (the port's to the bit) in both
    packages."""
    rng = np.random.default_rng(73)
    x = (rng.standard_normal((1, 2, 64 * 16)) * 0.05).astype(np.float32)
    events = [(3, WET_CC, 16)]
    out = {}
    for jax_side in (True, False):
        mapping = JaxCCMapping if jax_side else CCMapping

        def build():
            m = _small_model(jax_side, engine="fmajor", ir_len=96)
            for ch in range(2):
                m.control.set_mapping(0, ch, mapping(message=0xB0,
                                                     wet=WET_CC))
            m.control.wet[:] = 0.9
            return m

        m0 = build()
        s0 = _sink(jax_side)
        m0.process(_source(jax_side, x), s0, warmup=0,
                   midi=_events(jax_side, events), chunk_blocks=2)
        sink = _KeepSink(crash_at=5)
        _, summary = (jax_run_resilient if jax_side else run_resilient)(
            build, _source(jax_side, x), sink,
            tmp_path / f"ck{int(jax_side)}.ckpt", checkpoint_every=4,
            midi=_events(jax_side, events),
            session_kwargs=dict(warmup=0, chunk_blocks=2))
        assert summary["restarts"] == 1
        out[jax_side] = (sink.data, s0.data)
    got, uncrashed = out[False]
    np.testing.assert_array_equal(got, uncrashed)
    _assert_close(got, out[True][0], REL)
    # the wet event took effect: without its replay the tail would differ
    assert not np.array_equal(uncrashed[..., 64 * 4:],
                              _no_event_run(x)[..., 64 * 4:])


def _no_event_run(x):
    m = _small_model(False, engine="fmajor", ir_len=96)
    for ch in range(2):
        m.control.set_mapping(0, ch, CCMapping(message=0xB0, wet=WET_CC))
    m.control.wet[:] = 0.9
    sink = _sink(False)
    m.process(_source(False, x), sink, warmup=0, chunk_blocks=2)
    return sink.data


def test_chunked_session_respects_max_blocks():
    """test_runtime.py:849-861: a chunked session never renders or
    delivers past max_blocks; the port's state stops there too."""
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((1, 2, 64 * 20)) * 0.05).astype(np.float32)
    data = {}
    for jax_side in (True, False):
        m = _small_model(jax_side, num_irs=2, ir_len=128)
        m.control.dry[:] = 0.2
        m.control.wet[:] = 0.8
        sink = _sink(jax_side)
        m.process(_source(jax_side, x), sink, warmup=0, chunk_blocks=4,
                  max_blocks=6)
        assert sink.data.shape[-1] == 6 * 64
        data[jax_side] = sink.data
    _assert_close(data[False], data[True], REL)
    # the port's partial chunk rendered blocks 4 and 5 only: continuing
    # the stream per block equals one 8-block per-block run
    m = _small_model(False, num_irs=2, ir_len=128)
    m.control.dry[:], m.control.wet[:] = 0.2, 0.8
    sink = _KeepSink()
    session = m.session(_source(False, x), sink, warmup=0, chunk_blocks=4)
    state = session.run(m.init_state(), max_blocks=6)
    session.run(state, max_blocks=2)
    whole = _sink(False)
    m2 = _small_model(False, num_irs=2, ir_len=128)
    m2.control.dry[:], m2.control.wet[:] = 0.2, 0.8
    m2.process(_source(False, x), whole, warmup=0, max_blocks=8)
    np.testing.assert_array_equal(sink.data, whole.data)
