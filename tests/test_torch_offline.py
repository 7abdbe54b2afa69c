"""The port's offline bounce (tpu_audio_torch/runtime/offline.py) against the
JAX renderer and against the port's own stream of the same model.

The same numpy inputs go through tpu_audio.runtime.offline.render_offline
and the port's, on the CPU (the port's CPU model runs the plain kernel
versions). Models are tests/test_offline.py's: 2 voices, 32-frame blocks,
3 IRs of 300 samples; the JAX model is built with backend="fft", so both
sides run an FFT. Tolerances: static bounces 3e-5 (f32 MACs summed in
another order, at other ring phases than the stream's), automated bounces
5e-5, a bounce without its tail against the same bounce's head 1e-6, the
engine hooks 1e-6, the control-plane replay bit for bit, the pcm16 wire
half an LSB, CLI WAVs 1 LSB against the JAX CLI (which runs its matmul DFT)
and 4 LSB against the port's streamed WAV; the one-pass input layout bit for
bit against the three-pass chain it replaced.
"""

import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.fmajor import FMajorPartitionedConvolution as JaxFMajor
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.engine.params import ControlPlane as JaxControlPlane
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime import offline as jax_offline
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import CCMapping, ControlPlane
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime import offline
from tpu_audio_torch.runtime.backends import WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession
from tpu_audio_torch.utils.profiling import Spans

torch.set_num_threads(1)

CASCADE = {"engine": "cascade", "block": 16, "ir_len": 400,
           "cascade_ratio": 2}

AUTOMATION = [
    (8, "", bytes([0xB0, 0x15, 0x40])),   # select IR 1 (crossfade)
    (30, "", bytes([0xB0, 0x16, 0x46])),  # wet change mid-fade
    (41, "", bytes([0xB0, 0x15, 0x7F])),  # re-select IR 2 (interrupts)
    (55, "", bytes([0xB0, 0x17, 0x40])),  # predelay jump
    (70, "", bytes([0xB0, 0x18, 0x0A])),  # crossfade speed change
    (85, "", bytes([0xB0, 0x15, 0x20])),  # select IR 0; fade rings into tail
]


def _irs(num_irs=3, ir_len=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _configure(cp, num_voices, num_irs):
    cp.wet[:] = 0.8
    cp.dry[:] = 0.3
    cp.level[:] = 0.9
    cp.predelay[:] = [[17, 40]] * num_voices
    cp.pan_wet[:] = [[0.3, -0.4]] * num_voices
    cp.pan_dry[:] = [[-0.2, 0.1]] * num_voices
    for v in range(num_voices):
        cp.select[v] = [v % num_irs, (v + 1) % num_irs]


def build_model(side, engine="fmajor", num_voices=2, block=32, ir_len=300,
                num_irs=3, automate=False, **kwargs):
    """tests/test_offline.py's model on either package; `automate` maps
    every CC the AUTOMATION timeline sends and slows the fades to 20."""
    jax_side = side == "jax"
    bank = JaxIRBank() if jax_side else IRBank()
    for ir in _irs(num_irs, ir_len):
        bank.append(ir)
    if jax_side:
        model = JaxReverb(bank, num_voices=num_voices, block=block,
                          engine=engine, max_predelay=64, backend="fft",
                          **kwargs)
    else:
        model = ConvolutionReverb(bank, num_voices=num_voices, block=block,
                                  engine=engine, max_predelay=64,
                                  device="cpu", **kwargs)
    _configure(model.control, num_voices, num_irs)
    if automate:
        model.control.speed[:] = 20
        _map_all(model.control, JaxCCMapping if jax_side else CCMapping)
    return model


def _map_all(control, mapping=CCMapping):
    for v in range(control.num_voices):
        for ch in range(2):
            control.set_mapping(v, ch, mapping(
                message=0xB0, select=0x15, wet=0x16, predelay=0x17,
                speed=0x18, dry=0x19, pan_wet=0x1A, level=0x1B))


def roll_model(side, num_voices=2, block=32):
    """A roll-mode (ring=False) fmajor engine, which no model builds, as
    the (engine, spectra, control) triple render_offline reads."""
    rng = np.random.default_rng(3)
    spectra = (np.fft.rfft(rng.standard_normal((3, 2, 10, 2 * block)),
                           axis=-1) * 0.1).astype(np.complex64)
    if side == "jax":
        eng = JaxFMajor(num_voices, block, 10, max_predelay=64, ring=False,
                        num_irs=3, backend="fft")
        cp = JaxControlPlane(num_voices, 3, 64)
    else:
        eng = FMajorPartitionedConvolution(num_voices, block, 10,
                                           max_predelay=64, ring=False,
                                           num_irs=3, device="cpu")
        cp = ControlPlane(num_voices, 3, 64, device="cpu")
    _configure(cp, num_voices, 3)
    return types.SimpleNamespace(engine=eng, spectra=eng.prepare_bank(spectra),
                                 control=cp)


def program(t_samples, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, t_samples)) * 0.1).astype(np.float32)


def port_stream(model, x, out_samples):
    """Block-stream the port model's engine at converged params (zero
    blocks past the input flush the tail); `x` shared or per-voice."""
    eng, bank = model.engine, model.spectra
    b, v = eng.block, eng.num_voices
    params = model.control.snapshot_device()
    state = eng.init_converged(bank, params)
    blocks = -(-out_samples // b)
    xv = np.broadcast_to(x[None], (v,) + x.shape) if x.ndim == 2 else x
    xb = np.zeros((v, 2, blocks * b), np.float32)
    xb[..., : xv.shape[-1]] = xv
    outs = []
    for t in range(blocks):
        state, y = eng.step_coef_steady(
            state, bank, params, torch.tensor(xb[..., t * b: (t + 1) * b]))
        outs.append(y.numpy())
    return np.concatenate(outs, axis=-1)[..., :out_samples]


class _KeepSink:
    def __init__(self):
        self.blocks = []

    def write(self, block):
        self.blocks.append(np.array(block))

    def close(self):
        pass


def port_stream_automated(model, x, total_blocks, schedule):
    """The port's StreamSession (collapse_pure, indexed and steady steps,
    the per-block countdown) driven by the same MIDI schedule."""
    b = model.engine.block
    xpad = np.zeros(x.shape[:-1] + (total_blocks * b,), np.float32)
    xpad[..., : x.shape[-1]] = x
    sink = _KeepSink()
    sess = StreamSession(model.engine, model.spectra, model.control,
                         WavSource(xpad, model.engine.num_voices, b), sink,
                         warmup=0)
    sess.run(model.init_state(), midi=schedule)
    return np.concatenate(sink.blocks, axis=-1)


def _close(got, want, atol):
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=atol)


# -- static bounces ------------------------------------------------------------------


@pytest.mark.parametrize("kwargs", [{}, {"mac_strategy": "selected"},
                                    CASCADE])
def test_static_bounce_matches_jax_and_the_stream(kwargs):
    b = kwargs.get("block", 32)
    x = program(41 * b + 7)                   # non-block-aligned length
    model = build_model("port", **kwargs)
    out = offline.render_offline(model, x, segments=4)
    want = jax_offline.render_offline(build_model("jax", **kwargs), x,
                                      segments=4)
    _close(out, want, 3e-5)
    _close(out, port_stream(model, x, out.shape[-1]), 3e-5)
    assert out.shape[-1] == x.shape[1] + model.engine.history_blocks * b


def test_per_voice_mono_auto_and_no_tail():
    rng = np.random.default_rng(7)
    xv = (rng.standard_normal((2, 2, 44 * 32)) * 0.1).astype(np.float32)
    model = build_model("port")
    out = offline.render_offline(model, xv, segments=3)
    _close(out, jax_offline.render_offline(build_model("jax"), xv,
                                           segments=3), 3e-5)
    _close(out, port_stream(model, xv, out.shape[-1]), 3e-5)
    assert np.abs(out[0] - out[1]).max() > 1e-3   # per-voice material

    mono = program(30 * 32)[0]
    solo = build_model("port", num_voices=1)
    out = offline.render_offline(solo, mono)       # auto segment count
    _close(out, jax_offline.render_offline(build_model("jax", num_voices=1),
                                           mono), 3e-5)
    _close(out, port_stream(solo, np.stack([mono, mono]), out.shape[-1]),
           3e-5)

    x = program(10 * 32 + 5)
    head = offline.render_offline(solo, x, segments=2, include_tail=False)
    assert head.shape == (1, 2, x.shape[1])
    full = offline.render_offline(solo, x, segments=2)
    assert full.shape[-1] > x.shape[1]
    _close(head, full[..., :x.shape[1]], 1e-6)


def test_roll_mode_bounce():
    x = program(37 * 32 + 3)
    model = roll_model("port")
    out = offline.render_offline(model, x, segments=3)
    _close(out, jax_offline.render_offline(roll_model("jax"), x, segments=3),
           3e-5)
    _close(out, port_stream(model, x, out.shape[-1]), 3e-5)


def test_chunked_equals_whole():
    x = program(53 * 32 + 11)
    model = build_model("port", num_voices=1)
    whole = offline.render_offline(model, x, segments=3)
    chunked = offline.render_offline(model, x, segments=3,
                                     track_chunk_blocks=17)
    _close(chunked, whole, 3e-5)
    _close(chunked, jax_offline.render_offline(
        build_model("jax", num_voices=1), x, segments=3,
        track_chunk_blocks=17), 3e-5)
    no_tail = offline.render_offline(model, x, segments=3,
                                     track_chunk_blocks=17,
                                     include_tail=False)
    assert no_tail.shape[-1] == x.shape[1]
    rng = np.random.default_rng(3)
    xv = (rng.standard_normal((2, 2, 40 * 32)) * 0.1).astype(np.float32)
    _close(offline.render_offline(build_model("port"), xv, segments=2,
                                  track_chunk_blocks=13),
           offline.render_offline(build_model("port"), xv, segments=2), 3e-5)
    with pytest.raises(ValueError, match=">= 1"):
        offline.render_offline(model, x, track_chunk_blocks=0)


def test_pcm16_wire_and_bucketing():
    model = build_model("port")
    x = program(37 * 32 + 5)
    ref = offline.render_offline(model, x, segments=4)
    out16 = offline.render_offline(model, x, segments=4, wire="pcm16")
    assert out16.dtype == np.float32 and out16.shape == ref.shape
    np.testing.assert_allclose(out16, np.clip(ref, -1.0, 1.0),
                               atol=0.51 / 32767)
    np.testing.assert_array_equal(
        out16 * np.float32(32767.0), np.round(out16 * np.float32(32767.0)))
    _close(offline.render_offline(model, x, segments=4, bucket_blocks=64),
           ref, 3e-5)
    _close(offline.render_offline(model, x, segments=4, bucket_blocks="auto"),
           ref, 3e-5)
    with pytest.raises(ValueError, match="wire"):
        offline.render_offline(model, x, wire="pcm24")
    with pytest.raises(ValueError, match="bucket_blocks"):
        offline.render_offline(model, x, bucket_blocks=0)


def test_input_wire():
    """tests/test_offline.py:265-310 on the port: bit-exact when the input
    sits on a 16-bit grid, half-LSB quantization otherwise; composes with
    automation and chunking. The explicit pcm16 upload is held against the
    JAX renderer's."""
    model = build_model("port")
    rng = np.random.default_rng(33)
    k = rng.integers(-32768, 32768, (2, 31 * 32 + 7)).astype(np.float32)
    xg = k / np.float32(65536.0)
    assert offline._detect_input_grid(xg) == ("pcm16", 65536.0)
    ref = offline.render_offline(model, xg, segments=3)
    np.testing.assert_allclose(
        offline.render_offline(model, xg, segments=3, input_wire="auto"),
        ref, atol=1e-7)
    np.testing.assert_allclose(
        offline.render_offline(model, xg, segments=3, input_wire="pcm16",
                               input_scale=65536.0), ref, atol=1e-7)
    xf = (rng.standard_normal((2, 31 * 32)) * 0.1).astype(np.float32)
    ref = offline.render_offline(model, xf, segments=3)
    np.testing.assert_allclose(
        offline.render_offline(model, xf, segments=3, input_wire="auto"),
        ref, atol=1e-7)
    q = offline.render_offline(model, xf, segments=3, input_wire="pcm16")
    np.testing.assert_allclose(q, ref, atol=5e-3)
    assert np.abs(q - ref).max() > 0
    _close(q, jax_offline.render_offline(build_model("jax"), xf, segments=3,
                                         input_wire="pcm16"), 3e-5)
    a_ref = offline.render_offline(
        build_model("port", automate=True), xg, segments=3,
        schedule=MidiSchedule(list(AUTOMATION)))
    np.testing.assert_allclose(
        offline.render_offline(build_model("port", automate=True), xg,
                               segments=3, input_wire="auto",
                               schedule=MidiSchedule(list(AUTOMATION))),
        a_ref, atol=1e-7)
    np.testing.assert_allclose(
        offline.render_offline(model, xg, segments=3, track_chunk_blocks=11,
                               input_wire="auto"),
        offline.render_offline(model, xg, segments=3, track_chunk_blocks=11),
        atol=1e-7)
    with pytest.raises(ValueError, match="input_wire"):
        offline.render_offline(model, xg, input_wire="pcm24")


# -- automation ----------------------------------------------------------------------


@pytest.mark.parametrize("kwargs,segments", [
    ({}, 5),                              # boundaries straddle fades
    ({}, 1),                              # pure sequential replay
    ({"mac_strategy": "selected"}, 5),
    (CASCADE, 5),
])
def test_automated_bounce_matches_jax_and_the_stream(kwargs, segments):
    b = kwargs.get("block", 32)
    x = program(115 * b + 9)
    model = build_model("port", automate=True, **kwargs)
    out = offline.render_offline(model, x, segments=segments,
                                 schedule=MidiSchedule(list(AUTOMATION)))
    want = jax_offline.render_offline(
        build_model("jax", automate=True, **kwargs), x, segments=segments,
        schedule=JaxMidiSchedule(list(AUTOMATION)))
    _close(out, want, 5e-5)
    total = -(-x.shape[1] // b) + model.engine.history_blocks
    ref = port_stream_automated(build_model("port", automate=True, **kwargs),
                                x, total, MidiSchedule(list(AUTOMATION)))
    n = min(out.shape[-1], ref.shape[-1])
    _close(out[..., :n], ref[..., :n], 5e-5)


@pytest.mark.parametrize("kwargs", [{}, CASCADE])
def test_chunked_automated_bounce(kwargs):
    """Chunk boundaries land mid-fade; the cascade's odd chunk size rounds
    up to the stagger ratio."""
    b = kwargs.get("block", 32)
    x = program(115 * b + 9)
    whole = offline.render_offline(
        build_model("port", automate=True, **kwargs), x, segments=4,
        schedule=MidiSchedule(list(AUTOMATION)))
    chunked = offline.render_offline(
        build_model("port", automate=True, **kwargs), x, segments=4,
        track_chunk_blocks=23, schedule=MidiSchedule(list(AUTOMATION)))
    _close(chunked, whole, 5e-5)
    _close(chunked, jax_offline.render_offline(
        build_model("jax", automate=True, **kwargs), x, segments=4,
        track_chunk_blocks=23, schedule=JaxMidiSchedule(list(AUTOMATION))),
        5e-5)


@pytest.mark.parametrize("chunk", [None, 23])
@pytest.mark.parametrize("kwargs", [{}, CASCADE])
def test_an_empty_schedule_bounces_as_the_static_bounce(kwargs, chunk):
    """An automated bounce without events (the fade tables and the indexed
    step) equals the static one (the steady step), whole and chunked, on
    fmajor (the same plan and rows) and the cascade (the static bounce's
    voice-major rows and unrounded plan, in f32)."""
    b = kwargs.get("block", 32)
    x = program(97 * b + 9)
    opts = {"segments": 4, "track_chunk_blocks": chunk}
    static = offline.render_offline(build_model("port", **kwargs), x, **opts)
    automated = offline.render_offline(build_model("port", **kwargs), x,
                                       schedule=MidiSchedule([]), **opts)
    _close(automated, static, 3e-5)


def test_control_replay_tables_equal_jax_to_the_bit():
    """_ControlSim's regimes, events and fade snapshots over AUTOMATION and
    a dense random CC stream, against the JAX replay."""
    rng = np.random.default_rng(11)
    events, t = list(AUTOMATION), 0
    while t < 140:
        events.append((t, "", bytes([0xB0, int(rng.choice(
            [0x15, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x1B])),
            int(rng.integers(0, 128))])))
        t += int(rng.integers(1, 9))
    snaps = [0, 7, 8, 40, 41, 99, 150]
    jsim = jax_offline._ControlSim(
        build_model("jax", automate=True).control,
        JaxMidiSchedule(list(events)), 160, snaps)
    tsim = offline._ControlSim(build_model("port", automate=True).control,
                               MidiSchedule(list(events)), 160, snaps)
    assert len(tsim.regimes) == len(jsim.regimes) > 10
    for got, want in zip(tsim.regimes, jsim.regimes):
        for name in offline._ControlSim.FIELDS:
            np.testing.assert_array_equal(got[name], want[name], name)
            assert got[name].dtype == want[name].dtype, name
    assert tsim.regime_starts == jsim.regime_starts
    for name in ("regime_of_block", "event_of_block"):
        np.testing.assert_array_equal(getattr(tsim, name),
                                      getattr(jsim, name), name)
    np.testing.assert_array_equal(np.stack(tsim.ev_changed),
                                  np.stack(jsim.ev_changed))
    np.testing.assert_array_equal(np.stack(tsim.ev_old),
                                  np.stack(jsim.ev_old))
    assert sorted(tsim.snaps) == sorted(jsim.snaps) == snaps
    for blk in snaps:
        for got, want in zip(tsim.snaps[blk], jsim.snaps[blk]):
            np.testing.assert_array_equal(got, want, f"snapshot {blk}")


# -- the engine hooks ----------------------------------------------------------------


@pytest.mark.parametrize("ring", [True, False])
def test_engine_hooks_match_jax(ring):
    v, b, parts = 3, 32, 10
    jeng = JaxFMajor(v, b, parts, max_predelay=64, ring=ring, num_irs=2,
                     backend="fft")
    teng = FMajorPartitionedConvolution(v, b, parts, max_predelay=64,
                                        ring=ring, num_irs=2, device="cpu")
    assert (teng.history_blocks, teng.prime_blocks) == (
        jeng.history_blocks, jeng.prime_blocks)
    clone = teng.with_voices(7, swap_snapshot=False)
    assert (clone.num_voices, clone.ring_mode, clone.swap_snapshot,
            clone.device) == (7, ring, False, teng.device)
    rng = np.random.default_rng(5)
    shared = (rng.standard_normal((20, 2, b)) * 0.1).astype(np.float32)
    per_voice = (rng.standard_normal((20, 2, 2, b)) * 0.1).astype(np.float32)
    t0 = np.array([-3, 4, 19], np.int32)       # before the track, mid, end
    voice_of = np.array([1, 0, 1], np.int32)
    for xb, vof in ((shared, None), (per_voice, voice_of)):
        jspec = np.asarray(jeng.input_spectra_bulk(xb))
        tspec = teng.input_spectra_bulk(torch.tensor(xb))
        np.testing.assert_allclose(tspec.numpy(), jspec, atol=1e-6)
        jst = jeng.prime_fdl(jeng.init_state(), jnp.asarray(jspec),
                             jnp.asarray(t0),
                             voice_of=None if vof is None else jnp.asarray(vof))
        tst = teng.prime_fdl(
            teng.init_state(), tspec, torch.tensor(t0),
            voice_of=None if vof is None else torch.tensor(vof))
        assert np.abs(np.asarray(jst.fdl)).max() > 0.1
        np.testing.assert_allclose(tst.fdl.numpy(), np.asarray(jst.fdl),
                                   atol=1e-6)
        # the gather alone, on the JAX spectra: equal to the bit
        tst = teng.prime_fdl(
            teng.init_state(), torch.tensor(jspec), torch.tensor(t0),
            voice_of=None if vof is None else torch.tensor(vof))
        np.testing.assert_array_equal(tst.fdl.numpy(), np.asarray(jst.fdl))


# -- guards --------------------------------------------------------------------------


def test_guards():
    ws = build_model("port", num_irs=6, bank_capacity=3)
    with pytest.raises(ValueError, match="working-set"):
        offline.render_offline(ws, program(64), segments=2)
    ws.working_set.close()
    model = build_model("port", num_voices=1)
    with pytest.raises(ValueError, match="segments"):
        offline.render_offline(model, program(64), segments=0)
    with pytest.raises(ValueError, match="stereo"):
        offline.render_offline(model, np.zeros((3, 64), np.float32))
    with pytest.raises(ValueError, match="per-voice"):
        offline.render_offline(model, np.zeros((3, 2, 64), np.float32))
    # the mesh bounce shards the virtual-voice axis only
    from tpu_audio_torch.parallel import make_mesh
    with pytest.raises(ValueError, match="part=1"):
        offline.render_offline(model, program(64),
                               mesh=make_mesh(devices=["cpu"] * 2, part=2))
    sched = MidiSchedule([(2, "", bytes([0xB0, 0x15, 0x40]))])
    moving = build_model("port", automate=True)
    moving.control.vsteps[:] = 7
    with pytest.raises(ValueError, match="converged"):
        offline.render_offline(moving, program(64), schedule=sched)
    late = MidiSchedule([(10 ** 6, "", bytes([0xB0, 0x15, 0x40]))])
    np.testing.assert_allclose(
        offline.render_offline(build_model("port", num_voices=1,
                                           automate=True),
                               program(20 * 32), segments=2, schedule=late),
        offline.render_offline(model, program(20 * 32), segments=2),
        atol=1e-6)


def test_nonfinite_output_raises_on_every_wire():
    model = build_model("port", num_voices=1)
    x = program(10 * 32)
    x[0, 40] = np.nan
    for wire in ("f32", "pcm16"):
        with pytest.raises(RuntimeError, match="non-finite"):
            offline.render_offline(model, x, segments=2, wire=wire)
    out = offline.render_offline(model, program(10 * 32), segments=2,
                                 wire="pcm16")
    assert np.isfinite(out).all()


# -- stage spans and counters --------------------------------------------------------

STAGES = ("input", "upload", "prime", "layout", "loop", "drain", "output")
PATHS = {
    "static": ({}, {"segments": 4}),
    "automated": ({"automate": True}, {"segments": 5}),
    "chunked": ({}, {"segments": 3, "track_chunk_blocks": 23}),
    "chunked_automated": ({"automate": True},
                          {"segments": 3, "track_chunk_blocks": 40}),
}


def _bounce_kwargs(path):
    build, kwargs = PATHS[path]
    if build.get("automate"):
        kwargs = dict(kwargs, schedule=MidiSchedule(list(AUTOMATION)))
    return build, kwargs


@pytest.mark.parametrize("path", sorted(PATHS))
def test_spans_leave_the_output_bit_identical(path):
    """spans=None and spans=Spans() give the same bits on every path, and
    the spans hold one `bounce` with its stages below it."""
    build, _ = _bounce_kwargs(path)
    x = program(97 * 32 + 3)
    plain = offline.render_offline(build_model("port", **build), x,
                                   **_bounce_kwargs(path)[1])
    spans = Spans()
    traced = offline.render_offline(build_model("port", **build), x,
                                    spans=spans, **_bounce_kwargs(path)[1])
    np.testing.assert_array_equal(traced, plain)
    recs = spans.records()
    assert [r.name for r in recs].count("bounce") == 1
    names = {r.name for r in recs[1:]}
    assert names == {f"bounce.{s}" for s in STAGES} | (
        {"bounce.schedule"} if build.get("automate") else set())
    assert all(r.parent == 0 and r.end_ns is not None for r in recs[1:])


@pytest.mark.parametrize("path,step_chunks", [
    pytest.param("static", False, id="static"),
    pytest.param("chunked", False, id="chunked"),
    pytest.param("static", True, id="static-step-chunks")])
def test_the_stages_tile_the_bounce(monkeypatch, path, step_chunks):
    """The children of `bounce` follow one another without overlap and
    cover all but 2 % of it (what is left: the span calls themselves).
    In step chunks `bounce.loop` and `bounce.drain` repeat per chunk and
    `bounce.output` closes the bounce once."""
    build, kwargs = _bounce_kwargs(path)
    if step_chunks:
        # 3 kept steps' rows a chunk: 8 virtual voices, f32 blocks of 32
        monkeypatch.setattr(offline, "_STAGING_BYTES", 3 * 8 * 2 * 32 * 4)
    spans, counters = Spans(), {}
    offline.render_offline(build_model("port", **build), program(120 * 32),
                           spans=spans, counters=counters, **kwargs)
    top, *kids = spans.records()
    assert top.name == "bounce" and top.parent is None
    assert kids[0].start_ns >= top.start_ns
    assert kids[-1].end_ns <= top.end_ns
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    covered = sum(k.end_ns - k.start_ns for k in kids)
    assert covered >= 0.98 * (top.end_ns - top.start_ns)
    order = [k.name.split(".", 1)[1] for k in kids]
    chunks = order.count("loop")
    if step_chunks:
        assert chunks == counters["output_chunks"] > 1
        assert order == (list(STAGES[:4]) + ["loop", "drain"] * chunks
                         + ["output"])
        return
    assert order == list(STAGES) * chunks
    assert chunks == (1 if path == "static" else 7)


def test_counters_of_a_small_bounce(monkeypatch):
    """Segments, virtual voices and steps as the plan sets them; the bytes
    of the block tensor up and of the output buffer down; no graph on the
    CPU; one step chunk, none overlapped. In step chunks the totals hold,
    and every kept step but the last chunk's overlaps the loop."""
    model = build_model("port")
    eng = model.engine
    x = program(50 * 32)
    model.render_offline(x, segments=4)
    c = model.offline_counters()
    total = 50 + eng.history_blocks
    seg_len = -(-total // 4)
    assert c == {"segments": 4, "virtual_voices": 8,
                 "steps": eng.prime_blocks + seg_len,
                 "warmup_steps": eng.prime_blocks, "input_wire": "f32",
                 "input_buffer_reused": 0,
                 "upload_bytes": 4 * seg_len * 2 * 32 * 4,
                 "fetch_bytes": seg_len * 8 * 2 * 32 * 4,
                 "output_chunks": 1, "output_overlap_steps": 0,
                 "steady_captures": 0, "steady_replays": 0,
                 "steady_eager": seg_len + eng.prime_blocks}
    whole = c
    for per_chunk in (3, 1):
        monkeypatch.setattr(offline, "_STAGING_BYTES",
                            per_chunk * 8 * 2 * 32 * 4 + 7)
        model.render_offline(x, segments=4)
        c = model.offline_counters()
        chunks = -(-seg_len // per_chunk)
        assert c == dict(whole, output_chunks=chunks,
                         output_overlap_steps=per_chunk * (chunks - 1),
                         input_buffer_reused=1)
    monkeypatch.undo()
    model.render_offline(x, segments=4, wire="pcm16",
                         track_chunk_blocks=40)
    c = model.offline_counters()
    chunks = -(-total // 40)
    chunk_len = -(-(40 + eng.history_blocks) // 4)
    assert c["steps"] == chunks * (eng.prime_blocks + chunk_len)
    assert c["warmup_steps"] == chunks * eng.prime_blocks
    assert c["fetch_bytes"] == chunks * chunk_len * 8 * 2 * 32 * 2
    assert c["steady_captures"] == 0
    assert c["output_chunks"] == chunks and c["output_overlap_steps"] == 0


def test_counters_read_the_input_wire():
    """A per-voice stem on the k/65536 grid goes up as int16 under
    input_wire='auto' (2 bytes a sample), float noise as f32."""
    model = build_model("port")
    rng = np.random.default_rng(5)
    k = rng.integers(-600, 600, (2, 2, 40 * 32))
    model.render_offline((k / 65536.0).astype(np.float32), segments=2,
                         input_wire="auto")
    c = model.offline_counters()
    seg_len = -(-(40 + model.engine.history_blocks) // 2)
    assert c["input_wire"] == "pcm16"
    assert c["upload_bytes"] == 2 * seg_len * 2 * 2 * 32 * 2
    model.render_offline(
        (rng.standard_normal((2, 2, 40 * 32)) * 0.01).astype(np.float32),
        segments=2, input_wire="auto")
    c = model.offline_counters()
    assert c["input_wire"] == "f32"
    assert c["upload_bytes"] == 2 * seg_len * 2 * 2 * 32 * 4


# -- step chunks: the output written while the loop runs -----------------------------


def _ref_output(rows, v, keep, wire, voice_major):
    """The output stage before step chunks: one _collect's whole
    [seg_len, nseg*V, 2, B] rows transposed into track order, trimmed and
    decoded (astype, then an in-place divide)."""
    seg_len, vv, _, b = rows.shape
    order, perm = (((v, vv // v), (1, 3, 2, 0, 4)) if voice_major
                   else ((vv // v, v), (2, 3, 1, 0, 4)))
    out = (rows.reshape((seg_len,) + order + (2, b)).transpose(perm)
           .reshape(v, 2, -1))[..., :keep]
    if wire != "pcm16":
        return out
    out = out.astype(np.float32)
    out /= np.float32(32767.0)
    return out


def _record_spans(monkeypatch):
    """Record every _render_span call of a bounce: its `keep`, wire and row
    order, the rows each of its _collect calls returned, and its result."""
    calls = []
    render_span, collect = offline._render_span, offline._collect

    def span(model, x, plan, keep, **kwargs):
        ratio, align = offline._stagger(model.engine,
                                        kwargs["schedule"] is None)
        call = {"keep": keep, "wire": kwargs["wire"], "rows": [],
                "voice_major": align < ratio, "v": model.engine.num_voices}
        calls.append(call)
        call["out"] = render_span(model, x, plan, keep, **kwargs)
        return call["out"]

    def rows(*args, **kwargs):
        got = collect(*args, **kwargs)
        calls[-1]["rows"].append(got.copy())
        return got

    monkeypatch.setattr(offline, "_render_span", span)
    monkeypatch.setattr(offline, "_collect", rows)
    return calls


def _same_bits(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


STEP_CHUNK_CASES = {
    # name: (model kwargs, render kwargs, per-voice input, kept steps a chunk)
    "f32": ({}, {"segments": 4}, False, 5),
    "pcm16_one_step": ({}, {"segments": 4, "wire": "pcm16"}, False, 1),
    "per_voice_pcm16": ({}, {"segments": 3, "wire": "pcm16"}, True, 4),
    "no_tail": ({}, {"segments": 4, "include_tail": False}, False, 3),
    "cascade_voice_major": (CASCADE, {"segments": 4}, False, 5),
    "cascade_per_voice_pcm16": (CASCADE, {"segments": 3, "wire": "pcm16"},
                                True, 2),
    "automated_pcm16": ({"automate": True},
                        {"segments": 5, "wire": "pcm16"}, False, 4),
    "automated_cascade": (dict(CASCADE, automate=True), {"segments": 4},
                          False, 3),
    "track_chunks": ({}, {"segments": 3, "track_chunk_blocks": 23}, True,
                     2),
    "mesh": ({}, {"segments": 3, "wire": "pcm16"}, True, 3),
}


@pytest.mark.parametrize("case", sorted(STEP_CHUNK_CASES))
def test_step_chunks_change_no_bit(monkeypatch, case):
    """A bounce collected in step chunks (the staging budget cut to a few
    kept steps' rows) equals the one-chunk bounce bit for bit, and every
    _render_span's result equals the output stage before step chunks
    (_ref_output) applied to its chunks' rows joined: f32 and pcm16
    wires, segment-major and voice-major rows (a static cascade bounce),
    shared and per-voice input, a track ending mid-segment and mid-block,
    automated, track-chunked and meshed bounces. The counters are the
    one-chunk bounce's but for the two of the output chunks."""
    build, kwargs, per_voice, per_chunk = STEP_CHUNK_CASES[case]
    b = build.get("block", 32)
    t = 97 * b + 11
    x = (program(t) if not per_voice else
         (np.random.default_rng(8).standard_normal((2, 2, t)) * 0.1
          ).astype(np.float32))
    if build.get("automate"):
        kwargs = dict(kwargs, schedule=MidiSchedule(list(AUTOMATION)))
    if case == "mesh":
        from tpu_audio_torch.parallel import make_mesh
        kwargs = dict(kwargs, mesh=make_mesh(devices=["cpu"] * 2))

    def bounce():
        model = build_model("port", **build)
        if kwargs.get("schedule") is not None:
            kwargs["schedule"].rewind_to(0)
        return model.render_offline(x, **kwargs), model.offline_counters()

    one, c_one = bounce()
    kept = c_one["steps"] - c_one["warmup_steps"]
    monkeypatch.setattr(offline, "_STAGING_BYTES",
                        per_chunk * c_one["fetch_bytes"] // kept)
    calls = _record_spans(monkeypatch)
    many, c_many = bounce()
    _same_bits(many, one)
    assert c_many["output_chunks"] > 2 * c_one["output_chunks"]
    assert 0 < c_many["output_overlap_steps"] < kept
    assert {k: n for k, n in c_many.items() if not k.startswith("output")} \
        == {k: n for k, n in c_one.items() if not k.startswith("output")}
    assert len(calls) == c_one["output_chunks"]
    assert sum(len(call["rows"]) for call in calls) == c_many["output_chunks"]
    for call in calls:
        assert [len(r) for r in call["rows"][:-1]] == [per_chunk] * (
            len(call["rows"]) - 1)
        assert 0 < len(call["rows"][-1]) <= per_chunk
        _same_bits(call["out"], _ref_output(
            np.concatenate(call["rows"]), call["v"], call["keep"],
            call["wire"], call["voice_major"]))


@pytest.mark.parametrize("wire", ["f32", "pcm16"])
def test_a_nonfinite_middle_step_chunk_raises_and_stops_the_worker(
        monkeypatch, wire):
    """NaN input in the middle of the track: the first step chunk that
    holds non-finite output raises, and the output worker is shut down."""
    model = build_model("port", num_voices=1)
    x = program(40 * 32)
    x[0, 12 * 32 + 5] = np.nan
    # 2 kept steps' rows a chunk: 2 virtual voices, blocks of 32
    monkeypatch.setattr(offline, "_STAGING_BYTES", 2 * 2 * 2 * 32 * 4)
    calls = _record_spans(monkeypatch)
    with pytest.raises(RuntimeError, match="non-finite"):
        offline.render_offline(model, x, segments=2, wire=wire)
    seg_len = -(-(40 + model.engine.history_blocks) // 2)
    assert 1 < len(calls[0]["rows"]) < -(-seg_len // 2) - 1
    assert not [th for th in threading.enumerate()
                if th.name.startswith("bounce-output")]


# -- the one-pass input layout -------------------------------------------------------

def _ref_detect_input_grid(x):
    """The three-pass chain the one pass replaced, kept as its reference:
    the grid scan, ..."""
    for scale in (65536.0, 32768.0, 32767.0):
        xs = x * np.float32(scale)
        if (xs.min() >= -32768.0 and xs.max() <= 32767.0
                and not np.any(xs != np.round(xs))):
            return "pcm16", scale
    return "f32", None


def _ref_quantize_input(x, input_wire, scale):
    """... the quantization ..."""
    if input_wire != "pcm16":
        return x
    return np.clip(np.round(x * np.float32(scale)), -32768, 32767).astype(
        np.int16)


def _ref_block_tensor(x, per_voice, t_pad_blocks, b, t_samples):
    """... and the pad and transpose."""
    if per_voice:
        v = x.shape[0]
        flat = np.zeros((v, 2, t_pad_blocks * b), x.dtype)
        flat[..., :t_samples] = x
        return np.ascontiguousarray(
            flat.reshape(v, 2, t_pad_blocks, b).transpose(2, 0, 1, 3))
    flat = np.zeros((2, t_pad_blocks * b), x.dtype)
    flat[:, :t_samples] = x
    return np.ascontiguousarray(
        flat.reshape(2, t_pad_blocks, b).transpose(1, 0, 2))


def _grid_input(shape, scale, seed=40, k=32768):
    """Samples k / scale, k drawn from [-k, k)."""
    k = np.random.default_rng(seed).integers(-k, k, shape)
    return (k / np.float32(scale)).astype(np.float32)


def _with(x, value, at=-3):
    x = x.copy()
    x.reshape(-1)[at] = value
    return x


# name: (input, input_wire, input_scale); T = 2187 blocks of 32 + 16 (more
# than one piece a row, T not a multiple of the block) unless stated
_T = 70000
LAYOUT_CASES = {
    "grid65536": (_grid_input((2, _T), 65536.0), "auto", None),
    "grid32768": (_grid_input((2, _T), 32768.0), "auto", None),
    "grid32767": (_grid_input((2, _T), 32767.0), "auto", None),
    # in int16 on k/65536 but for 0.5, one step past it: the next grid
    "over_range": (_with(_grid_input((2, _T), 32768.0, k=16384), 0.5),
                   "auto", None),
    "under_range": (_with(_grid_input((2, _T), 65536.0),
                          np.float32(-32769 / 65536.0)), "auto", None),
    "off_grid": ((np.random.default_rng(41).standard_normal((2, _T))
                  * 0.1).astype(np.float32), "auto", None),
    "late_off_grid": (_with(_grid_input((2, _T), 65536.0),
                            np.float32(0.1), at=-1), "auto", None),
    "nan": (_with(_grid_input((2, _T), 65536.0), np.nan), "auto", None),
    "inf": (_with(_grid_input((2, _T), 65536.0), -np.inf), "auto", None),
    "mono": (_grid_input((_T,), 65536.0), "auto", None),
    "per_voice": (_grid_input((2, 2, _T), 32767.0), "auto", None),
    "per_voice_short": (_grid_input((2, 2, 31 * 32 + 7), 65536.0), "auto",
                        None),
    "whole_blocks": (_grid_input((2, 40 * 32), 65536.0), "auto", None),
    "transposed": (np.ascontiguousarray(_grid_input((_T, 2), 65536.0)).T,
                   "auto", None),
    "pcm16_clip": ((np.random.default_rng(42).standard_normal((2, 2, _T))
                    * 0.7).astype(np.float32), "pcm16", 32767.0),
    "pcm16_grid": (_grid_input((2, _T), 65536.0), "pcm16", 65536.0),
    "f32": (_grid_input((2, 2, _T), 65536.0), "f32", None),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_one_pass_layout_matches_the_three_pass_chain(case):
    """_input_blocks (the grid scan, the quantization and the block layout
    in one pass, into the engine's buffer) gives today's three-function
    chain's block tensor, bit for bit, with the same input wire and
    scale."""
    samples, wire, scale = LAYOUT_CASES[case]
    v = samples.shape[0] if samples.ndim == 3 else 2
    x, per_voice = offline._check_stereo(samples, v)
    t = x.shape[-1]
    b = 32
    t_pad = -(-t // b) + 5
    with np.errstate(invalid="ignore"):
        want_wire, want_scale = (_ref_detect_input_grid(x) if wire == "auto"
                                 else (wire, scale))
        want = _ref_block_tensor(
            _ref_quantize_input(x, want_wire, want_scale), per_voice, t_pad,
            b, t)
    eng = types.SimpleNamespace(block=b)
    lane = offline._Lane(None, None, torch.device("cpu"), 0, v)
    bounce = offline._Bounce(None)
    for _ in range(2):                        # a fresh buffer, then reused
        with np.errstate(invalid="ignore"):
            got, got_wire, got_scale = offline._input_blocks(
                eng, x, t_pad, wire, scale, [lane], bounce)
        assert (got_wire, got_scale) == (want_wire, want_scale)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8))
        assert bounce.counters["input_wire"] == want_wire
        if wire == "auto":
            assert offline._detect_input_grid(x) == (want_wire, want_scale)
        got.fill(7)                           # the next pass rewrites it all


def test_the_input_buffer_is_reused_and_counted():
    """Back-to-back bounces of different stems of one shape reuse the
    engine's host buffer, then another length allocates anew; each output
    equals a freshly built model's bit for bit, and an earlier output is
    left as it was (nothing it holds aliases the buffer). A chunked
    bounce's chunks go through the pass too."""
    def stems(seed, blocks):
        return _grid_input((2, 2, blocks * 32 + 5), 65536.0, seed, k=3000)

    model = build_model("port")
    outs, reused = [], []
    for seed, blocks in ((1, 40), (2, 40), (3, 47)):
        x = stems(seed, blocks)
        out = model.render_offline(x, segments=3, input_wire="auto")
        c = model.offline_counters()
        assert c["input_wire"] == "pcm16"
        reused.append(c["input_buffer_reused"])
        np.testing.assert_array_equal(
            out, build_model("port").render_offline(x, segments=3,
                                                    input_wire="auto"))
        outs.append((out, out.copy()))
    assert reused == [0, 1, 0]
    for out, kept in outs:
        np.testing.assert_array_equal(out, kept)
    x = stems(4, 47)
    chunked = model.render_offline(x, segments=3, track_chunk_blocks=20,
                                   input_wire="auto")
    c = model.offline_counters()
    assert c["input_wire"] == "pcm16"
    np.testing.assert_array_equal(
        chunked, build_model("port").render_offline(
            x, segments=3, track_chunk_blocks=20, input_wire="auto"))


# -- the model and the CLI -----------------------------------------------------------

SETTINGS = """
conv.count 2
conv[0].fftSize 2048
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.select 21
conv[0].cc.wet 22
conv[0].cc.speed 24
conv[0].value.select 1
conv[0].value.predelay 16
conv[0].value.dry 0.4
conv[0].value.wet 0.6
conv[0].value.level 0.9
conv[1].fftSize 2048
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.select 21
conv[1].cc.wet 22
conv[1].cc.speed 24
conv[1].value.select 0
conv[1].value.predelay 16
conv[1].value.dry 0.4
conv[1].value.wet 0.6
conv[1].value.level 0.9
"""


def _pcm16(path):
    blob = open(path, "rb").read()
    return np.frombuffer(blob[blob.index(b"data") + 8:], dtype="<i2")


def test_model_method_and_cli_match_jax_and_the_stream(tmp_path, capsys):
    """ConvolutionReverb.render_offline, then --offline 3 --device cpu:
    the WAV against the JAX CLI's within 1 LSB and against the port's
    streamed WAV within 4 LSB over the streamed length (the bounce adds
    the flushed tail)."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav
    from tpu_audio_torch.app.main import main as port_main

    model = build_model("port")
    x = program(20 * 32)
    np.testing.assert_array_equal(model.render_offline(x, segments=2),
                                  offline.render_offline(model, x, segments=2))

    rng = np.random.default_rng(0)
    paths = []
    for k in range(2):
        ir = rng.uniform(-0.3, 0.3, (150, 2)).astype(np.float32)
        write_wav(tmp_path / f"ir{k}.wav", ir, 44100)
        paths.append(str(tmp_path / f"ir{k}.wav"))
    write_index(tmp_path / "bank.index", paths)
    (tmp_path / "settings.txt").write_text(
        SETTINGS.format(index=tmp_path / "bank.index"))
    write_wav(tmp_path / "in.wav",
              rng.uniform(-0.2, 0.2, (41 * 64, 2)).astype(np.float32), 44100,
              scale="full")
    base = ["--settings", str(tmp_path / "settings.txt"), "--input",
            str(tmp_path / "in.wav"), "--block-size", "64", "--quiet"]
    assert jax_main(base + ["--output", str(tmp_path / "jax.wav"),
                            "--offline", "3"]) == 0
    capsys.readouterr()
    port = base + ["--device", "cpu"]
    assert port_main(port + ["--output", str(tmp_path / "off.wav"),
                             "--offline", "3"]) == 0
    assert "x real time" in capsys.readouterr().out
    assert port_main(port + ["--output", str(tmp_path / "stream.wav")]) == 0
    want, got = _pcm16(tmp_path / "jax.wav"), _pcm16(tmp_path / "off.wav")
    streamed = _pcm16(tmp_path / "stream.wav")
    assert got.shape == want.shape and got.size > streamed.size
    assert np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
    n = streamed.size
    assert int(np.abs(got[:n].astype(np.int32) - streamed).max()) <= 4
    assert port_main(port + ["--offline", "--realtime"]) == 2
