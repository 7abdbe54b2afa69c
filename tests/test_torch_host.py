"""The port's host layer and small device ops against the JAX package:
device selection, settings, WAV and index files, IR bank, control plane,
mixing math, transforms, timers, MIDI schedules and block backends.

Host code is numpy in both packages and must agree exactly; the mixing
math and transforms run in f32 on both sides and agree to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.engine.params import ControlPlane as JaxControlPlane
from tpu_audio.io import index as jax_index
from tpu_audio.io import settings as jax_settings
from tpu_audio.io import wav as jax_wav
from tpu_audio.ops import mix as jax_mix
from tpu_audio.ops.fft import SpectralTransform as JaxTransform
from tpu_audio.runtime import backends as jax_backends
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.utils.profiling import BlockTimer as JaxBlockTimer
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.params import CCMapping, ControlPlane, VoiceParams
from tpu_audio_torch.io import index, settings, wav
from tpu_audio_torch.ops import mix
from tpu_audio_torch.ops.fft import SpectralTransform
from tpu_audio_torch.runtime import backends
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.utils import device
from tpu_audio_torch.utils.profiling import BlockTimer

torch.set_num_threads(1)


@pytest.fixture
def tf32_on():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved[0]
    torch.backends.cudnn.allow_tf32 = saved[1]
    torch.set_float32_matmul_precision(saved[2])


def _tf32_off():
    return (not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest")


def test_select_gpu_raises_without_cuda_and_pins_f32(tf32_on, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.select_gpu(verbose=False)
    assert _tf32_off()


def test_engine_and_explicit_devices_pin_f32(tf32_on):
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    FMajorPartitionedConvolution(1, 32, 4, num_irs=1, device="cpu")
    assert _tf32_off()
    torch.backends.cuda.matmul.allow_tf32 = True
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert _tf32_off()


def _engine(**kwargs):
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    return FMajorPartitionedConvolution(1, 32, 4, num_irs=1, **kwargs)


def _control_plane(**kwargs):
    return ControlPlane(2, 3, 64, **kwargs)


@pytest.mark.parametrize("make", [_engine, _control_plane])
def test_engine_and_control_plane_default_to_the_card(make):
    """Like ConvolutionReverb and the CLI, the engine and the control plane
    run on the best CUDA device unless the caller asks for the CPU, and
    raise where no card is visible."""
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert make(device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("make", [_engine, _control_plane])
def test_engine_and_control_plane_raise_without_a_card(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(device=device)


def test_gpu_scoring_prefers_more_sms_times_clock():
    class Props:
        def __init__(self, sms, clock, cc=(9, 0)):
            self.multi_processor_count, self.clock_rate = sms, clock
            self.major, self.minor = cc

    assert (device.device_score(Props(132, 1980000))
            > device.device_score(Props(114, 1755000)))
    assert (device.device_score(Props(80, 1500000, (7, 0)))
            < device.device_score(Props(80, 1500000, (8, 6))))


SETTINGS_TEXT = """
# comment line
conv.count 4   # trailing comment
conv[0].fftSize 0x800
conv[1].maxPredelay 010
conv[0].value.wet 0.75
conv[1].cc.device hw:2,0
conv[0].flag yes
dangling
"""


def test_settings_typed_getters_match():
    a = settings.Settings().parse(SETTINGS_TEXT)
    b = jax_settings.Settings().parse(SETTINGS_TEXT)
    assert list(a.keys()) == list(b.keys())
    for getter, key, args in [("u32", "conv.count", ()),
                              ("u32", "conv[%d].fftSize", (0,)),
                              ("u8", "conv[%d].maxPredelay", (1,)),
                              ("f32", "conv[%d].value.wet", (0,)),
                              ("str", "conv[%d].cc.device", (1,)),
                              ("is_true", "conv[%d].flag", (0,))]:
        assert getattr(a, getter)(key, *args) == getattr(b, getter)(key, *args)
    assert a.u32("missing", default=7) == 7
    with pytest.raises(KeyError):
        a.u32("missing")


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_wav_roundtrip_is_bit_identical(tmp_path, bits):
    rng = np.random.default_rng(bits)
    frames = rng.uniform(-0.9, 0.9, (301, 2)).astype(np.float32)
    wav.write_wav(tmp_path / "port.wav", frames, 48000, bits=bits)
    jax_wav.write_wav(tmp_path / "jax.wav", frames, 48000, bits=bits)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "jax.wav").read_bytes())
    for scale in ("reference", "full"):
        a = wav.read_wav(tmp_path / "jax.wav", scale=scale, verbose=False)
        b = jax_wav.read_wav(tmp_path / "jax.wav", scale=scale, verbose=False)
        assert a.sample_rate == b.sample_rate == 48000
        assert a.frames.dtype == b.frames.dtype
        np.testing.assert_array_equal(a.frames, b.frames)
    assert wav.wav_sample_rate(tmp_path / "jax.wav") == 48000


def test_index_and_bank_match(tmp_path):
    rng = np.random.default_rng(2)
    paths = []
    for k, rate in enumerate((44100, 48000, 44100)):
        p = tmp_path / f"ir{k}.wav"
        jax_wav.write_wav(p, rng.uniform(-0.5, 0.5, (200 + 50 * k, 2)), rate)
        paths.append(p.name)
    jax_index.write_index(tmp_path / "bank.index", paths)
    assert (index.load_index(tmp_path / "bank.index")
            == jax_index.load_index(tmp_path / "bank.index"))
    # the 48 kHz IR is resampled to the bank's rate on load
    a = IRBank.from_index(tmp_path / "bank.index", verbose=False,
                          max_seconds=0.005)
    b = JaxIRBank.from_index(tmp_path / "bank.index", verbose=False,
                             max_seconds=0.005)
    assert len(a) == len(b) == 3 and a.max_partitions(64) == b.max_partitions(64)
    offset_a, offset_b = a.extend(a), b.extend(b)
    assert offset_a == offset_b == 3
    for mode in ("energy", "peak"):
        a.normalize(mode)
        b.normalize(mode)
        for k in range(len(a)):
            np.testing.assert_array_equal(a.ir(k), b.ir(k))
    np.testing.assert_array_equal(a.partitioned_spectra(64),
                                  b.partitioned_spectra(64))


def test_control_plane_cc_scalings_match():
    a = ControlPlane(2, 5, 8192, device="cpu")
    b = JaxControlPlane(2, 5, 8192)
    for cp, mapping in ((a, CCMapping), (b, JaxCCMapping)):
        m = mapping(device="hw:1", select=21, predelay=22, dry=23, wet=24,
                    speed=25, pan_dry=26, pan_wet=27, level=28)
        for voice in range(2):
            for ch in range(2):
                cp.set_mapping(voice, ch, m)
        cp.set_channel_banks([(0, 3), (3, 2)])
    for ctl, value in [(21, 100), (22, 64), (23, 10), (24, 127), (25, 3),
                       (26, 0), (27, 96), (28, 50), (21, 5), (25, 127)]:
        a.apply_midi_message(bytes([0xB0, ctl, value]), "hw:1")
        b.apply_midi_message(bytes([0xB0, ctl, value]), "hw:1")
    a.apply_midi_message(bytes([0xB0, 21, 127]), "hw:9")  # other device
    b.apply_midi_message(bytes([0xB0, 21, 127]), "hw:9")
    for name in ("select", "predelay", "vsteps", "speed", "dry", "wet",
                 "pan_dry", "pan_wet", "level"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), name)


def test_device_countdown_never_double_decrements_on_the_cpu():
    """The uploaded parameters are copies: advancing the host cache must
    not also advance the tensors the engine holds (the CPU aliasing hazard
    of torch.from_numpy)."""
    a, b = ControlPlane(2, 3, device="cpu"), JaxControlPlane(2, 3)
    for cp in (a, b):
        cp.speed[:] = 9
        cp.set_select(0, 1, 2)
    for _ in range(12):
        pa = a.snapshot_device()
        pb = b.snapshot_device()
        np.testing.assert_array_equal(pa.vsteps.numpy(), np.asarray(pb.vsteps))
        a.end_block()
        b.end_block()
    assert a.uploads == b.uploads == 1
    assert int(pa.vsteps.max()) == 0


def test_mix_math_matches():
    rng = np.random.default_rng(3)
    cp = JaxControlPlane(3, 2)
    cp.pan_wet[:] = rng.uniform(-1, 1, (3, 2))
    cp.pan_dry[:] = [[-1.0, 0.0], [1.0, 0.5], [-0.25, 0.75]]
    cp.dry[:] = rng.uniform(0, 1, (3, 2))
    cp.level[:] = rng.uniform(0, 1, (3, 2))
    jp = jax.tree.map(jnp.asarray, cp.snapshot())
    tp = VoiceParams(**vars(cp.snapshot())).to("cpu")
    np.testing.assert_allclose(mix.wet_scale(tp).numpy(),
                               np.asarray(jax_mix.wet_scale(jp)), atol=1e-6)
    out = rng.standard_normal((3, 2, 16)).astype(np.float32)
    x = rng.standard_normal((3, 2, 16)).astype(np.float32)
    np.testing.assert_allclose(
        mix.add_dry(torch.tensor(out), torch.tensor(x), tp).numpy(),
        np.asarray(jax_mix.add_dry(jnp.asarray(out), jnp.asarray(x), jp)),
        atol=1e-6)


def test_transform_matches_the_jax_fft_backend():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 2, 128)).astype(np.float32)
    a, b = SpectralTransform(128), JaxTransform(128, backend="fft")
    assert a.num_bins == b.num_bins == 65
    spec = a.rfft(torch.tensor(x))
    np.testing.assert_allclose(spec.numpy(), np.asarray(b.rfft(jnp.asarray(x))),
                               atol=1e-5)
    np.testing.assert_allclose(a.irfft(spec).numpy(), x, atol=1e-6)
    with pytest.raises(ValueError):
        SpectralTransform(100)


def test_block_timer_and_midi_schedule_match():
    a, b = BlockTimer(warmup=3, deadline_s=0.005), JaxBlockTimer(
        warmup=3, deadline_s=0.005)
    for s in np.random.default_rng(5).uniform(0.001, 0.008, 50):
        a.record(float(s))
        b.record(float(s))
    # the port reports every key of the JAX timer's summary but p90_ms
    want = b.summary(0.0058)
    del want["p90_ms"]
    assert a.summary(0.0058) == want
    text = "# timeline\n4 B0 15 40\n2 dev=hw:2,0 B0 16 7F\n9 hw:1 b0 17 01\n"
    sa, sb = MidiSchedule.parse(text), JaxMidiSchedule.parse(text)
    for block in range(10):
        assert sa.pop_due(block) == sb.pop_due(block)
    with pytest.raises(ValueError):
        MidiSchedule.parse("3 B0 zz 01")


def test_backends_match(tmp_path):
    def drain(src):
        out = []
        while (blk := src.read()) is not None:
            out.append(blk)
        return np.stack(out)

    x = np.random.default_rng(6).uniform(-0.5, 0.5, (2, 2, 333)
                                         ).astype(np.float32)
    pairs = [
        (backends.NoiseSource(2, 64, 5, amplitude=0.01, seed=3),
         jax_backends.NoiseSource(2, 64, 5, amplitude=0.01, seed=3)),
        (backends.ImpulseSource(2, 64, 3), jax_backends.ImpulseSource(2, 64, 3)),
        (backends.SilenceSource(2, 64, 2), jax_backends.SilenceSource(2, 64, 2)),
        (backends.WavSource(x, 2, 64), jax_backends.WavSource(x, 2, 64)),
        (backends.WavSource(x[0], 2, 64, loop=True, max_blocks=9),
         jax_backends.WavSource(x[0], 2, 64, loop=True, max_blocks=9)),
    ]
    for a, b in pairs:
        np.testing.assert_array_equal(drain(a), drain(b))
    blocks = [np.random.default_rng(7).uniform(-1, 1, (2, 2, 64))
              .astype(np.float32) for _ in range(3)]
    sa = backends.WavSink(tmp_path / "a.wav", voice="all", keep_data=True)
    sb = jax_backends.WavSink(tmp_path / "b.wav", voice="all", keep_data=True)
    for blk in blocks:
        sa.write(blk)
        sb.write(blk)
    sa.close()
    sb.close()
    np.testing.assert_array_equal(sa.data, sb.data)
    for v in range(2):
        assert ((tmp_path / f"a_v{v:03d}.wav").read_bytes()
                == (tmp_path / f"b_v{v:03d}.wav").read_bytes())
