"""The port's whole slice against the JAX slice: settings file -> IR bank ->
ConvolutionReverb -> StreamSession (steady, indexed and collapse_pure
switching under a MIDI timeline) -> sink, and the CLI of both packages.

The JAX model is built with backend="fft" so both sides run an FFT; sink
data agree to 2e-5 absolute (both f32, different summation orders). The JAX
CLI has no backend flag and runs its matmul DFT, so the CLI WAVs are held
to 1 LSB of 16-bit PCM.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_audio.io.index import write_index
from tpu_audio.io.wav import write_wav
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SETTINGS = """
conv.count 2
conv[0].fftSize 2048
conv[0].maxPredelay 128
conv[0].index {index}
conv[0].cc.message 176
conv[0].cc.select 21
conv[0].cc.predelay 22
conv[0].cc.dry 23
conv[0].cc.wet 24
conv[0].cc.panWet 26
conv[0].value.select 1
conv[0].value.predelay 40
conv[0].value.dry 0.3
conv[0].value.wet 0.7
conv[0].value.speed 12
conv[0].value.panWet 0.25
conv[0].value.level 0.9
conv[1].fftSize 2048
conv[1].maxPredelay 128
conv[1].index {index}
conv[1].cc.message 176
conv[1].cc.select 21
conv[1].cc.predelay 22
conv[1].cc.dry 23
conv[1].cc.wet 24
conv[1].cc.panWet 27
conv[1].value.select 0
conv[1].value.predelay 40
conv[1].value.dry 0.3
conv[1].value.wet 0.7
conv[1].value.speed 12
conv[1].value.panWet -0.5
conv[1].value.level 0.9
"""

# a re-select at block 4, an interrupting one at block 7, a wet change,
# then a predelay change once the fades have decayed
MIDI = "4 B0 15 40\n7 B0 15 7F\n9 B0 18 50\n90 B0 16 60\n"


@pytest.fixture
def settings_env(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for k in range(3):
        ir = rng.uniform(-0.3, 0.3, (150 + 40 * k, 2)).astype(np.float32)
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, ir, 44100)
        paths.append(str(p))
    idx = tmp_path / "bank.index"
    write_index(idx, paths)
    sfile = tmp_path / "settings.txt"
    sfile.write_text(SETTINGS.format(index=idx))
    (tmp_path / "events.txt").write_text(MIDI)
    x = rng.uniform(-0.2, 0.2, (64 * 120, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    return tmp_path


def test_session_matches_the_jax_slice(settings_env):
    base = settings_env
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 2, 64 * 120)) * 0.05).astype(np.float32)

    jm = JaxReverb.from_settings(str(base / "settings.txt"), engine="fmajor",
                                 block=64, num_voices=2, backend="fft",
                                 verbose=False)
    tm = ConvolutionReverb.from_settings(str(base / "settings.txt"),
                                         engine="fmajor", block=64,
                                         num_voices=2, device="cpu",
                                         verbose=False)
    for name in ("select", "predelay", "dry", "wet", "speed", "pan_wet",
                 "level", "select_base", "select_span"):
        np.testing.assert_array_equal(getattr(tm.control, name),
                                      getattr(jm.control, name), name)
    assert tm.control.mappings == {
        key: type(tm.control.mappings[key])(**vars(m))
        for key, m in jm.control.mappings.items()}

    jsink = JaxWavSink(base / "jax.wav", keep_data=True)
    jsess = jm.session(JaxWavSource(x, 2, 64), jsink)
    jsess.run(jm.init_state(), midi=JaxMidiSchedule.parse(MIDI))
    tsink = WavSink(base / "port.wav", keep_data=True)
    tsess = tm.session(WavSource(x, 2, 64), tsink)
    tsess.run(tm.init_state(), midi=MidiSchedule.parse(MIDI))

    assert tsess.indexed_blocks == jsess.indexed_blocks >= 20
    assert tsess.blocks_streamed == jsess.blocks_streamed == 120
    assert tsink.data.shape == jsink.data.shape
    np.testing.assert_allclose(tsink.data, jsink.data, atol=2e-5)
    np.testing.assert_array_equal(tm.control.select, jm.control.select)


@pytest.mark.parametrize("pipeline_depth", [1, 3])
def test_pipeline_depth_delivers_every_block_in_order(settings_env,
                                                      pipeline_depth):
    base = settings_env
    x = np.zeros((1, 2, 64 * 10), np.float32)
    x[:, :, 0] = 1.0
    tm = ConvolutionReverb.from_settings(str(base / "settings.txt"),
                                         engine="fmajor", block=64,
                                         device="cpu", verbose=False)
    ref = WavSink(base / "a.wav", keep_data=True)
    tm.process(WavSource(x, 1, 64), ref)
    tm2 = ConvolutionReverb.from_settings(str(base / "settings.txt"),
                                          engine="fmajor", block=64,
                                          device="cpu", verbose=False)
    got = WavSink(base / "b.wav", keep_data=True)
    tm2.process(WavSource(x, 1, 64), got, pipeline_depth=pipeline_depth)
    np.testing.assert_array_equal(got.data, ref.data)


def test_underrun_policy_and_realtime_clock_match_jax(settings_env):
    """A source that runs dry after 2 blocks: "silence" substitutes silent
    blocks until the consecutive-underrun cap (3) ends the session, as the
    JAX session does; the realtime clock paces blocks at the audio rate."""
    import time

    base = settings_env
    x = np.random.default_rng(2).uniform(-0.1, 0.1, (1, 2, 128)
                                         ).astype(np.float32)
    kwargs = dict(underrun_policy="silence", max_consecutive_underruns=3)
    jm = JaxReverb.from_settings(str(base / "settings.txt"), engine="fmajor",
                                 block=64, backend="fft", verbose=False)
    jsink = JaxWavSink(base / "jax.wav", keep_data=True)
    jsess = jm.session(JaxWavSource(x, 1, 64), jsink, **kwargs)
    jsess.run(jm.init_state())
    tm = ConvolutionReverb.from_settings(str(base / "settings.txt"),
                                         engine="fmajor", block=64,
                                         device="cpu", verbose=False)
    tsink = WavSink(base / "port.wav", keep_data=True)
    tsess = tm.session(WavSource(x, 1, 64), tsink, realtime=True, **kwargs)
    t0 = time.perf_counter()
    tsess.run(tm.init_state())
    elapsed = time.perf_counter() - t0
    assert (tsess.blocks_streamed, tsess.underruns) == (
        jsess.blocks_streamed, jsess.underruns) == (5, 4)
    assert elapsed >= 4 * tsess.block_period  # 5 paced blocks
    np.testing.assert_allclose(tsink.data, jsink.data, atol=2e-5)


def _pcm16(path):
    """Raw int16 samples of a 16-bit PCM WAV written by either package."""
    blob = open(path, "rb").read()
    data = blob.index(b"data") + 8
    return np.frombuffer(blob[data:], dtype="<i2")


def test_cli_wavs_match_the_jax_cli_within_one_lsb(settings_env):
    from tpu_audio.app.main import main as jax_main
    from tpu_audio_torch.app.main import main as port_main

    base = settings_env
    common = ["--settings", str(base / "settings.txt"),
              "--input", str(base / "in.wav"), "--midi",
              str(base / "events.txt"), "--block-size", "64", "--quiet"]
    assert jax_main(common + ["--output", str(base / "jax_out.wav")]) == 0
    assert port_main(common + ["--output", str(base / "port_out.wav"),
                               "--device", "cpu"]) == 0
    want, got = _pcm16(base / "jax_out.wav"), _pcm16(base / "port_out.wav")
    assert got.shape == want.shape and got.size >= 64 * 120 * 2
    assert np.abs(want).max() > 1000  # real signal, not silence
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1


def test_no_swap_snapshot_cli_matches_the_jax_cli(settings_env):
    """--no-swap-snapshot drops the materialized fade snapshot in both
    CLIs (span-only fades); the WAVs agree within 1 LSB as above."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio_torch.app.main import main as port_main

    base = settings_env
    common = ["--settings", str(base / "settings.txt"),
              "--input", str(base / "in.wav"), "--midi",
              str(base / "events.txt"), "--block-size", "64", "--quiet",
              "--no-swap-snapshot"]
    assert jax_main(common + ["--output", str(base / "jax_ns.wav")]) == 0
    assert port_main(common + ["--output", str(base / "port_ns.wav"),
                               "--device", "cpu"]) == 0
    want, got = _pcm16(base / "jax_ns.wav"), _pcm16(base / "port_ns.wav")
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1


def test_model_swap_snapshot_rule_matches_jax(settings_env):
    """swap_snapshot=False composes only with 'allk': under 'auto' the
    model keeps 'allk' even for a bank that would resolve to 'selected',
    and the engine carries no snapshot; with the snapshot, 17 IRs resolve
    to 'selected' (tpu_audio/models/reverb.py:208-213)."""
    from tpu_audio.engine import IRBank as JaxIRBank
    from tpu_audio_torch.engine import IRBank

    irs = np.random.default_rng(3).uniform(-0.3, 0.3, (17, 2, 100)
                                           ).astype(np.float32)
    for flag, strategy in ((False, "allk"), (True, "selected")):
        jbank, tbank = JaxIRBank(), IRBank()
        for ir in irs:
            jbank.append(ir)
            tbank.append(ir)
        jm = JaxReverb(jbank, block=64, max_predelay=64, backend="fft",
                       swap_snapshot=flag)
        tm = ConvolutionReverb(tbank, block=64, max_predelay=64,
                               swap_snapshot=flag, device="cpu")
        assert (jm.engine.mac_strategy == tm.engine.mac_strategy
                == strategy)
        assert tm.engine.swap_snapshot is flag
        assert (tuple(tm.init_state().base.shape)
                == tuple(jm.init_state().base.shape))


def test_cli_reports_and_rejects_like_the_jax_cli(settings_env, capsys):
    from tpu_audio_torch.app.main import main as port_main

    base = settings_env
    assert port_main(["--settings", str(base / "nope.txt"), "--quiet",
                      "--device", "cpu"]) == 2
    assert port_main(["--settings", str(base / "settings.txt"), "--signal",
                      "noise", "--blocks", "12", "--block-size", "64",
                      "--quiet", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "streamed 12 blocks | avg" in out and "| rtf" in out


def test_import_leaves_jax_out():
    code = ("import sys; import tpu_audio_torch.app.main, "
            "tpu_audio_torch.engine, tpu_audio_torch.runtime, "
            "tpu_audio_torch.ops.ring_mac, "
            "tpu_audio_torch.engine.device_prep, "
            "tpu_audio_torch.engine.cascade, "
            "tpu_audio_torch.engine.partitioned, "
            "tpu_audio_torch.engine.monolithic, "
            "tpu_audio_torch.ops.hermitian, "
            "tpu_audio_torch.ops.smoother, "
            "tpu_audio_torch.runtime.working_set, "
            "tpu_audio_torch.runtime.offline, "
            "tpu_audio_torch.runtime.checkpoint, "
            "tpu_audio_torch.runtime.recovery, "
            "tpu_audio_torch.runtime.native, "
            "tpu_audio_torch.runtime.midi_transport, "
            "tpu_audio_torch.runtime.jack_bridge, "
            "tpu_audio_torch.io.midi, "
            "tpu_audio_torch.utils.wire, "
            "tpu_audio_torch.app.tools, "
            "tpu_audio_torch.utils.diskcache, "
            "tpu_audio_torch.utils.trace, "
            "tpu_audio_torch.parallel.mesh; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'tpu_audio.'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
