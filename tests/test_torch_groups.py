"""A settings file whose conv pairs differ (fftSize and index files): the
port's ReverbGroups (tpu_audio_torch/models/reverb.py) and the CLI's groups
route, streamed and --offline, against the JAX package; and
MultiVoiceReverbServer.

The same settings, IR WAVs and input go through both packages on the CPU;
the JAX models are built with backend="fft". Tolerances: the summed group
output within 2e-5 absolute (f32 sums in another order); CLI WAVs within 1
LSB of the JAX CLI's, which runs its matmul DFT.
"""

import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.io.index import write_index
from tpu_audio.io.wav import write_wav
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.models.reverb import MultiVoiceReverbServer as JaxServer
from tpu_audio.models.reverb import ReverbGroups as JaxGroups
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.models.reverb import (
    ConvolutionReverb, MultiVoiceReverbServer, ReverbGroups,
)
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

B = 64
# pair 0: fftSize 1024 over bank A; pair 1: fftSize 512 over bank B for
# channel 0 and bank A for channel 1 (two windows of one merged bank)
PAIRS = ((1024, "a", "a"), (512, "b", "a"))
MIDI = "6 B0 15 7F\n11 B0 18 30\n"


def _write_bank(base, name, lengths, seed):
    rng = np.random.default_rng(seed)
    paths = []
    for k, n in enumerate(lengths):
        path = base / f"{name}{k}.wav"
        write_wav(path, (rng.uniform(-0.3, 0.3, (n, 2))).astype(np.float32),
                  44100)
        paths.append(str(path))
    write_index(base / f"{name}.index", paths)
    return base / f"{name}.index"


@pytest.fixture
def het_env(tmp_path):
    index = {"a": _write_bank(tmp_path, "a", (200, 300), 1),
             "b": _write_bank(tmp_path, "b", (150, 260, 220), 2)}
    lines = [f"conv.count {2 * len(PAIRS)}"]
    for n, (fft, idx0, idx1) in enumerate(PAIRS):
        for ch, idx in enumerate((idx0, idx1)):
            c = 2 * n + ch
            lines += [f"conv[{c}].fftSize {fft}", f"conv[{c}].maxPredelay 128",
                      f"conv[{c}].index {index[idx]}",
                      f"conv[{c}].cc.message 176", f"conv[{c}].cc.select 21",
                      f"conv[{c}].cc.wet 24", f"conv[{c}].value.select {n}",
                      f"conv[{c}].value.predelay {20 * (c + 1)}",
                      f"conv[{c}].value.dry 0.2", f"conv[{c}].value.wet 0.6",
                      f"conv[{c}].value.speed 10",
                      f"conv[{c}].value.panWet {0.5 - 0.25 * c}"]
    (tmp_path / "het.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "events.txt").write_text(MIDI)
    x = np.random.default_rng(3).uniform(-0.2, 0.2, (B * 40, 2))
    write_wav(tmp_path / "in.wav", x.astype(np.float32), 44100, scale="full")
    return tmp_path


@pytest.mark.parametrize("engine", ["monolithic", "partitioned", "fmajor"])
def test_groups_process_matches_jax(het_env, engine):
    settings = str(het_env / "het.txt")
    jg = JaxGroups.from_settings(settings, engine=engine, block=B,
                                 backend="fft", verbose=False)
    tg = ReverbGroups.from_settings(settings, engine=engine, block=B,
                                    device="cpu", verbose=False)
    assert tg.pair_ids == jg.pair_ids == [[0], [1]]
    assert ([type(m.engine).__name__ for m in tg.models]
            == [type(m.engine).__name__ for m in jg.models])
    if engine == "monolithic":
        assert [m.engine.fft_size for m in tg.models] == [1024, 512]
    for tm, jm in zip(tg.models, jg.models):
        for name in ("select", "select_base", "select_span", "predelay",
                     "wet", "pan_wet"):
            np.testing.assert_array_equal(getattr(tm.control, name),
                                          getattr(jm.control, name), name)
    x = (np.random.default_rng(4).standard_normal((2, B * 30)) * 0.05
         ).astype(np.float32)
    want, jsum = jg.process(x, midi=JaxMidiSchedule.parse(MIDI))
    got, tsum = tg.process(x, midi=MidiSchedule.parse(MIDI))
    assert [s["blocks_streamed"] for s in tsum] == [
        s["blocks_streamed"] for s in jsum] == [30, 30]
    assert got.shape == want.shape == (2, B * 30)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the sum of the groups is the sum of each group alone
    solo, _ = ReverbGroups([tg.models[1]], [tg.pair_ids[1]]).process(
        x, midi=MidiSchedule.parse(MIDI))
    assert np.abs(got - solo).max() > 1e-3


def test_one_model_refuses_a_file_whose_pairs_differ(het_env):
    settings = str(het_env / "het.txt")
    with pytest.raises(ValueError, match="ReverbGroups"):
        JaxReverb.from_settings(settings, block=B, backend="fft",
                                verbose=False)
    with pytest.raises(ValueError, match="ReverbGroups"):
        ConvolutionReverb.from_settings(settings, block=B, device="cpu",
                                        verbose=False)


def _pcm16(path):
    blob = open(path, "rb").read()
    return np.frombuffer(blob[blob.index(b"data") + 8:], dtype="<i2")


@pytest.mark.parametrize("extra", [[], ["--offline", "2"],
                                   ["--engine", "partitioned", "--variant",
                                    "materialized"]])
def test_cli_groups_match_the_jax_cli(het_env, extra, capsys):
    from tpu_audio.app.main import main as jax_main
    from tpu_audio_torch.app.main import main as port_main

    base = het_env
    args = ["--settings", str(base / "het.txt"), "--input",
            str(base / "in.wav"), "--block-size", str(B), "--quiet"]
    args += extra or ["--engine", "monolithic", "--midi",
                      str(base / "events.txt")]
    if "--offline" in extra:
        args += ["--engine", "monolithic"]
    assert jax_main(args + ["--output", str(base / "jax.wav")]) == 0
    capsys.readouterr()
    assert port_main(args + ["--output", str(base / "port.wav"),
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("offline bounce" in out if "--offline" in extra
            else "group pairs [0]: 40 blocks" in out)
    want, got = _pcm16(base / "jax.wav"), _pcm16(base / "port.wav")
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1


def test_cli_groups_refuse_live_rings(het_env):
    from tpu_audio_torch.app.main import main as port_main

    assert port_main(["--settings", str(het_env / "het.txt"), "--input-ring",
                      "x", "--quiet", "--device", "cpu"]) == 2


def test_multi_voice_server_defaults_like_jax():
    irs = np.random.default_rng(5).uniform(-0.3, 0.3, (2, 2, 150)
                                           ).astype(np.float32)
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    jm = JaxServer(jbank, num_voices=2, block=B, max_predelay=64,
                   backend="fft")
    tm = MultiVoiceReverbServer(tbank, num_voices=2, block=B, max_predelay=64,
                                device="cpu")
    assert type(tm.engine).__name__ == type(jm.engine).__name__
    assert tm.engine.num_voices == 2
    other = MultiVoiceReverbServer(tbank, num_voices=3, block=B,
                                   engine="partitioned", device="cpu")
    assert type(other.engine).__name__ == "PartitionedConvolution"
    assert MultiVoiceReverbServer(tbank, device="cpu").engine.num_voices == 64
