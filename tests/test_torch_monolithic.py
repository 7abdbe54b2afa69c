"""The port's monolithic engine (tpu_audio_torch/engine/monolithic.py) and the
modules under it: ops/hermitian.py, ops/mix.py's predelay overlap-add and
2x2 dry mix, ops/partition.py's monolithic spectrum and the IR bank's
prepare, spectral taper and monolithic spectra, against the JAX package.

The same numpy inputs, made from seeds, go through both packages on the
CPU. Tolerances: the bank and spectra functions are numpy in both packages
and must agree to the bit; the Hermitian packing and the mix within 1e-6 of
scale (f32 sums in another order); the engine against a float64
fftconvolve golden 2e-4 (tests/test_engine.py's bound); the CLI's WAV
within 1 LSB of the JAX CLI's (which runs its matmul DFT). The engine's
crossfade, session, checkpoint and offline parity with the JAX engine is
in tests/test_torch_partitioned.py, beside the partitioned engines.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.signal import fftconvolve

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.io.index import write_index
from tpu_audio.io.wav import write_wav
from tpu_audio.ops import hermitian as jax_hermitian
from tpu_audio.ops import mix as jax_mix
from tpu_audio.ops import partition as jax_partition
from tpu_audio_torch.engine import ControlPlane, IRBank, MonolithicConvolution
from tpu_audio_torch.ops import hermitian, mix, partition

torch.set_num_threads(1)

V, B, FFT = 2, 64, 1024


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# -- ops/hermitian.py ------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 1024])
def test_hermitian_packing_matches_jax(n):
    l, r = _rand((3, n), n), _rand((3, n), n + 1)
    _close(hermitian.pack_2r_to_c(torch.from_numpy(l), torch.from_numpy(r)),
           jax_hermitian.pack_2r_to_c(l, r), 0)
    packed = np.fft.fft(l + 1j * r).astype(np.complex64)
    for got, want in zip(hermitian.unpack_c_to_2r(torch.from_numpy(packed)),
                         jax_hermitian.unpack_c_to_2r(packed)):
        _close(got, want, 1e-6)
    for got, want in zip(
            hermitian.rfft_via_pack(torch.from_numpy(l), torch.from_numpy(r)),
            jax_hermitian.rfft_via_pack(l, r)):
        _close(got, want, 1e-6)
        assert got.shape[-1] == n
    # the unpacked spectra are the channels' own FFTs
    left, right = hermitian.rfft_via_pack(torch.from_numpy(l),
                                          torch.from_numpy(r))
    _close(left, np.fft.fft(l), 1e-5)
    _close(right, np.fft.fft(r), 1e-5)
    half = np.fft.rfft(l).astype(np.complex64)
    _close(hermitian.full_spectrum_from_half(torch.from_numpy(half), n),
           jax_hermitian.full_spectrum_from_half(half, n), 0)


@pytest.mark.parametrize("n,bins,match", [(15, 8, "even n"),
                                          (16, 8, "bins")])
def test_full_spectrum_refuses_like_jax(n, bins, match):
    half = np.zeros((bins,), np.complex64)
    with pytest.raises(ValueError, match=match):
        jax_hermitian.full_spectrum_from_half(half, n)
    with pytest.raises(ValueError, match=match):
        hermitian.full_spectrum_from_half(torch.from_numpy(half), n)


# -- ops/mix.py ----------------------------------------------------------------------------


@pytest.mark.parametrize("predelays", [[0, 0, 0], [5, 0, 40], [17, 64, 3]])
def test_delay_and_clamp_add_matches_the_jax_vmap(predelays):
    """One gather per call against the JAX function vmapped over voices (the
    monolithic engine's use, tpu_audio/engine/monolithic.py:147)."""
    residual = _rand((3, 2, 96), 1) * 0.6
    wet = _rand((3, 2, 32), 2) * 0.6
    pd = np.array(predelays, np.int32)
    want = jax.vmap(jax_mix.delay_and_clamp_add)(residual, wet, pd)
    got = mix.delay_and_clamp_add(torch.from_numpy(residual),
                                  torch.from_numpy(wet),
                                  torch.from_numpy(pd)[:, None])
    _close(got, want, 1e-7)
    assert float(got.abs().max()) <= 1.0
    scalar = mix.delay_and_clamp_add(torch.from_numpy(residual[0]),
                                     torch.from_numpy(wet[0]), predelays[1])
    _close(scalar, jax_mix.delay_and_clamp_add(residual[0], wet[0],
                                               predelays[1]), 1e-7)


def test_dry_mix_2x2_matches_jax():
    out_l, out_r, in1, in2 = (_rand((2, 48), s) for s in range(4))
    in1, in2 = in1[:, :32], in2[:, :32]
    gains = (0.3, 0.7, -0.2, 0.5)
    want = jax_mix.dry_mix_2x2(*(jax.numpy.asarray(a)
                                 for a in (out_l, out_r, in1, in2)), gains)
    got = mix.dry_mix_2x2(*(torch.from_numpy(a)
                            for a in (out_l, out_r, in1, in2)), gains)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)


# -- ops/partition.py and the bank -----------------------------------------------------------


def _banks(irs):
    jb, tb = JaxIRBank(), IRBank()
    for ir in irs:
        jb.append(ir)
        tb.append(ir)
    return jb, tb


@pytest.mark.parametrize("fft_size,reserve", [(1024, 768), (512, 64)])
def test_monolithic_spectra_equal_jax(fft_size, reserve):
    irs = [_rand((2, n), n) for n in (300, 700, 128)]
    jb, tb = _banks(irs)
    np.testing.assert_array_equal(tb.monolithic_spectra(fft_size, reserve),
                                  jb.monolithic_spectra(fft_size, reserve))
    np.testing.assert_array_equal(
        partition.monolithic_spectrum(irs[1], fft_size, reserve),
        jax_partition.monolithic_spectrum(irs[1], fft_size, reserve))


def test_bank_prepare_and_spectral_taper_equal_jax():
    irs = [_rand((2, n), n) for n in (300, 200)]
    jb, tb = _banks(irs)
    for bank in (jb, tb):
        bank.prepare(4, _rand((2, 250), 9))     # extends through silent slots
        bank.prepare(0, _rand((250,), 10))      # mono replaces a slot
        bank.spectral_taper()
    assert len(tb) == len(jb) == 5
    for k in range(5):
        np.testing.assert_array_equal(tb.ir(k), jb.ir(k))
    np.testing.assert_array_equal(tb.partitioned_spectra(B),
                                  jb.partitioned_spectra(B))
    tb.spectral_taper(fft_size=512)
    jb.spectral_taper(fft_size=512)
    np.testing.assert_array_equal(tb.ir(2), jb.ir(2))


# -- the engine ------------------------------------------------------------------------------


def test_monolithic_matches_offline_convolution():
    """tests/test_engine.py's golden: block-streamed engine == an offline
    float64 fftconvolve composition, per-voice pans and a predelay."""
    irs = [_rand((2, 300), s) * 0.1 for s in (20, 21)]
    _, bank = _banks(irs)
    eng = MonolithicConvolution(V, FFT, B, max_predelay=256, device="cpu")
    spectra = torch.from_numpy(bank.monolithic_spectra(FFT, reserve=320))
    cp = ControlPlane(V, 2, max_predelay=256, device="cpu")
    cp.select[:] = [[0, 0], [1, 1]]
    cp.predelay[:] = 128
    cp.dry[:] = 0.3
    cp.wet[:] = 0.8
    cp.pan_wet[:] = [[-0.5, 0.25], [0.0, 0.0]]
    cp.pan_dry[:] = [[0.1, -0.1], [0.0, 0.0]]
    cp.level[:] = 0.9
    params = cp.snapshot_device()
    state = eng.init_converged(spectra, params)
    x = _rand((V, 2, B * 12), 3) * 0.05
    outs = []
    for t in range(12):
        state, out = eng.step(state, spectra, params,
                              torch.from_numpy(x[..., t * B:(t + 1) * B]))
        outs.append(out.numpy())
    got = np.concatenate(outs, axis=-1)
    t_len = x.shape[-1]
    for v in range(V):
        ir = irs[int(cp.select[v, 0])]
        for o in range(2):
            acc = np.zeros(t_len)
            dry = np.zeros(t_len)
            for i in range(2):
                pan = cp.pan_wet[v, i]
                g = (1 - pan if pan >= 0 else 1.0) if o == 0 else \
                    (1 + pan if pan <= 0 else 1.0)
                conv = fftconvolve(x[v, i].astype(np.float64),
                                   ir[o].astype(np.float64))[:t_len]
                acc[128:] += conv[: t_len - 128] * 0.8 * g * 0.9
                pd_ = cp.pan_dry[v, i]
                gd = (1 - pd_ if pd_ >= 0 else 1.0) if o == 0 else \
                    (1 + pd_ if pd_ <= 0 else 1.0)
                dry += x[v, i] * 0.3 * gd * 0.9
            np.testing.assert_allclose(got[v, o], np.clip(acc, -1, 1) + dry,
                                       atol=2e-4)


def test_engine_geometry_and_plan_warmup():
    eng = MonolithicConvolution(V, FFT, B, max_predelay=128, device="cpu")
    assert eng.ext == FFT + 128 and eng.num_bins == FFT // 2 + 1
    assert eng.history_blocks == -(-(FFT + 128) // B) + 2
    clone = eng.with_voices(6)
    assert (clone.num_voices, clone.fft_size, clone.block,
            clone.max_predelay) == (6, FFT, B, 128)
    state = clone.init_state()
    assert tuple(state.active.shape) == (6, 2, 2, FFT // 2 + 1)
    assert state.active.dtype == torch.complex64
    assert tuple(state.residual.shape) == (6, 2, FFT + 128)
    eng.warmup()
    with pytest.raises(ValueError, match="block must be < fft_size"):
        MonolithicConvolution(V, 64, 64, device="cpu")


# -- the CLI ---------------------------------------------------------------------------------


def test_cli_monolithic_matches_the_jax_cli(tmp_path):
    """--engine monolithic at fftSize 1024 with re-selects from a MIDI
    schedule: the WAVs agree within 1 LSB."""
    from tpu_audio.app.main import main as jax_main
    from tpu_audio_torch.app.main import main as port_main

    paths = []
    for k in range(3):
        p = tmp_path / f"ir{k}.wav"
        write_wav(p, _rand((260 + 40 * k, 2), k) * 0.2, 44100)
        paths.append(str(p))
    write_index(tmp_path / "bank.index", paths)
    lines = ["conv.count 2"]
    for ch in range(2):
        lines += [f"conv[{ch}].fftSize 1024", f"conv[{ch}].maxPredelay 128",
                  f"conv[{ch}].index {tmp_path / 'bank.index'}",
                  f"conv[{ch}].cc.message 176", f"conv[{ch}].cc.select 21",
                  f"conv[{ch}].value.select {ch}",
                  f"conv[{ch}].value.predelay 40",
                  f"conv[{ch}].value.dry 0.3", f"conv[{ch}].value.wet 0.7",
                  f"conv[{ch}].value.speed 12"]
    (tmp_path / "settings.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "events.txt").write_text("5 B0 15 40\n9 B0 15 7F\n")
    x = np.random.default_rng(0).uniform(-0.2, 0.2, (B * 50, 2))
    write_wav(tmp_path / "in.wav", x.astype(np.float32), 44100, scale="full")
    args = ["--settings", str(tmp_path / "settings.txt"), "--input",
            str(tmp_path / "in.wav"), "--midi", str(tmp_path / "events.txt"),
            "--block-size", "64", "--engine", "monolithic", "--quiet"]
    assert jax_main(args + ["--output", str(tmp_path / "jax.wav")]) == 0
    assert port_main(args + ["--output", str(tmp_path / "port.wav"),
                             "--device", "cpu"]) == 0

    def pcm16(path):
        blob = open(path, "rb").read()
        return np.frombuffer(blob[blob.index(b"data") + 8:], dtype="<i2")

    want, got = pcm16(tmp_path / "jax.wav"), pcm16(tmp_path / "port.wav")
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
    assert want.size == 2 * B * 50
