"""Live IR churn on the CPU: the crossfade reference against the literal
slew law, the port's session under a churn schedule against that
reference, the session's fade counters on a hand-counted schedule, and the
``control`` span (runtime/stream.py, portbench/reference/crossfade.py,
portbench/generators/churn_stream.py)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.generators.churn_stream import (make_events, map_voices,
                                               midi_events)
from portbench.reference.crossfade import CrossfadeReference, FadeLaw
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.utils.profiling import Spans

torch.set_num_threads(1)

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "fmajor_churn_f32.json").read_text())
PARAMS = CONFIG["params"]


def _irs(k, seconds, rate=44100, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    env = np.exp(-np.arange(n) / (0.4 * n)) * 0.3
    return (rng.standard_normal((k, 2, n)) * env).astype(np.float32)


def _literal_slew(irs, block, params, x, select0, events, speed, blocks):
    """The reference application's law as it is written: per block, each
    channel's active partition spectra slew toward wet * H[sel] by
    1 / (vsteps + 5), the block's output is the partitioned product with
    the active spectra, and then the predelay, clamp and dry mix."""
    k, o, length = irs.shape
    parts = -(-length // block)
    padded = np.zeros((k, o, parts * block))
    padded[..., :length] = irs
    h = np.fft.rfft(padded.reshape(k, o, parts, block), n=2 * block)
    wet = params["wet"]
    sel = np.array(select0)
    active = wet * h[sel]                                  # [I, O, P, F]
    vsteps = np.zeros(2)
    xs = np.concatenate([np.zeros((2, block)), x], axis=-1)
    spec = np.fft.rfft(np.stack([xs[:, t * block: (t + 2) * block]
                                 for t in range(x.shape[-1] // block)]))
    conv = []
    for t in range(x.shape[-1] // block):
        for ch, ir in events.get(t, ()):
            sel[ch] = ir
            vsteps[ch] = speed
        target = wet * h[sel]
        active = active + (target - active) / (vsteps + 5.0)[:, None, None,
                                                            None]
        acc = np.zeros((o, h.shape[-1]), complex)
        for p in range(min(parts, t + 1)):
            acc += np.einsum("if,iof->of", spec[t - p], active[:, :, p])
        conv.append(np.fft.irfft(acc, n=2 * block)[:, block:])
        vsteps = np.maximum(vsteps - 1.0, 0.0)
    q, r = divmod(params["predelay"], block)
    zero = np.zeros((o, block))
    out = []
    for t in blocks:
        cur = conv[t - q] if t - q >= 0 else zero
        w = cur
        if r:
            before = conv[t - q - 1] if t - q - 1 >= 0 else zero
            w = np.concatenate([before, cur], axis=-1)[:, block - r:
                                                       2 * block - r]
        w = np.clip(w * params["level"], -1.0, 1.0)
        xt = x[:, t * block: (t + 1) * block]
        out.append(w + params["dry"] * params["level"] * (xt[0] + xt[1]))
    return np.stack(out)


@pytest.mark.parametrize("predelay", [512, 300])
def test_weight_form_equals_the_literal_spectral_slew(predelay):
    """Two voices, 3 IRs of 0.1 s: voice 0's fade to IR 2 is interrupted
    mid-way by a select of IR 1, voice 1 fades once; the weighted sum of
    per-IR blocks equals the per-block slew of the active spectra."""
    block, blocks_n = 64, 120
    irs = _irs(3, 0.1, seed=3)
    params = {**PARAMS, "predelay": predelay}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, blocks_n * block)) * 0.05
    select0 = np.array([[0, 0], [1, 1]])
    events = [(10, 0, 2), (14, 0, 1), (20, 1, 2)]
    speed = 16
    law = FadeLaw(select0, 3, params["wet"], speed,
                  [(b, v, ch, ir) for b, v, ir in events for ch in range(2)])
    ref = CrossfadeReference(irs, block, params)
    blocks = np.arange(blocks_n)
    q = predelay // block
    fades = law.weights(np.arange(-q - 1, blocks_n))
    assert fades[20].interrupted[0].all() and not fades[20].interrupted[1].any()
    for v in range(2):
        got = ref.render(
            lambda js, v=v: np.stack([x[v, :, j * block: (j + 1) * block]
                                      if j >= 0 else np.zeros((2, block))
                                      for j in js]),
            lambda js, v=v: np.stack([fades[int(j)].w[v] for j in js]),
            blocks)
        want = _literal_slew(irs, block, params, x[v], select0[v],
                             {b: [(ch, ir) for ch in range(2)]
                              for b, vv, ir in events if vv == v},
                             speed, blocks)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale)


def _churn_model(voices, k, seconds, speed, block=256):
    bank = IRBank(sample_rate=44100)
    for ir in _irs(k, seconds, seed=5):
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=voices, block=block,
                              sample_rate=44100, device="cpu",
                              **CONFIG["model"])
    map_voices(model.control, {**CONFIG["midi"], "speed": speed})
    c = model.control
    c.select[:] = (np.arange(voices) % k)[:, None]
    c.vsteps[:] = 0
    c.predelay[:] = PARAMS["predelay"]
    for name in ("wet", "dry", "pan_wet", "pan_dry", "level"):
        getattr(c, name)[:] = PARAMS[name]
    return model


def test_the_session_under_churn_agrees_with_the_crossfade_reference():
    """8 voices, 4 IRs of 0.25 s, speed 8, two voices re-selected every 4
    blocks (one of them inside a live fade), 64 blocks through the served
    path: every block the IRs have filled is within the configuration's
    limits of reference/crossfade.py."""
    voices, k, blocks_n, speed = 8, 4, 64, 8
    irs = _irs(k, 0.25, seed=5)
    model = _churn_model(voices, k, 0.25, speed)
    select0 = np.repeat((np.arange(voices) % k)[:, None], 2, axis=1)
    churn = {"first_block": 4, "every_blocks": 4, "voices_per_event": 2,
             "interrupting": 1, "live_within_blocks": 8,
             "fresh_after_blocks": 12}
    events = make_events(2**40 + 9, voices, k, churn, select0, blocks_n)
    x = (np.random.default_rng(6).standard_normal(
        (voices, 2, blocks_n * 256)) * 0.01).astype(np.float32)
    sink = WavSink("/dev/null", keep_data=True)
    session = model.session(WavSource(x, voices, 256), sink, warmup=0)
    session.run(model.init_state(),
                midi=MidiSchedule(midi_events(events, CONFIG["midi"])))
    law = FadeLaw(select0, k, PARAMS["wet"], speed,
                  [(b, v, ch, ir) for b, v, ir, _ in events
                   for ch in range(2)])
    ref = CrossfadeReference(irs, 256, PARAMS)
    q = PARAMS["predelay"] // 256
    blocks = np.arange(ref.partitions + q + 1, blocks_n)
    fades = law.weights(np.arange(blocks_n))
    assert any(fades[t - q].interrupted.any() for t in blocks)
    assert session.summary()["counters"]["fades_interrupted"] > 0
    want = np.empty((len(blocks), voices, 2, 256))
    for v in range(voices):
        want[:, v] = ref.render(
            lambda js, v=v: np.stack([x[v, :, j * 256: (j + 1) * 256]
                                      if j >= 0 else np.zeros((2, 256))
                                      for j in js]),
            lambda js, v=v: np.stack([fades[int(j)].w[v] for j in js]),
            blocks)
    got = np.stack([sink.data[:, :, t * 256: (t + 1) * 256]
                    for t in blocks])
    diff = got - want
    err_rms = np.sqrt(np.sum(diff ** 2) / np.sum(want ** 2))
    err_max = np.abs(diff).max() / np.abs(want).max()
    assert err_rms <= CONFIG["limits"]["err_rms"], err_rms
    assert err_max <= CONFIG["limits"]["err_max"], err_max


def _two_voice_model(speed):
    rng = np.random.default_rng(0)
    bank = IRBank(sample_rate=44100)
    for k in range(3):
        bank.append(rng.uniform(-0.3, 0.3, (2, 150 + 40 * k))
                    .astype(np.float32))
    model = ConvolutionReverb(bank, num_voices=2, block=64, max_predelay=64,
                              sample_rate=44100, device="cpu")
    for v in range(2):
        for ch in range(2):
            model.control.set_mapping(v, ch, CCMapping(device=f"v{v}",
                                                       select=21))
    model.control.speed[:] = speed
    return model


def _cc(block, voice, ir):
    # value * 3 // 128 == ir
    return (block, f"v{voice}", bytes([0xB0, 21, -(-ir * 128 // 3)]))


def test_fade_counters_read_the_hand_counted_schedule():
    """Speed 0: a fade's a is 0.8 ** m m blocks after its select, so it is
    live (>= 1e-6) on the select block and the 61 after it. Voice 0
    selects IR 1 at block 2 and IR 2 at block 10 (inside that fade: one
    interrupt a channel); voice 1 selects IR 2 at block 10, IR 2 again at
    block 50 (no change, no select) and IR 0 at block 100 (its fade long
    decayed). 8 selects in 3 collapses, 2 interrupted; live channel-blocks:
    voice 0 8 + 62, voice 1 62 + 62, a channel each; the fade step rides
    the blocks [2, 71] and [100, 161]."""
    model = _two_voice_model(speed=0)
    midi = MidiSchedule([_cc(2, 0, 1), _cc(10, 0, 2), _cc(10, 1, 2),
                         _cc(50, 1, 2), _cc(100, 1, 0)])
    x = np.zeros((2, 2, 170 * 64), np.float32)
    session = model.session(WavSource(x, 2, 64), WavSink("/dev/null"),
                            warmup=0)
    session.run(model.init_state(), midi=midi)
    c = session.summary()["counters"]
    assert c["selects"] == 8
    assert c["fades_interrupted"] == 2
    assert c["fading_channel_blocks"] == 2 * (8 + 62) + 2 * (62 + 62)
    assert c["indexed_blocks"] == 70 + 62
    assert c["collapses_pure"] == 3 and c["collapses_full"] == 0


class _LiveAt:
    """A live MIDI source that hands one message over at its n-th poll."""

    def __init__(self, n, message):
        self.n, self.message, self.polls = n, message, 0

    def poll(self):
        self.polls += 1
        return [self.message] if self.polls == self.n + 1 else []


def test_control_span_on_event_blocks_only_and_output_unchanged():
    """Spans on or off, the session's output is the same to the bit; a
    ``control`` span opens inside the block span of each block on which a
    scripted or a live message is due, and on no other."""
    out = {}
    for on in (False, True):
        model = _two_voice_model(speed=4)
        x = (np.random.default_rng(2).standard_normal((2, 2, 24 * 64))
             * 0.05).astype(np.float32)
        sink = WavSink("/dev/null", keep_data=True)
        spans = Spans() if on else None
        session = model.session(WavSource(x, 2, 64), sink, warmup=0,
                                spans=spans)
        midi = MidiSchedule([_cc(3, 0, 1), _cc(7, 1, 2), _cc(8, 0, 2),
                             _cc(8, 1, 0)])
        live = _LiveAt(12, ("v1", bytes([0xB0, 21, 0])))
        session.run(model.init_state(), midi=midi, live_midi=live)
        out[on] = sink.data
    np.testing.assert_array_equal(out[True], out[False])
    recs = spans.records()
    control = [r for r in recs if r.name == "control"]
    assert sorted(r.block for r in control) == [3, 7, 8, 12]
    for r in control:
        assert recs[r.parent].name == "block"
        assert recs[r.parent].block == r.block
    assert session.summary()["counters"]["selects"] == 8
