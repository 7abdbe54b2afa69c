"""Working-set IR residency in the port (tpu_audio_torch/runtime/
working_set.py, the control-plane hooks, the model and CLI wiring) against
the JAX package's, and against the port's own full-bank engine.

The residency policy is the same host code on both sides, so the same
select script must give identical residency maps, counters and control
state. Sessions run the JAX model with backend="fft", bank_prep="device"
and fault_upload="td", so both sides transform every IR with an FFT on
their device; sink data agree to 2e-5 absolute (both f32, different
summation orders). A working set that never starves equals the full-bank
engine to 1e-6 (the JAX package's own tolerance for that comparison). The
CLI WAVs are held to 1 LSB of 16-bit PCM (the JAX CLI runs its matmul DFT).
"""

import numpy as np
import pytest
import torch

from tpu_audio.engine import ControlPlane as JaxControlPlane
from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import device_prep as jax_dp
from tpu_audio.engine.fmajor import (
    FMajorPartitionedConvolution as JaxFMajor,
)
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio.runtime.working_set import WorkingSetBank as JaxWorkingSet
from tpu_audio_torch.engine import ControlPlane, IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.stream import MidiSchedule
from tpu_audio_torch.runtime.working_set import (
    WorkingSetBank, WorkingSetExhausted,
)

torch.set_num_threads(1)

B, V, KFULL, CAP = 32, 2, 7, 3
ATOL = 2e-5
CCS = {(0, 0): 0x15, (0, 1): 0x16, (1, 0): 0x17, (1, 1): 0x18}


def _irs(num_irs=KFULL, seconds=0.05, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * 44100)
    out = []
    for k in range(num_irs):
        env = np.exp(-np.arange(n - 11 * k, dtype=np.float32) / (0.4 * n))
        out.append(rng.standard_normal((2, n - 11 * k)).astype(np.float32)
                   * env * 0.3)
    return out


def _banks(irs):
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    return jbank, tbank


def _value_for(full, k=KFULL):
    """The smallest CC value the reference scaling maps to IR `full`."""
    return next(v for v in range(128) if v * k // 128 == full)


def _state(ws, cp):
    return (list(ws.slot_to_full), ws.misses, ws.hits, ws.starved,
            ws.deferred, cp.select.tolist(), cp.vsteps.tolist(), cp.blocks,
            cp.aux["ws_slot_to_full"].tolist(), cp.aux["ws_starved"].tolist())


def _close_banks(tbank, jbank, names=("rhs2", "spectra_rev2")):
    for name in names:
        want = np.asarray(getattr(jbank, name), np.float64)
        got = getattr(tbank, name).double().numpy()
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-6 * scale, name


@pytest.mark.parametrize("on_exhausted", ["defer", "raise"])
def test_residency_policy_matches_jax(on_exhausted):
    """One select script through both WorkingSetBanks: hits, misses into
    never-used slots, an exhaustion (parked under 'defer', raised under
    'raise'), an out-of-range clamp, evictions once slots age out, the
    starved intent re-issued by the between-blocks poll, and a
    _restore_residency from aux that re-pages two slots. Residency,
    counters, aux and the control state must agree after every step, and
    the device banks at the end."""
    irs = _irs()
    jbank, tbank = _banks(irs)
    parts = tbank.max_partitions(B)
    jeng = JaxFMajor(V, B, parts, max_predelay=64, num_irs=CAP,
                     mac_strategy="allk", backend="fft", fault_upload="td")
    teng = FMajorPartitionedConvolution(V, B, parts, max_predelay=64,
                                        num_irs=CAP, device="cpu")
    jsub, tsub = _banks(irs[:CAP])
    jcp = JaxControlPlane(V, KFULL, 64)
    tcp = ControlPlane(V, KFULL, 64, device="cpu")
    kwargs = dict(min_age_blocks=100, on_exhausted=on_exhausted)
    jws = JaxWorkingSet(jeng, jcp, jbank.ir,
                        jax_dp.prepare_fmajor_bank_device(jeng, jsub,
                                                          wire="f32"),
                        list(range(CAP)), **kwargs)
    tws = WorkingSetBank(teng, tcp, tbank.ir,
                         dp.prepare_fmajor_bank_device(teng, tsub),
                         list(range(CAP)), **kwargs)
    for (v, c), cc in CCS.items():
        jcp.set_mapping(v, c, JaxCCMapping(message=0xB0, select=cc))
        tcp.set_mapping(v, c, CCMapping(message=0xB0, select=cc))
    for cp in (jcp, tcp):
        cp.speed[:] = 6

    def cc(v, c, full):
        return ("cc", v, c, _value_for(full))

    script = [cc(0, 0, 0),              # resident: a hit
              cc(0, 0, 5),              # miss into never-used slot 1
              cc(0, 1, 6),              # miss into never-used slot 2
              cc(1, 0, 5),              # hit
              ("blocks", 5),
              ("set", 1, 1, 3),         # every slot protected: exhausted
              ("set", 0, 0, KFULL + 4),  # out of range: clamps to 6, a hit
              cc(1, 0, 6),              # hit; the slot of IR 5 goes idle
              ("blocks", 110),          # ages out; 'defer' re-issues 3
              ("set", 1, 1, 3),         # 'raise': now a victim exists
              ("blocks", 3),
              ("restore", [4, 6, 0]),   # re-pages two slots from aux
              ("set", 0, 1, 4)]         # a hit after the restore
    raised = []
    for op in script:
        for cp, ws, exc_type in ((jcp, jws, RuntimeError),
                                 (tcp, tws, WorkingSetExhausted)):
            try:
                if op[0] == "cc":
                    cp.apply_cc(op[1], op[2], 0xB0, CCS[op[1], op[2]], op[3])
                elif op[0] == "set":
                    cp.set_select(*op[1:])
                elif op[0] == "blocks":
                    for _ in range(op[1]):
                        cp.end_block()
                else:
                    cp.aux["ws_slot_to_full"] = np.asarray(op[1], np.int64)
                    cp.on_aux_restored()
            except exc_type as exc:
                raised.append((op, type(exc).__name__))
        assert _state(tws, tcp) == _state(jws, jcp), op
    if on_exhausted == "raise":
        assert raised == [(("set", 1, 1, 3), "WorkingSetExhausted")] * 2
        assert tws.starved == 0
    else:
        assert not raised and tws.starved == 1
    assert tws.misses >= 3 and tws.hits >= 3
    assert tws.slot_to_full == [4, 6, 0]
    _close_banks(tws.bank, jws.bank)


def _configure(model, jax_side):
    cp = model.control
    cp.wet[:] = 0.8
    cp.dry[:] = 0.1
    cp.speed[:] = 6
    cls = JaxCCMapping if jax_side else CCMapping
    for (v, c), cc in CCS.items():
        cp.set_mapping(v, c, cls(message=0xB0, select=cc))


def _events(pairs):
    return [(blk, "", bytes([0xB0, CCS[vc], _value_for(full)]))
            for blk, vc, full in pairs]


# misses, hits, an exhaustion parked under 'defer' and re-issued once a
# slot ages out of its 20-block protection (and out of its 70-block fade
# span), then quiet blocks for the fades to decay
SCRIPT = [(6, (0, 0), 5), (9, (0, 1), 6), (12, (1, 0), 5), (20, (1, 1), 3),
          (30, (1, 0), 6), (40, (0, 0), 6), (95, (0, 1), 2)]
BLOCKS = 150


def _run_pair(x, events, blocks_hook=None, **kwargs):
    """The same working-set session on both packages; returns (JAX sink
    data, port sink data, JAX working set, port working set)."""
    irs = _irs()
    jbank, tbank = _banks(irs)
    jm = JaxReverb(jbank, num_voices=V, block=B, max_predelay=64,
                   engine="fmajor", backend="fft", bank_prep="device",
                   fault_upload="td", bank_capacity=CAP, **kwargs)
    tm = ConvolutionReverb(tbank, num_voices=V, block=B, max_predelay=64,
                           bank_capacity=CAP, device="cpu", **kwargs)
    out = []
    for model, jax_side in ((jm, True), (tm, False)):
        model.working_set.min_age_blocks = 20
        _configure(model, jax_side)
        if blocks_hook is not None:
            model.control.block_hooks.append(
                getattr(model.working_set, blocks_hook))
        if jax_side:
            sink = JaxWavSink("/dev/null", keep_data=True)
            sess = model.session(JaxWavSource(x, V, B), sink, warmup=0)
            sess.run(model.init_state(), midi=JaxMidiSchedule(list(events)))
        else:
            sink = WavSink("/dev/null", keep_data=True)
            sess = model.session(WavSource(x, V, B), sink, warmup=0)
            sess.run(model.init_state(), midi=MidiSchedule(list(events)))
        model.working_set.close()
        out.append(sink.data)
    return out[0], out[1], jm, tm


def test_working_set_session_matches_jax():
    """ConvolutionReverb(bank_capacity=3) block for block against the JAX
    model: sync faults, hits, a starved select re-issued by the poll, the
    warmup on the session's pre_run_hooks, the bank published in place."""
    x = (np.random.default_rng(1).standard_normal((V, 2, B * BLOCKS))
         * 0.05).astype(np.float32)
    want, got, jm, tm = _run_pair(x, _events(SCRIPT))
    jws, tws = jm.working_set, tm.working_set
    assert got.shape == want.shape == (V, 2, B * BLOCKS)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).max() > 1e-2
    assert _state(tws, tm.control) == _state(jws, jm.control)
    assert tws.misses >= 3 and tws.hits >= 3 and tws.starved >= 1
    assert tws.warmups == jws.warmups == 1
    assert tm.spectra is tws.bank
    _close_banks(tws.bank, jws.bank)


def test_async_paging_with_drain_matches_jax():
    """async_paging=True with drain() after the poll at every block end, so
    each deferred select applies at a schedule-independent block: the port
    (its pager thread packing each slot apart from the live bank) against
    the JAX async run, block for block, every deferred select applied."""
    x = (np.random.default_rng(2).standard_normal((V, 2, B * BLOCKS))
         * 0.05).astype(np.float32)
    want, got, jm, tm = _run_pair(x, _events(SCRIPT), blocks_hook="drain",
                                  async_paging=True)
    jws, tws = jm.working_set, tm.working_set
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).max() > 1e-2
    assert _state(tws, tm.control) == _state(jws, jm.control)
    assert tws.deferred >= 2 and tws.misses >= 3
    assert not tws._pending and not tws._deferred_target
    assert tws._worker is None  # closed
    _close_banks(tws.bank, jws.bank)


def test_async_upload_failure_raises_from_poll_and_rolls_back():
    """A pager error is never swallowed: the next poll() raises it and the
    victim slot's residency claim is rolled back; a retry then pages the
    IR in."""
    irs = _irs()
    _, tbank = _banks(irs)
    model = ConvolutionReverb(tbank, num_voices=V, block=B, max_predelay=64,
                              bank_capacity=CAP, async_paging=True,
                              device="cpu")
    ws, cp = model.working_set, model.control
    boom = {5}

    def payload(k):
        if k in boom:
            raise RuntimeError("payload exploded")
        return tbank.ir(k)

    ws.slot_payload = payload
    try:
        cp.set_select(0, 0, 5)
        ws._pending_order[0]["ready"].wait(10)
        with pytest.raises(RuntimeError, match="payload exploded"):
            cp.end_block()
        assert 5 not in ws.full_to_slot and ws.slot_to_full == [0, 1, 2]
        assert int(cp.select[0, 0]) == 0 and not ws._deferred_target
        boom.clear()
        cp.set_select(0, 0, 5)
        ws.drain(timeout=10)
        assert ws.slot_to_full[int(cp.select[0, 0])] == 5
    finally:
        ws.close()


def test_warmup_failure_stops_the_session_before_block_0():
    """A fault path that cannot page slot 0 in fails the session's start,
    not its first real miss mid-stream."""
    _, tbank = _banks(_irs())
    model = ConvolutionReverb(tbank, num_voices=V, block=B, max_predelay=64,
                              bank_capacity=CAP, device="cpu")
    ws = model.working_set

    def payload(k):
        raise RuntimeError("payload exploded")

    ws.slot_payload = payload
    x = np.zeros((V, 2, B * 4), np.float32)
    sess = model.session(WavSource(x, V, B),
                         WavSink("/dev/null", keep_data=True), warmup=0)
    with pytest.raises(RuntimeError, match="payload exploded"):
        sess.run(model.init_state())
    assert ws.warmups == 0 and sess.blocks_streamed == 0


def test_working_set_equals_the_full_bank_session():
    """Misses and evictions (never a starved select, so 'raise' keeps it
    loud) are invisible to the audio: the port's 3-slot working set
    against the port's own 7-IR 'allk' session, same events."""
    x = (np.random.default_rng(3).standard_normal((V, 2, B * BLOCKS))
         * 0.05).astype(np.float32)
    events = _events([(6, (0, 0), 5), (10, (0, 1), 6), (20, (0, 0), 6),
                      (95, (1, 1), 4)])
    _, tbank = _banks(_irs())
    outs = []
    for capacity in (CAP, None):
        model = ConvolutionReverb(
            tbank, num_voices=V, block=B, max_predelay=64,
            bank_capacity=capacity, ws_exhausted="raise",
            mac_strategy="allk", device="cpu")
        _configure(model, jax_side=False)
        if capacity:
            model.working_set.min_age_blocks = 20
        sink = WavSink("/dev/null", keep_data=True)
        sess = model.session(WavSource(x, V, B), sink, warmup=0)
        sess.run(model.init_state(), midi=MidiSchedule(list(events)))
        outs.append((sink.data, model))
    (got, ws_model), (want, full_model) = outs
    assert ws_model.working_set.misses == 3  # the last one evicts
    assert full_model.working_set is None
    assert full_model.engine.num_irs == KFULL
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.abs(want).max() > 1e-2


def test_model_validates_like_jax():
    irs = _irs(4)
    _, tbank = _banks(irs)
    for kwargs in ({"mac_strategy": "nope"},
                   {"swap_snapshot": False, "mac_strategy": "selected"},
                   {"bank_capacity": 2, "ws_exhausted": "nope"}):
        with pytest.raises(ValueError):
            ConvolutionReverb(tbank, block=B, max_predelay=64,
                              device="cpu", **kwargs)
    # capacity above the bank size clamps to it, like the JAX model
    model = ConvolutionReverb(tbank, block=B, max_predelay=64,
                              bank_capacity=9, device="cpu")
    assert model.working_set.capacity == model.engine.num_irs == 4
    assert model.working_set.min_age_blocks == 1024 + 64
    assert model.engine.mac_strategy == "allk"


SETTINGS = """
conv.count 2
conv[0].fftSize 2048
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
conv[1].fftSize 2048
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
"""

# IR 4 (a miss into the never-used slot 2), then IR 2, which starves:
# every slot stays inside its fade protection for the whole file
MIDI = "4 B0 15 7F\n30 B0 15 40\n50 B0 18 50\n"


def test_cli_bank_capacity_matches_the_jax_cli_within_one_lsb(tmp_path,
                                                             capsys):
    from tpu_audio.app.main import main as jax_main
    from tpu_audio.io.index import write_index
    from tpu_audio.io.wav import write_wav
    from tpu_audio_torch.app.main import main as port_main

    rng = np.random.default_rng(0)
    paths = []
    for k in range(5):
        ir = rng.uniform(-0.3, 0.3, (150 + 30 * k, 2)).astype(np.float32)
        paths.append(str(tmp_path / f"ir{k}.wav"))
        write_wav(paths[-1], ir, 44100)
    write_index(tmp_path / "bank.index", paths)
    (tmp_path / "settings.txt").write_text(
        SETTINGS.format(index=tmp_path / "bank.index"))
    (tmp_path / "events.txt").write_text(MIDI)
    x = rng.uniform(-0.2, 0.2, (64 * 80, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    common = ["--settings", str(tmp_path / "settings.txt"),
              "--input", str(tmp_path / "in.wav"), "--midi",
              str(tmp_path / "events.txt"), "--block-size", "64", "--quiet",
              "--bank-capacity", "3", "--bank-prep", "device",
              "--fault-upload", "td"]
    assert jax_main(common + ["--output", str(tmp_path / "jax.wav")]) == 0
    capsys.readouterr()
    assert port_main(common + ["--output", str(tmp_path / "port.wav"),
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert ("working set: 3 slots | misses 1 | hits 3 | deferred 0 "
            "| starved 2") in out
    blob = {}
    for name in ("jax", "port"):
        raw = (tmp_path / f"{name}.wav").read_bytes()
        blob[name] = np.frombuffer(raw[raw.index(b"data") + 8:], "<i2")
    assert blob["port"].shape == blob["jax"].shape
    assert np.abs(blob["jax"]).max() > 1000
    assert int(np.abs(blob["port"].astype(np.int32) - blob["jax"]).max()) <= 1
