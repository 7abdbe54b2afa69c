"""Checkpoints and crash recovery in the port (tpu_audio_torch/runtime/
checkpoint.py, runtime/recovery.py and the session's checkpoint, stop and
resume hooks) against the port's own uninterrupted runs and against the JAX
package's.

A resume from a port checkpoint must equal the uninterrupted port run to
the bit: the same steps on the same inputs from the same state. Against the
JAX package (models built with backend="fft", bank_prep="device",
fault_upload="td" so both sides run an FFT on their device): control-plane
fields and aux to the bit, state fields within 2e-5 of their scale (2e-4
for ring mode's bf16 snapshot), resumed outputs within 2e-5 absolute.
"""

import os
import threading
import time
from dataclasses import fields, make_dataclass, replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.checkpoint import load_checkpoint as jax_load
from tpu_audio.runtime.recovery import run_resilient as jax_run_resilient
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine.cascade import (
    CascadeConvolution, cascade_state_from_numpy,
)
from tpu_audio_torch.engine.fmajor import (
    FMajorPartitionedConvolution, state_from_numpy,
)
from tpu_audio_torch.engine.params import CCMapping, ControlPlane
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.runtime.backends import WavSink, WavSource
from tpu_audio_torch.runtime.checkpoint import load_checkpoint, save_checkpoint
from tpu_audio_torch.runtime.recovery import run_resilient
from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

torch.set_num_threads(1)

SELECT_CC, WET_CC = 0x15, 0x18
N, C = 19, 10          # blocks per run; the checkpoint lands at block 10
ATOL = 2e-5
# geometry per kind: (voices, block, IRs, IR length)
GEOMETRY = {"fmajor": (2, 64, 2, 600), "cascade": (4, 32, 2, 1200),
            "working_set": (2, 64, 3, 600)}


def _irs(num_irs, ir_len, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num_irs):
        ir = rng.standard_normal((2, ir_len)).astype(np.float32)
        out.append(ir * (0.4 / np.abs(ir).max()))
    return out


def _geometry(kind):
    return GEOMETRY["cascade" if kind.startswith("cascade") else
                    "working_set" if kind == "working_set" else "fmajor"]


# the engines ported since the checkpoint path: the partitioned engine (coef
# and materialized), the monolithic engine (complex64 fields), a bf16 fmajor
# ring session and a 'selected' cascade
LATER_KINDS = ["partitioned_coef", "partitioned_materialized", "monolithic",
               "ring_bf16", "cascade_selected"]


def _configure(cp, cls):
    cp.wet[:] = 0.8
    cp.dry[:] = 0.2
    cp.speed[:] = 12          # a fade in flight from block 4 past block 10
    cp.predelay[:] = 40
    for v in range(cp.num_voices):
        for ch in range(2):
            cp.set_mapping(v, ch, cls(message=0xB0, select=SELECT_CC,
                                      wet=WET_CC))


def _events(kind):
    """A re-select at 4 (a miss into the working set), a wet change at 13
    (after the checkpoint: it must replay), and for the working set a
    re-select of a resident IR at 15 (a hit)."""
    k = _geometry(kind)[2]
    events = [(4, "", bytes([0xB0, SELECT_CC, (k - 1) * 128 // k + 1])),
              (13, "", bytes([0xB0, WET_CC, 32]))]
    if kind == "working_set":
        events.append((15, "", bytes([0xB0, SELECT_CC, 0])))
    return events


class _Roll:
    """Roll mode with a materialized snapshot: 'selected' fades run the
    materializing collapse and the general step (roll mode has no model
    flag, so the engine is driven as chip_smoke.py drives it)."""

    working_set = None
    device = torch.device("cpu")

    def __init__(self):
        v, b, k, n = GEOMETRY["fmajor"]
        bank = IRBank()
        for ir in _irs(k, n):
            bank.append(ir)
        self.engine = FMajorPartitionedConvolution(
            v, b, bank.max_partitions(b), max_predelay=64, ring=False,
            mac_strategy="selected", num_irs=k, device="cpu")
        self.spectra = self.engine.prepare_bank(bank.partitioned_spectra(b))
        self.control = ControlPlane(v, k, 64, device="cpu")

    def init_state(self):
        return self.engine.init_converged(self.spectra,
                                          self.control.snapshot_device())

    def session(self, source, sink, **kwargs):
        return StreamSession(self.engine, self.spectra, self.control, source,
                             sink, **kwargs)


def _model(kind, jax_side=False):
    if kind == "roll":
        model = _Roll()
        _configure(model.control, CCMapping)
        return model
    v, b, k, n = _geometry(kind)
    bank = JaxIRBank() if jax_side else IRBank()
    for ir in _irs(k, n):
        bank.append(ir)
    kwargs = {"num_voices": v, "block": b, "max_predelay": 64}
    if kind.startswith("cascade"):
        kwargs.update(engine="cascade", cascade_ratio=4)
        if kind == "cascade_selected":
            kwargs["mac_strategy"] = "selected"
        else:
            kwargs["predelay_side"] = kind.split("_")[1]
    if kind.startswith("partitioned"):
        kwargs.update(engine="partitioned", variant=kind.split("_")[1])
    if kind == "monolithic":
        kwargs.update(engine="monolithic", fft_size=2048)
    if kind == "ring_bf16":
        kwargs["mac_dtype"] = "bf16"
    if kind == "ring_span":
        kwargs["swap_snapshot"] = False
    if kind == "working_set":
        kwargs["bank_capacity"] = 2
        if jax_side:
            kwargs["fault_upload"] = "td"
    if jax_side:
        model = JaxReverb(bank, backend="fft", bank_prep="device", **kwargs)
    else:
        model = ConvolutionReverb(bank, device="cpu", **kwargs)
    _configure(model.control, JaxCCMapping if jax_side else CCMapping)
    return model


def _input(kind, blocks=N, seed=1):
    v, b, _, _ = _geometry(kind)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((v, 2, blocks * b)) * 0.05).astype(np.float32)


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


def _run(model, kind, x, jax_side=False, path=None, every=None, state=None,
         start=0):
    """Stream `x` from block `start` (a seeked source, a rewound schedule)
    with an optional checkpoint every `every` blocks; returns (sink data,
    session, final state)."""
    v, b, _, _ = _geometry(kind)
    src_cls, midi_cls = ((JaxWavSource, JaxMidiSchedule) if jax_side
                         else (WavSource, MidiSchedule))
    source = src_cls(x, v, b)
    source.seek(start)
    midi = midi_cls(_events(kind))
    midi.rewind_to(start)
    sink = _KeepSink()
    session = model.session(source, sink, warmup=0)
    state = model.init_state() if state is None else state
    state = session.run(state, midi=midi, checkpoint_path=path,
                        checkpoint_every=every, start_block=start)
    return sink.data, session, state


def _arrays(path):
    with np.load(path) as data:
        return {name: data[name] for name in data.files}


# -- resuming from a port checkpoint --------------------------------------------------


@pytest.mark.parametrize("kind", ["ring", "ring_span", "roll",
                                  "cascade_write", "cascade_read",
                                  *LATER_KINDS])
def test_resume_from_a_port_checkpoint_is_bit_exact(tmp_path, kind):
    """Checkpoint at block 10, mid-fade (and, for the cascade, mid-cycle of
    its ratio-4 tail), then resume in a fresh model: the resumed blocks
    equal the uninterrupted run's to the bit, the wet change at 13 included.
    A load saved again writes the same arrays (bf16 and the host counter
    carried bit for bit)."""
    path = tmp_path / "ckpt"
    x = _input(kind)
    want, session, _ = _run(_model(kind), kind, x, path=path, every=C)
    assert [s["block_index"] for s in session.checkpoint_saves] == [C]

    model = _model(kind)
    state, meta = load_checkpoint(path, model.engine.init_state(),
                                  model.control)
    assert meta == {"block_index": C}
    assert (model.control.vsteps > 0).any(), "the checkpoint must land " \
        "mid-fade"
    if model.engine.fade_protocol != "slew":
        # (the slew engines' fades live in their spectra)
        assert (state.coef_a.numpy() > 1e-3).any()
    if kind in ("roll", "cascade_selected"):
        assert not bool(state.base_pure.any())   # a materialized snapshot
    if kind in ("ring", "ring_bf16"):
        assert state.base.dtype == torch.bfloat16
    if kind == "ring_bf16":
        assert state.fdl.dtype == torch.bfloat16
    if kind == "cascade_selected":
        assert state.sel_tail.numel() > 1 and state.base_tail.abs().max() > 0
    if kind.startswith(("partitioned", "monolithic")):
        assert state.fdl.dtype == torch.complex64 if kind.startswith(
            "partitioned") else state.active.dtype == torch.complex64
    if kind.startswith("cascade"):
        assert state.step == int(state.t) == C and C % 4
    save_checkpoint(tmp_path / "again", state, model.control,
                    meta={"block_index": C})
    first, again = _arrays(path), _arrays(tmp_path / "again")
    assert first.keys() == again.keys()
    for name in first:
        np.testing.assert_array_equal(again[name], first[name], name)

    got, resumed, _ = _run(model, kind, x, state=state, start=C)
    assert resumed.blocks_streamed == N - C
    np.testing.assert_array_equal(got, want[..., C * _geometry(kind)[1]:])


@pytest.mark.parametrize("kind", LATER_KINDS)
def test_run_resilient_recovers_to_the_bit(tmp_path, kind):
    """run_resilient over the later engines: a checkpoint every 10 blocks,
    the sink failing when block 12 is delivered (resumed from 10, mid-fade,
    the wet change at 13 replayed): the delivered stream equals the
    uninterrupted run to the bit."""
    x = _input(kind)
    want, _, _ = _run(_model(kind), kind, x)
    v, b, _, _ = _geometry(kind)
    sink = _CrashOnce(12)
    _, summary = run_resilient(lambda: _model(kind), WavSource(x, v, b), sink,
                               tmp_path / "r.ckpt", checkpoint_every=C,
                               midi=MidiSchedule(_events(kind)),
                               session_kwargs=dict(warmup=0))
    assert summary["restarts"] == 1
    assert summary["recoveries"][0]["resume_block"] == C
    np.testing.assert_array_equal(np.concatenate(sink.blocks, axis=-1), want)


# -- against the JAX package's checkpoint ---------------------------------------------


def _carry(model, jax_state):
    """A JAX state carried over to the port (the converters of
    engine/fmajor.py and engine/cascade.py)."""
    leaves = {f.name: np.asarray(getattr(jax_state, f.name))
              for f in fields(jax_state)}
    if isinstance(model.engine, CascadeConvolution):
        return cascade_state_from_numpy(model.engine, leaves)
    return state_from_numpy(device="cpu", **leaves)


@pytest.mark.parametrize("kind", ["ring", "cascade_write", "working_set"])
def test_checkpoint_matches_the_jax_checkpoint(tmp_path, kind):
    x = _input(kind)
    jpath, tpath = tmp_path / "jax.ckpt", tmp_path / "port.ckpt"
    jm, tm = _model(kind, jax_side=True), _model(kind)
    _run(jm, kind, x, jax_side=True, path=jpath, every=C)
    _run(tm, kind, x, path=tpath, every=C)
    if kind == "working_set":
        assert tm.working_set.misses == jm.working_set.misses == 1
        tm.working_set.close()
        jm.working_set.close()

    jarr, tarr = _arrays(jpath), _arrays(tpath)
    cp_keys = sorted(k for k in jarr if k.startswith(("cp_", "aux_")))
    assert cp_keys == sorted(k for k in tarr if k.startswith(("cp_", "aux_")))
    if kind == "working_set":
        assert "aux_ws_slot_to_full" in cp_keys
        np.testing.assert_array_equal(tarr["aux_ws_slot_to_full"], [0, 2])
    for key in cp_keys:
        np.testing.assert_array_equal(tarr[key], jarr[key], key)
        assert tarr[key].dtype == jarr[key].dtype, key

    jm2, tm2 = _model(kind, jax_side=True), _model(kind)
    jstate, jmeta = jax_load(jpath, jm2.engine.init_state(), jm2.control)
    tstate, tmeta = load_checkpoint(tpath, tm2.engine.init_state(),
                                    tm2.control)
    assert jmeta == tmeta == {"block_index": C}
    carried = _carry(tm2, jstate)
    for f in fields(tstate):
        got, want = getattr(tstate, f.name), getattr(carried, f.name)
        if not isinstance(got, torch.Tensor):
            assert got == want, f.name
            continue
        if got.dtype in (torch.bool, torch.int32):
            assert torch.equal(got, want), f.name
            continue
        rel = 2e-4 if got.dtype == torch.bfloat16 else 2e-5
        got, want = got.double(), want.double()
        scale = max(float(want.abs().max()), 1e-9)
        err = float((got - want).abs().max())
        assert err <= rel * scale, f"{f.name}: {err:.3e} vs {scale:.3e}"

    jgot, _, _ = _run(jm2, kind, x, jax_side=True, state=jstate, start=C)
    tgot, _, _ = _run(tm2, kind, x, state=tstate, start=C)
    assert np.abs(jgot).max() > 0.05
    np.testing.assert_allclose(tgot, jgot, atol=ATOL)
    for m in (jm2, tm2):
        if m.working_set is not None:
            m.working_set.close()


# -- run_resilient --------------------------------------------------------------------


class _CrashOnce:
    """Raises once, when the block at index `fail_at` is written."""

    def __init__(self, fail_at):
        self.blocks = []
        self.fail_at = fail_at
        self.failed = False

    def write(self, block):
        if not self.failed and len(self.blocks) == self.fail_at:
            self.failed = True
            raise RuntimeError("simulated poisoned readback")
        self.blocks.append(np.asarray(block).copy())

    def close(self):
        pass


def _resilient_pair(jax_side):
    """The JAX package's recovery test (tests/test_runtime.py:444) on
    either package: 2 voices, 2 IRs of 128 samples, 16 blocks, a checkpoint
    every 4 blocks, a wet change at 6 and a crash when block 7 is
    delivered."""
    rng = np.random.default_rng(21)
    irs = []
    for _ in range(2):
        ir = rng.standard_normal((2, 128)).astype(np.float32)
        irs.append(ir * (0.5 / np.abs(ir).max()))
    x = (np.random.default_rng(22).standard_normal((2, 2, 64 * 16)) * 0.05
         ).astype(np.float32)

    def build():
        bank = JaxIRBank() if jax_side else IRBank()
        for ir in irs:
            bank.append(ir)
        if jax_side:
            m = JaxReverb(bank, num_voices=2, block=64, max_predelay=128,
                          backend="fft")
            m.control.set_mapping(0, 0, JaxCCMapping(message=0xB0, wet=0x18))
        else:
            m = ConvolutionReverb(bank, num_voices=2, block=64,
                                  max_predelay=128, device="cpu")
            m.control.set_mapping(0, 0, CCMapping(message=0xB0, wet=0x18))
        m.control.wet[:] = 0.9
        m.control.dry[:] = 0.1
        return m

    def midi():
        cls = JaxMidiSchedule if jax_side else MidiSchedule
        return cls([(6, "", bytes([0xB0, 0x18, 32]))])

    return build, x, midi


def test_resilient_session_recovers_mid_stream(tmp_path):
    """A failure mid-stream rebuilds the model, restores the checkpoint at
    block 4, replays the wet change at 6 and delivers a gap-free,
    duplicate-free stream: equal to the port's uninterrupted run to the bit
    and to the JAX package's run_resilient within 2e-5."""
    outs = {}
    for jax_side in (True, False):
        build, x, midi = _resilient_pair(jax_side)
        builds = []

        def counting_build(build=build):
            builds.append(1)
            return build()

        src_cls = JaxWavSource if jax_side else WavSource
        fn = jax_run_resilient if jax_side else run_resilient
        sink = _CrashOnce(7)
        path = tmp_path / f"resume_{jax_side}.ckpt"
        _, summary = fn(counting_build, src_cls(x, 2, 64), sink, path,
                        checkpoint_every=4, midi=midi(),
                        session_kwargs=dict(warmup=0))
        assert path.exists()          # no silent .npz rename
        assert summary["restarts"] == 1 and len(builds) == 2
        assert summary["blocks_delivered"] == 16
        outs[jax_side] = np.concatenate(sink.blocks, axis=-1)
        if not jax_side:
            (rec,) = summary["recoveries"]
            assert rec["resume_block"] == 4 and rec["delivered"] == 7
            # the failure hits the drain before the save at 8
            assert [s["block_index"] for s in summary["checkpoint_saves"]] \
                == [4, 8, 12, 16]
    build, x, midi = _resilient_pair(False)
    sink = WavSink("/dev/null", keep_data=True)
    build().process(WavSource(x, 2, 64), sink, midi=midi(), warmup=0)
    np.testing.assert_array_equal(outs[False], sink.data)
    np.testing.assert_allclose(outs[False], outs[True], atol=ATOL)


def test_resilient_session_gives_up_after_max_restarts(tmp_path):
    class AlwaysFailSink:
        def write(self, block):
            raise RuntimeError("dead transport")

        def close(self):
            pass

    build, x, _ = _resilient_pair(False)
    builds = []

    def counting_build():
        builds.append(1)
        return build()

    with pytest.raises(RuntimeError, match="dead transport"):
        run_resilient(counting_build, WavSource(x[..., :64 * 4], 2, 64),
                      AlwaysFailSink(), tmp_path / "r.npz",
                      checkpoint_every=2, max_restarts=2,
                      session_kwargs=dict(warmup=0))
    assert len(builds) == 3


def test_resilient_session_live_source_continues_with_gap(tmp_path):
    """An unseekable (live) source: the session restarts from the last
    checkpoint's state, the input consumed but undelivered at the failure
    is gone, and streaming continues to the end of the feed."""

    class LiveishSource:  # no seek()
        def __init__(self, n):
            self.n = n
            self.i = 0
            self.rng = np.random.default_rng(31)

        def read(self):
            if self.i >= self.n:
                return None
            self.i += 1
            return (self.rng.standard_normal((2, 2, 64)) * 0.05
                    ).astype(np.float32)

    build, _, _ = _resilient_pair(False)
    sink = _CrashOnce(6)
    src = LiveishSource(20)
    _, summary = run_resilient(build, src, sink, tmp_path / "live.ckpt",
                               checkpoint_every=4,
                               session_kwargs=dict(warmup=0))
    assert summary["restarts"] == 1
    assert src.i == 20
    # blocks 6 (failed to deliver) and 7 (stepped, never delivered) are
    # lost; blocks 8-19 flow after the restart
    assert summary["blocks_delivered"] == len(sink.blocks) == 18
    assert summary["recoveries"][0]["resume_block"] == 4
    assert np.isfinite(np.concatenate(sink.blocks, axis=-1)).all()


# -- named keys -----------------------------------------------------------------------


def _with_extra_field(state):
    """The same state as an instance of a class of the same name with one
    field more (a state leaf added in a later version)."""
    cls = make_dataclass(type(state).__name__,
                         [(f.name, f.type) for f in fields(state)]
                         + [("new_leaf", torch.Tensor)])
    return cls(**{f.name: getattr(state, f.name) for f in fields(state)},
               new_leaf=torch.zeros(3))


@pytest.mark.parametrize("case", ["missing", "extra", "reshaped", "class",
                                  "voices"])
def test_load_names_the_mismatch(tmp_path, case):
    model = _model("ring")
    state = model.init_state()
    path = tmp_path / "ckpt"
    saved = _with_extra_field(state) if case == "extra" else state
    save_checkpoint(path, saved, model.control)
    template, control = model.engine.init_state(), model.control
    if case == "missing":
        template, match = _with_extra_field(template), "lacks.*new_leaf"
    elif case == "extra":
        match = "new_leaf.*FMajorState does not"
    elif case == "reshaped":
        template = replace(template, fdl=template.fdl[..., :-8])
        match = r"field fdl: checkpoint shape .* != engine shape"
    elif case == "class":
        template = _model("cascade_write").engine.init_state()
        match = "holds a FMajorState.*CascadeState"
    else:
        control = ControlPlane(3, 2, 64, device="cpu")
        match = "for 2 voices, control plane has 3"
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path, template, control)


def test_save_keeps_its_name_and_leaves_no_tmp(tmp_path, monkeypatch):
    model = _model("ring")
    path = tmp_path / "session.ckpt"
    figures = save_checkpoint(path, model.init_state(), model.control)
    assert os.listdir(tmp_path) == ["session.ckpt"]
    assert figures["bytes"] > 0 and figures["d2h_s"] >= 0

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(path, model.init_state(), model.control)
    assert os.listdir(tmp_path) == ["session.ckpt"]   # the old one survives


# -- the working set ------------------------------------------------------------------


def test_working_set_residency_replays_from_aux(tmp_path):
    """The miss at block 4 pages IR 2 into slot 1 before the checkpoint; a
    fresh model restores the residency map through aux (re-paging slot 1)
    and replays the hit at 15 like the uninterrupted run, to the bit."""
    path = tmp_path / "ws.ckpt"
    x = _input("working_set")
    model = _model("working_set")
    want, _, _ = _run(model, "working_set", x, path=path, every=C)
    assert model.working_set.slot_to_full == [0, 2]
    # one miss and three hits (4 voice channels) at 4, four hits at 15
    assert (model.working_set.misses, model.working_set.hits) == (1, 7)
    model.working_set.close()

    fresh = _model("working_set")
    assert fresh.working_set.slot_to_full == [0, 1]
    state, _ = load_checkpoint(path, fresh.engine.init_state(), fresh.control)
    assert fresh.working_set.slot_to_full == [0, 2]
    got, _, _ = _run(fresh, "working_set", x, state=state, start=C)
    fresh.working_set.close()
    np.testing.assert_array_equal(got, want[..., C * 64:])


def test_async_pager_is_drained_before_a_save(tmp_path):
    """A select that misses at block 9 is deferred to the pager thread; the
    save after block 9 drains it first, so the checkpoint holds the IR
    resident and the select applied."""
    bank = IRBank()
    for ir in _irs(3, 600):
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=2, block=64, max_predelay=64,
                              bank_capacity=2, async_paging=True,
                              device="cpu")
    _configure(model.control, CCMapping)
    sink = WavSink("/dev/null", keep_data=True)
    session = model.session(WavSource(_input("working_set"), 2, 64), sink)
    drains = []
    model.control.pre_checkpoint_hooks.insert(0, lambda: drains.append(
        len(model.working_set._pending_order)))
    session.run(model.init_state(), max_blocks=C,
                midi=MidiSchedule([(9, "", bytes([0xB0, SELECT_CC, 127]))]),
                checkpoint_path=tmp_path / "a.ckpt", checkpoint_every=C)
    model.working_set.close()
    assert model.working_set.deferred >= 1
    arrays = _arrays(tmp_path / "a.ckpt")
    np.testing.assert_array_equal(arrays["aux_ws_slot_to_full"], [0, 2])
    np.testing.assert_array_equal(arrays["cp_select"], 1)
    assert len(drains) == 1


# -- the session's hooks --------------------------------------------------------------


def test_saves_land_every_interval_with_the_block_index(tmp_path):
    model = _model("ring")
    x = _input("ring", blocks=11)
    session = model.session(WavSource(x, 2, 64),
                            WavSink("/dev/null", keep_data=True))
    session.run(model.init_state(), checkpoint_path=tmp_path / "i.ckpt",
                checkpoint_every=4, start_block=5)
    saves = session.checkpoint_saves
    assert [s["block_index"] for s in saves] == [9, 13]
    assert all(s["block_s"] >= s["d2h_s"] + s["write_s"] for s in saves)
    _, meta = load_checkpoint(tmp_path / "i.ckpt",
                              model.engine.init_state(), model.control)
    assert meta == {"block_index": 13}


def test_stop_from_another_thread_ends_the_run():
    model = _model("ring")

    class Endless:
        def __init__(self):
            self.i = 0

        def read(self):
            self.i += 1
            return np.zeros((2, 2, 64), np.float32)

    src = Endless()
    sink = WavSink("/dev/null", keep_data=True)
    session = model.session(src, sink, warmup=0)
    missed = []
    session.on_missed_deadline = lambda block, s: missed.append(block)

    def stopper():
        while src.i < 12:
            time.sleep(0.001)
        session.stop()

    t = threading.Thread(target=stopper, daemon=True)
    t.start()
    session.run(model.init_state(), max_blocks=None)
    t.join(timeout=10)
    assert not t.is_alive()
    assert 12 <= session.blocks_streamed <= 40
    assert sink.data.shape[-1] == 64 * session.blocks_streamed
    assert not session._stop_requested   # consumed: the next run streams
    session.source = SimpleNamespace(read=lambda: None)
    session.run(model.init_state())
