"""The host link in the port against the JAX package's: batched output
fetches and the pcm16 output wire (StreamSession fetch_batch / wire), the
exact pcm16 upload of time-domain IRs (device_prep.upload_bank_td), host
bank prep with its packed-bank disk caches (bank_prep="host", the `pack_*`
and `cascpack_*` entries), and the 'dual' and 'derived' fault payloads of
the fmajor working set, with the model's and the CLI's rules for them.

Tolerances: where only the transport or the payload's layout differs, the
port is held to itself bit for bit; host-prepped banks and slot updates
are held to the JAX package's bit for bit (the same numpy spectra and
packs, axis moves and one negation on the device); sessions against the
JAX package's within 2e-5 absolute (both f32, different FFTs and summation
orders), and within 1.01 / 32767 on the pcm16 wire (one step of the 16-bit
grid plus rounding); the CLIs' 16-bit WAVs within 1 LSB.
"""

import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import device_prep as jax_dp
from tpu_audio.engine.cascade import CascadeConvolution as JaxCascade
from tpu_audio.engine.fmajor import (
    FMajorPartitionedConvolution as JaxFMajor,
)
from tpu_audio.engine.params import CCMapping as JaxCCMapping
from tpu_audio.models.reverb import ConvolutionReverb as JaxReverb
from tpu_audio.runtime.backends import WavSink as JaxWavSink
from tpu_audio.runtime.backends import WavSource as JaxWavSource
from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine.cascade import (
    CascadeConvolution, cascade_bank_from_numpy,
)
from tpu_audio_torch.engine.fmajor import (
    FMajorPartitionedConvolution, bank_from_numpy,
)
from tpu_audio_torch.engine.params import CCMapping
from tpu_audio_torch.models.reverb import ConvolutionReverb
from tpu_audio_torch.parallel.mesh import make_mesh
from tpu_audio_torch.runtime import stream
from tpu_audio_torch.runtime.backends import CallbackSink, WavSink, WavSource
from tpu_audio_torch.runtime.checkpoint import load_checkpoint
from tpu_audio_torch.runtime.stream import MidiSchedule

torch.set_num_threads(1)

B, V, MAXPD = 32, 2, 64
ATOL = 2e-5
LSB = 1.01 / 32767.0
SELECT_CC = 0x15


def _irs(num_irs=3, n=300, seed=0, grid=False):
    """Decaying noise IRs; `grid` puts every sample on the 16-bit WAV grid
    (q / 65536), as an IR read from a 16-bit WAV is."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(num_irs):
        m = n - 17 * k
        ir = (rng.uniform(-0.3, 0.3, (2, m))
              * np.exp(-np.arange(m) / (0.4 * n))).astype(np.float32)
        if grid:
            ir = (np.round(ir * 65536.0) / 65536.0).astype(np.float32)
        out.append(ir)
    return out


def _banks(irs):
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    return jbank, tbank


def _configure(model, jax_side):
    cp = model.control
    cp.wet[:] = 0.8
    cp.dry[:] = 0.1
    cp.speed[:] = 6
    cls = JaxCCMapping if jax_side else CCMapping
    for v in range(cp.num_voices):
        for c in range(2):
            cp.set_mapping(v, c, cls(message=0xB0, select=SELECT_CC))


def _pair(irs, voices=V, **kwargs):
    """The same model in both packages (the JAX one on its FFT backend and
    device prep unless `kwargs` say otherwise), configured alike."""
    jbank, tbank = _banks(irs)
    jkw = {"backend": "fft", "bank_prep": "device", **kwargs}
    jm = JaxReverb(jbank, num_voices=voices, block=B, max_predelay=MAXPD,
                   **jkw)
    tm = ConvolutionReverb(tbank, num_voices=voices, block=B,
                           max_predelay=MAXPD, device="cpu", **kwargs)
    _configure(jm, True)
    _configure(tm, False)
    return jm, tm


def _input(blocks, voices=V, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((voices, 2, B * blocks)) * 0.05
            ).astype(np.float32)


def _events(*pairs):
    return [(blk, "", bytes([0xB0, SELECT_CC, value])) for blk, value in pairs]


def _run(model, x, jax_side, events=(), **session_kwargs):
    """One session of `model` over `x`; returns (sink data, session)."""
    voices = x.shape[0]
    if jax_side:
        sink = JaxWavSink("/dev/null", keep_data=True)
        sess = model.session(JaxWavSource(x, voices, B), sink, warmup=0,
                             **session_kwargs)
        sess.run(model.init_state(), midi=JaxMidiSchedule(list(events)))
    else:
        sink = WavSink("/dev/null", keep_data=True)
        sess = model.session(WavSource(x, voices, B), sink, warmup=0,
                             **session_kwargs)
        sess.run(model.init_state(), midi=MidiSchedule(list(events)))
    return sink.data, sess


# -- batched fetches and the pcm16 wire ------------------------------------------


@pytest.mark.parametrize("fetch,engine", [(4, "fmajor"), (5, "fmajor"),
                                          (4, "cascade")])
def test_fetch_batch_matches_per_block_and_jax(fetch, engine):
    """14 blocks (a partial last batch) with a select inside a batch: the
    port's batched session delivers the per-block session's audio bit for
    bit and the JAX batched session's within 2e-5, and both time the same
    blocks (pace recorded per batch from the second delivery on)."""
    x = _input(14)
    events = _events((5, 100))
    jm, tm = _pair(_irs(), engine=engine)
    want, _ = _run(tm, x, False, events)
    _, tm2 = _pair(_irs(), engine=engine)
    got, sess = _run(tm2, x, False, events, fetch_batch=fetch)
    jgot, jsess = _run(jm, x, True, events, fetch_batch=fetch)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, jgot, atol=ATOL)
    assert sess.blocks_streamed == jsess.summary()["blocks_streamed"] == 14
    assert sess.summary()["blocks"] == jsess.summary()["blocks"] > 0
    assert tm2.control.select.tolist() == jm.control.select.tolist()


@pytest.mark.parametrize("engine,variant", [("partitioned", "coef"),
                                            ("partitioned", "materialized"),
                                            ("monolithic", "coef")])
def test_fetch_batch_is_bit_identical_on_the_reference_engines(engine,
                                                                variant):
    """The batch copies each output as it comes, so no engine's step output
    can reach the sink changed by a later step: the partitioned ('coef'
    and the slewing 'materialized') and monolithic engines, batched against
    per block."""
    x = _input(11)
    outs = []
    for kwargs in ({}, {"fetch_batch": 3}):
        _, tbank = _banks(_irs())
        model = ConvolutionReverb(tbank, num_voices=V, block=B,
                                  max_predelay=MAXPD, engine=engine,
                                  variant=variant, fft_size=1024,
                                  device="cpu")
        _configure(model, False)
        outs.append(_run(model, x, False, _events((4, 90)), **kwargs)[0])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert np.abs(outs[0]).max() > 1e-2


def test_pcm16_wire_matches_f32_and_jax_within_one_step():
    x = _input(13)
    events = _events((3, 100))
    jm, tm = _pair(_irs())
    want, _ = _run(tm, x, False, events)
    _, tm2 = _pair(_irs())
    got, _ = _run(tm2, x, False, events, fetch_batch=4, wire="pcm16")
    jgot, _ = _run(jm, x, True, events, fetch_batch=4, wire="pcm16")
    grid = got * 32767.0
    np.testing.assert_array_equal(grid, np.round(grid))
    np.testing.assert_allclose(got, want, atol=LSB)
    np.testing.assert_allclose(got, jgot, atol=LSB)
    assert np.abs(want).max() > 1e-2


def test_exclusions_raise_like_jax():
    jm, tm = _pair(_irs())
    x = _input(2)
    for kwargs in ({"chunk_blocks": 2, "fetch_batch": 2},
                   {"wire": "pcm16"}, {"fetch_batch": 2, "wire": "nope"}):
        with pytest.raises(ValueError) as jexc:
            jm.session(JaxWavSource(x, V, B), JaxWavSink("/dev/null"),
                       **kwargs)
        with pytest.raises(ValueError) as texc:
            tm.session(WavSource(x, V, B), CallbackSink(lambda b: None),
                       **kwargs)
        assert str(texc.value) == str(jexc.value)


def test_checkpoint_inside_a_batch_resumes_to_the_uninterrupted_output(
        tmp_path, monkeypatch):
    """Checkpoints every 6 blocks with batches of 4: each save comes after
    every block it covers reached the sink (the partial batch flushed
    first). A run stopped at block 14 resumes from block 12's checkpoint
    (mid-fade) and, joined to the first run's first 12 blocks, equals the
    uninterrupted per-block run bit for bit."""
    x = _input(30)
    events = _events((9, 100))
    _, tm = _pair(_irs())
    want, _ = _run(tm, x, False, events)

    delivered, saved_at = [], []
    save = stream.save_checkpoint

    def spy(path, state, control, meta):
        saved_at.append((meta["block_index"], len(delivered)))
        return save(path, state, control, meta=meta)

    monkeypatch.setattr(stream, "save_checkpoint", spy)
    path = tmp_path / "ck.npz"
    _, tm = _pair(_irs())
    sess = tm.session(WavSource(x, V, B), CallbackSink(delivered.append),
                      warmup=0, fetch_batch=4)
    sess.run(tm.init_state(), max_blocks=14, midi=MidiSchedule(events),
             checkpoint_path=path, checkpoint_every=6)
    assert saved_at == [(6, 6), (12, 12)]
    assert len(delivered) == 14

    _, tm = _pair(_irs())
    state, meta = load_checkpoint(path, tm.init_state(), tm.control)
    start = meta["block_index"]
    midi = MidiSchedule(events)
    midi.rewind_to(start)
    rest = []
    sess = tm.session(WavSource(x[..., start * B:], V, B),
                      CallbackSink(rest.append), warmup=0, fetch_batch=4)
    sess.run(state, midi=midi, start_block=start)
    got = np.concatenate(delivered[:start] + rest, axis=-1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wire", ["f32", "pcm16"])
def test_mesh_batches_equal_one_device(wire):
    """Virtual CPU shards (voice=2): each voice row's batch is stacked and
    fetched on its own; the joined blocks equal one device's bit for
    bit."""
    x = _input(13, voices=4)
    events = _events((4, 100))
    outs = []
    for mesh in (None, make_mesh(devices=["cpu"] * 2)):
        _, tm = _pair(_irs(), voices=4)
        outs.append(_run(tm, x, False, events, mesh=mesh, fetch_batch=4,
                         wire=wire)[0])
    np.testing.assert_array_equal(outs[1], outs[0])
    assert np.abs(outs[0]).max() > 1e-2


# -- the exact pcm16 IR upload --------------------------------------------------


def test_upload_bank_td_picks_the_wire_jax_picks():
    """On the 1/65536 grid 'auto' takes int16 and decodes bit for bit; off
    the grid it takes f32; a forced pcm16 wire off the grid raises with
    JAX's words; both packages agree on every case."""
    for grid in (True, False):
        td = dp.bank_time_domain(_banks(_irs(grid=grid))[1])
        jq, tq = jax_dp.encode_pcm16_exact(td), dp.encode_pcm16_exact(td)
        assert (jq is None) == (tq is None) == (not grid)
        if grid:
            np.testing.assert_array_equal(tq, jq)
        for wire in ("auto", "f32"):
            jdev, jused = jax_dp.upload_bank_td(td, wire)
            tdev, tused = dp.upload_bank_td(td, wire)
            assert tused == jused == ("pcm16" if grid and wire == "auto"
                                      else "f32")
            assert tdev.dtype == torch.float32
            np.testing.assert_array_equal(tdev.numpy().view(np.int32),
                                          np.asarray(jdev).view(np.int32))
            np.testing.assert_array_equal(tdev.numpy(), td)
        if not grid:
            with pytest.raises(ValueError) as jexc:
                jax_dp.upload_bank_td(td, "pcm16")
            with pytest.raises(ValueError) as texc:
                dp.upload_bank_td(td, "pcm16")
            assert str(texc.value) == str(jexc.value)
    with pytest.raises(ValueError, match="unknown td wire"):
        dp.upload_bank_td(td, "nope")


def test_device_prep_over_pcm16_equals_f32():
    _, tbank = _banks(_irs(grid=True))
    parts = tbank.max_partitions(B)
    banks = [dp.prepare_fmajor_bank_device(
        FMajorPartitionedConvolution(V, B, parts, max_predelay=MAXPD,
                                     device="cpu"), tbank, wire=wire)
        for wire in ("pcm16", "f32")]
    for name in ("rhs2", "spectra_rev2"):
        assert torch.equal(getattr(banks[0], name), getattr(banks[1], name))


# -- host bank prep and its packed-bank caches ------------------------------------


def _fmajor_pair(num_irs, **kwargs):
    irs = _irs(num_irs)
    jbank, tbank = _banks(irs)
    parts = tbank.max_partitions(B)
    jeng = JaxFMajor(V, B, parts, max_predelay=MAXPD, num_irs=num_irs,
                     backend="fft", **kwargs)
    teng = FMajorPartitionedConvolution(V, B, parts, max_predelay=MAXPD,
                                        num_irs=num_irs, device="cpu",
                                        **kwargs)
    jspec = jbank.partitioned_spectra(B)
    tspec = tbank.partitioned_spectra(B)
    np.testing.assert_array_equal(tspec, jspec)
    return jeng, teng, tspec


def _assert_fmajor_banks_equal(tbank, jbank):
    carried = bank_from_numpy(device="cpu", **{
        name: np.asarray(getattr(jbank, name))
        for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2")})
    for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"):
        got, want = getattr(tbank, name), getattr(carried, name)
        assert got.dtype == want.dtype and torch.equal(got, want), name


@pytest.mark.parametrize("ring,strategy,dtype", [
    (True, "allk", "f32"), (True, "selected", "f32"), (False, "allk", "f32"),
    (False, "selected", "f32"), (True, "allk", "bf16")])
def test_host_prepped_fmajor_bank_equals_jax(ring, strategy, dtype):
    jeng, teng, spec = _fmajor_pair(3, ring=ring, mac_strategy=strategy,
                                    mac_dtype=dtype)
    _assert_fmajor_banks_equal(teng.prepare_bank(spec),
                               jeng.prepare_bank(spec))


def test_host_prepped_cascade_bank_equals_jax():
    irs = _irs(3, n=700)
    jbank, tbank = _banks(irs)
    parts = tbank.max_partitions(B)
    jeng = JaxCascade(4, B, parts, ratio=2, max_predelay=MAXPD, num_irs=3,
                      backend="fft")
    teng = CascadeConvolution(4, B, parts, ratio=2, max_predelay=MAXPD,
                              num_irs=3, device="cpu")
    jb = jeng.prepare_bank(jbank)
    want = cascade_bank_from_numpy(teng, np.asarray(jb.head_rhs2),
                                   np.asarray(jb.tail_rhs2))
    got = teng.prepare_bank(tbank)
    for name in ("head_rhs2", "tail_rhs2"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("engine", ["fmajor", "cascade"])
def test_host_prepped_sessions_match_jax(engine):
    """ConvolutionReverb(bank_prep='host') in both packages: a re-select
    and an interrupt, within 2e-5."""
    irs = _irs(3, n=700)
    jm, tm = _pair(irs, engine=engine, bank_prep="host")
    assert tm.bank_prep == "host"
    x = _input(40)
    events = _events((6, 50), (9, 100))
    want, _ = _run(jm, x, True, events)
    got, _ = _run(tm, x, False, events)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.abs(want).max() > 1e-2


def _refuse(obj, name):
    """Make obj.name raise: a cache hit must not pack."""
    def boom(*args, **kwargs):
        raise AssertionError(f"{name} ran on a cache hit")
    setattr(obj, name, boom)


@pytest.mark.parametrize("ring", [True, False])
def test_fmajor_pack_cache_miss_hit_and_across_packages(tmp_path, ring):
    jeng, teng, spec = _fmajor_pair(3, ring=ring)
    plain = teng.prepare_bank(spec)
    # the port's miss, then its hit
    miss = teng.prepare_bank(spec, cache_dir=tmp_path / "port")
    assert len(list((tmp_path / "port").glob("pack_*.ok"))) == 1
    _refuse(teng, "_pack_bank_host")
    hit = teng.prepare_bank(spec, cache_dir=tmp_path / "port")
    jplain = jeng.prepare_bank(spec)
    for bank in (miss, hit):
        _assert_fmajor_banks_equal(bank, jplain)
        for name in ("rhs2", "spectra_rev2", "mac_rhs", "spectra"):
            assert torch.equal(getattr(bank, name), getattr(plain, name))
    # an entry the JAX package wrote, read by the port, and the reverse
    jeng.prepare_bank(spec, cache_dir=str(tmp_path / "jax"))
    _assert_fmajor_banks_equal(
        teng.prepare_bank(spec, cache_dir=tmp_path / "jax"), jplain)
    _refuse(jeng, "_pack_bank_host")
    _assert_fmajor_banks_equal(
        plain, jeng.prepare_bank(spec, cache_dir=str(tmp_path / "port")))


def test_cascade_pack_cache_miss_hit_and_across_packages(tmp_path):
    irs = _irs(3, n=700)
    jbank, tbank = _banks(irs)
    parts = tbank.max_partitions(B)
    jeng = JaxCascade(4, B, parts, ratio=2, max_predelay=MAXPD, num_irs=3,
                      backend="fft")
    teng = CascadeConvolution(4, B, parts, ratio=2, max_predelay=MAXPD,
                              num_irs=3, device="cpu")
    plain = teng.prepare_bank(tbank)
    banks = [teng.prepare_bank(tbank, cache_dir=tmp_path / "port")]
    assert len(list((tmp_path / "port").glob("cascpack_*.ok"))) == 1
    assert len(list((tmp_path / "port").glob("bank_*.npy"))) == 2
    jeng.prepare_bank(jbank, cache_dir=str(tmp_path / "jax"))
    _refuse(teng, "_pack_bank_host")
    banks.append(teng.prepare_bank(tbank, cache_dir=tmp_path / "port"))
    banks.append(teng.prepare_bank(tbank, cache_dir=tmp_path / "jax"))
    _refuse(jeng, "_pack_bank_host")
    jb = jeng.prepare_bank(jbank, cache_dir=str(tmp_path / "port"))
    banks.append(cascade_bank_from_numpy(teng, np.asarray(jb.head_rhs2),
                                         np.asarray(jb.tail_rhs2)))
    for bank in banks:
        for name in ("head_rhs2", "tail_rhs2"):
            assert torch.equal(getattr(bank, name), getattr(plain, name))
            assert getattr(bank, name).is_contiguous()


# -- the 'dual' and 'derived' fault payloads --------------------------------------


@pytest.mark.parametrize("ring,dtype", [(True, "f32"), (False, "f32"),
                                        (True, "bf16")])
def test_dual_and_derived_slot_updates_equal_each_other_and_jax(ring, dtype):
    """IR 4's host spectra into slot 1 of a 3-IR bank: 'dual' (the
    derived route in the port) and 'derived' give the same bank, bit for
    bit, as the JAX engine's update of either kind (JAX's 'dual' uploads
    both layouts) and as a host prep of the bank with IR 4 in slot 1."""
    got = {}
    for payload in ("dual", "derived"):
        jeng, teng, spec = _fmajor_pair(5, ring=ring, mac_dtype=dtype,
                                        fault_upload=payload)
        jeng.num_irs = teng.num_irs = 3
        bank = teng.prepare_bank(spec[:3])
        assert teng.update_bank_slot(bank, 1, spec[4:5]) is bank
        got[payload] = bank
        _assert_fmajor_banks_equal(
            bank, jeng.update_bank_slot(jeng.prepare_bank(spec[:3]), 1,
                                        spec[4:5]))
    rebuilt = teng.prepare_bank(spec[[0, 4, 2]])
    for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"):
        assert torch.equal(getattr(got["dual"], name),
                           getattr(got["derived"], name)), name
        assert torch.equal(getattr(got["dual"], name),
                           getattr(rebuilt, name)), name
    with pytest.raises(ValueError, match="spectra payload"):
        teng.update_bank_slot(bank, 0, _irs(1)[0])


# IRs 5 and 6 into the never-used slots, then IRs 4 and 1 evicting the
# slots of IRs 0 and 5 once they left fade protection
WS_EVENTS = [(6, 95), (100, 110), (200, 75), (260, 20)]


def test_host_prepped_working_set_equals_the_full_bank():
    """A 3-slot host-prepped working set paging IRs in as spectra payloads
    (misses into never-used slots, then evictions): 'derived' and 'dual'
    bit for bit, and both within 1e-6 of the 7-IR host-prepped full-bank
    session (the JAX package's tolerance for that comparison: the CPU's
    MAC einsum sums a bank of another width in another order, 1-ulp
    apart)."""
    _, tbank = _banks(_irs(7))
    x = _input(300, seed=3)
    outs = {}
    for payload, capacity in (("dual", 3), ("derived", 3), ("dual", None)):
        model = ConvolutionReverb(
            tbank, num_voices=V, block=B, max_predelay=MAXPD,
            bank_capacity=capacity, bank_prep="host", fault_upload=payload,
            ws_exhausted="raise", mac_strategy="allk", device="cpu")
        _configure(model, False)
        if capacity:
            model.working_set.min_age_blocks = 20
        outs[payload, capacity] = _run(model, x, False,
                                       _events(*WS_EVENTS))[0]
        if capacity:
            assert model.working_set.misses == 4
            assert model.engine.fault_upload == payload
    want = outs["dual", None]
    np.testing.assert_array_equal(outs["derived", 3], outs["dual", 3])
    np.testing.assert_allclose(outs["derived", 3], want, atol=1e-6)
    assert np.abs(want).max() > 1e-2


RULES = [
    # (engine, bank_prep, fault_upload, bank_capacity)
    ("fmajor", "host", None, None),
    ("fmajor", "device", None, None),
    ("fmajor", "host", None, 2),
    ("fmajor", "host", "td", 2),
    ("fmajor", "host", "dual", 2),
    ("fmajor", "device", "derived", 2),
    ("fmajor", "host", "nope", None),
    ("cascade", "host", None, None),
    ("cascade", "device", "td", None),
    ("cascade", "host", "derived", 2),
    ("partitioned", "device", None, None),
    ("partitioned", "host", "dual", None),
    ("fmajor", "nope", None, None),
]


@pytest.mark.parametrize("engine,prep,payload,capacity", RULES)
def test_fault_upload_rules_and_errors_match_jax(engine, prep, payload,
                                                 capacity):
    irs = _irs(3, n=700)
    kwargs = dict(num_voices=V, block=B, max_predelay=MAXPD, engine=engine,
                  bank_prep=prep, fault_upload=payload,
                  bank_capacity=capacity)
    jbank, tbank = _banks(irs)
    try:
        jm = JaxReverb(jbank, backend="fft", **kwargs)
    except ValueError as exc:
        with pytest.raises(ValueError) as texc:
            ConvolutionReverb(tbank, device="cpu", **kwargs)
        assert str(texc.value) == str(exc)
        return
    tm = ConvolutionReverb(tbank, device="cpu", **kwargs)
    if engine == "fmajor":
        assert tm.engine.fault_upload == jm.engine.fault_upload
    assert (tm.working_set is None) == (jm.working_set is None)


def test_port_defaults_stay_device_and_td():
    _, tbank = _banks(_irs(3, n=700))
    for engine, prep in (("fmajor", "device"), ("cascade", "device"),
                         ("partitioned", "host")):
        model = ConvolutionReverb(tbank, num_voices=V, block=B,
                                  max_predelay=MAXPD, engine=engine,
                                  bank_capacity=2 if engine == "fmajor"
                                  else None, device="cpu")
        assert model.bank_prep == prep
    assert model.fault_upload == "dual"
    fm = ConvolutionReverb(tbank, num_voices=V, block=B, max_predelay=MAXPD,
                           device="cpu")
    assert fm.engine.fault_upload == "td"


# -- the CLI ----------------------------------------------------------------------

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

MIDI = "4 B0 15 7F\n30 B0 15 40\n50 B0 18 50\n"


def _pcm16(path):
    raw = path.read_bytes()
    return np.frombuffer(raw[raw.index(b"data") + 8:], "<i2")


@pytest.mark.parametrize("flags", [
    ["--fetch-batch", "4", "--wire", "pcm16"],
    ["--bank-capacity", "3", "--bank-prep", "host", "--fault-upload",
     "derived"]])
def test_cli_flags_match_the_jax_cli_within_one_lsb(tmp_path, capsys, flags):
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
    x = rng.uniform(-0.2, 0.2, (64 * 70, 2)).astype(np.float32)
    write_wav(tmp_path / "in.wav", x, 44100, scale="full")
    common = ["--settings", str(tmp_path / "settings.txt"),
              "--input", str(tmp_path / "in.wav"), "--midi",
              str(tmp_path / "events.txt"), "--block-size", "64",
              "--quiet"] + flags
    assert jax_main(common + ["--output", str(tmp_path / "jax.wav")]) == 0
    capsys.readouterr()
    assert port_main(common + ["--output", str(tmp_path / "port.wav"),
                               "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "streamed 70 blocks" in out
    if "--bank-capacity" in flags:
        assert "working set: 3 slots" in out
    want, got = _pcm16(tmp_path / "jax.wav"), _pcm16(tmp_path / "port.wav")
    assert got.shape == want.shape and np.abs(want).max() > 1000
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
