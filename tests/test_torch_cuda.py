"""Card-only tests of the port: the CUDA ring_mac and mac_shift kernels
against their plain PyTorch versions, and the engines on the card (fmajor
in ring and roll mode, 'allk' and 'selected'; the cascade on both predelay
sides) against the engines on the CPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the kernels sum in f32 in another order than the float64 plain
version, held to 1e-5 of the output's scale; mac_shift's shifted line is a
copy and must be bit-equal; card vs CPU engine outputs to 2e-5 absolute
(cuFFT vs pocketfft, different MAC summation order).
"""

import numpy as np
import pytest
import torch

from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
from tpu_audio_torch.engine.params import ControlPlane
from tpu_audio_torch.ops.mac_shift import mac_shift, mac_shift_reference
from tpu_audio_torch.ops.ring_mac import ring_mac, ring_mac_reference

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        pytest.skip("needs nvcc (CUDA_HOME)")
    return torch.device("cuda")


@pytest.mark.parametrize("f,vi,pp,kod", [
    (7, 4, 16, 8), (5, 6, 24, 4), (3, 20, 40, 32), (4, 4, 8, 12),
    (9, 33, 56, 16)])
@pytest.mark.parametrize("phase", [0, 1, -1])
def test_kernel_matches_plain_version(cuda, f, vi, pp, kod, phase):
    rng = np.random.default_rng(f * 1000 + vi)
    fdl = torch.tensor(rng.standard_normal((f, vi, 2, pp), dtype=np.float32),
                       device=cuda)
    rhs2 = torch.tensor(rng.standard_normal((f, 2, 2 * pp, kod),
                                            dtype=np.float32), device=cuda)
    w = phase % pp
    got = ring_mac(torch.tensor(w, dtype=torch.int32, device=cuda), fdl, rhs2)
    torch.cuda.synchronize()
    want = ring_mac_reference(w, fdl.double(), rhs2.double())
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


def _check_ring_mac_kernel(device, f, vi, pp, kod, phase, seed,
                           dtype=torch.float32):
    """One launch against the float64 plain version, within 1e-5 of the
    output's scale; the launch is counted once. `dtype` is the operands'
    (float32 or bfloat16; m is float32)."""
    rng = np.random.default_rng(seed)
    fdl = torch.tensor(rng.standard_normal((f, vi, 2, pp), dtype=np.float32),
                       device=device).to(dtype)
    rhs2 = torch.tensor(rng.standard_normal((f, 2, 2 * pp, kod),
                                            dtype=np.float32),
                        device=device).to(dtype)
    w = phase % pp
    before = ring_mac.launches
    got = ring_mac(torch.tensor(w, dtype=torch.int32, device=device), fdl, rhs2)
    torch.cuda.synchronize()
    assert ring_mac.launches == before + 1
    want = ring_mac_reference(w, fdl.double(), rhs2.double())
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("f,vi,pp,kod", [
    (6, 10, 136, 64), (2, 3, 8, 20), (3, 130, 40, 4), (2, 130, 44, 20),
    (3, 130, 40, 36), (2, 129, 52, 48), (2, 131, 52, 60), (2, 130, 136, 64),
    (2, 129, 40, 80)])
@pytest.mark.parametrize("phase", [0, 1, -1])
def test_kernel_matches_plain_version_at_every_column_tile(cuda, f, vi, pp,
                                                          kod, phase):
    """Every KOD <= 64 takes one column tile (16, 32, 48 or 64 wide, the
    columns past KOD masked); KOD 80 takes two column groups on separate
    blocks. VI 129-131 leaves a ragged second row tile of 128; Pp 40, 44,
    52 and 136 put a 32-q chunk across the plane boundary."""
    _check_ring_mac_kernel(cuda, f, vi, pp, kod, phase,
                           seed=f * 1000 + vi + kod)


@pytest.mark.parametrize("pp,kod", [(2048, 16), (2048, 64), (8192, 4)])
@pytest.mark.parametrize("phase", [0, 1, -1])
def test_kernel_matches_plain_version_at_long_lines(cuda, pp, kod, phase):
    """Shared memory no longer grows with Pp: lines whose whole rhs window
    no shared memory could stage."""
    _check_ring_mac_kernel(cuda, 2, 6, pp, kod, phase, seed=pp + kod)


def test_kernel_refuses_an_odd_pp(cuda):
    """The kernel copies 16-byte vectors of each row: a CUDA line of odd Pp
    raises (the CPU path takes it, tests/test_torch_ring_mac.py)."""
    pp = 13
    fdl = torch.zeros((1, 2, 2, pp), device=cuda)
    rhs2 = torch.zeros((1, 2, 2 * pp, 4), device=cuda)
    with pytest.raises(ValueError, match="even Pp"):
        ring_mac(torch.zeros((), dtype=torch.int32, device=cuda), fdl, rhs2)


def _check_mac_shift_kernel(device, f, vi, pp, kod, seed,
                            dtype=torch.float32):
    """One launch against the float64 plain version: the shifted line
    bit-equal, m within 1e-5 of the output's scale. `dtype` is the
    operands' (float32 or bfloat16; m is float32)."""
    rng = np.random.default_rng(seed)

    def operand(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device).to(dtype)

    fdl, x_new, rhs = (operand(f, vi, 2, pp), operand(f, vi, 2, 1),
                       operand(f, 2, pp, kod))
    want_fdl, want = mac_shift_reference(fdl.double(), x_new.double(),
                                         rhs.double())
    before = mac_shift.launches
    got_fdl, got = mac_shift(fdl, x_new, rhs)
    torch.cuda.synchronize()
    assert got_fdl is fdl and mac_shift.launches == before + 1
    assert torch.equal(got_fdl.double(), want_fdl)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


# mac_shift below its 128-row tile, (F, VI, Pp, KOD): one small tile (8,
# 24, 64), even splits of a ragged VI (96: 2 x 48, 160: 3 x 54, 192: 3 x
# 64), every column tile, KOD 80 at VI 64 (two column groups, the shift
# written in the last), and many bins of a few rows each (F = 1101)
MAC_SHIFT_SMALL_ROWS = [
    (5, 8, 40, 16), (3, 24, 44, 32), (3, 64, 52, 48), (3, 64, 136, 64),
    (3, 64, 44, 80), (4, 96, 40, 20), (2, 160, 52, 36), (2, 192, 136, 16),
    (2, 192, 44, 68), (1101, 8, 24, 16), (1101, 24, 20, 12),
    (1101, 16, 24, 32), (1101, 8, 8, 64)]


@pytest.mark.parametrize("f,vi,pp,kod", [
    (7, 4, 16, 8), (5, 6, 24, 4), (3, 20, 40, 32), (4, 4, 8, 12),
    (9, 33, 56, 16), (6, 10, 136, 64), (2, 3, 8, 12),
    (3, 130, 40, 4), (2, 130, 44, 20), (3, 130, 40, 36), (2, 131, 52, 60),
    (2, 130, 136, 64), (2, 129, 40, 80), (2, 256, 44, 16), (2, 256, 44, 36),
    *MAC_SHIFT_SMALL_ROWS])
def test_mac_shift_kernel_matches_plain_version(cuda, f, vi, pp, kod):
    """Every KOD <= 64 takes one column tile (16, 32, 48 or 64 wide, the
    columns past KOD masked); KOD 68 and 80 take two column groups, the
    shifted rows written in the last. VI a multiple of 128 takes the
    128-row tiles at KOD > 16 (VI 256: two of them), any other VI and
    every KOD <= 16 the 64-row tiles (MAC_SHIFT_SMALL_ROWS; VI 129-131: an
    even split into 44-row tiles; VI 256 at KOD 16: 4 x 64); Pp 40, 44, 52
    and 136 put a 32-q chunk across the plane boundary."""
    _check_mac_shift_kernel(cuda, f, vi, pp, kod, seed=f * 1000 + vi + kod)


def test_mac_shift_kernel_sets_up_each_tiling_once_per_device(cuda):
    """Launches that alternate row counts and column tiles (the f32
    form's 128-row and 64-row kernels, the bf16 form's tiles of 1 to 8
    slabs), both dtypes, on one device: each kernel's shared-memory
    ceiling is raised at its first launch only, and every launch after it
    still matches the plain version."""
    for dtype in (torch.float32, torch.bfloat16):
        for vi, kod in [(64, 16), (128, 16), (8, 64), (128, 64), (192, 36),
                        (64, 16), (128, 16), (8, 64), (24, 48)]:
            _check_mac_shift_kernel(cuda, 3, vi, 44, kod, seed=vi + kod,
                                    dtype=dtype)


@pytest.mark.parametrize("pp,kod", [(2048, 16), (8192, 4)])
def test_mac_shift_kernel_matches_plain_version_at_long_lines(cuda, pp, kod):
    """Shared memory no longer grows with Pp: lines whose whole rhs window
    no shared memory could stage."""
    _check_mac_shift_kernel(cuda, 2, 6, pp, kod, seed=pp + kod)


def test_mac_shift_kernel_refuses_an_odd_pp(cuda):
    """The kernel copies 16-byte vectors of each row: a CUDA line of odd Pp
    raises (the CPU path takes it, tests/test_torch_mac_shift.py)."""
    pp = 13
    fdl = torch.zeros((1, 2, 2, pp), device=cuda)
    with pytest.raises(ValueError, match="even Pp"):
        mac_shift(fdl, torch.zeros((1, 2, 2, 1), device=cuda),
                  torch.zeros((1, 2, pp, 4), device=cuda))


def test_engine_on_the_card_matches_the_cpu_and_counts_launches(cuda):
    rng = np.random.default_rng(3)
    spectra = np.fft.rfft(rng.standard_normal((3, 2, 10, 64)), axis=-1
                          ).astype(np.complex64) * 0.1
    runs = {}
    for dev in ("cpu", cuda):
        eng = FMajorPartitionedConvolution(2, 32, 10, max_predelay=64,
                                           num_irs=3, device=dev)
        bank = eng.prepare_bank(spectra)
        cp = ControlPlane(2, 3, 64, device=dev)
        cp.wet[:] = 0.8
        cp.predelay[:] = [[17, 3], [40, 0]]
        cp.pan_wet[:] = [[0.3, -0.4], [-1.0, 0.5]]
        state = eng.init_converged(bank, cp.snapshot_device())
        before = ring_mac.launches
        xs = np.random.default_rng(4).standard_normal((40, 2, 2, 32)) * 0.05
        outs = []
        for t, x in enumerate(xs.astype(np.float32)):
            if t == 10:
                old = cp.select.copy()
                cp.select[:] = [[1, 2], [2, 1]]
                cp.vsteps[:] = 8
                state = eng.collapse_pure(
                    state, torch.tensor(old, device=dev),
                    torch.ones((2, 2), dtype=torch.bool, device=dev))
            step = (eng.step_coef_indexed if t >= 10
                    else eng.step_coef_steady)
            state, out = step(state, bank, cp.snapshot_device(),
                              torch.tensor(x, device=dev))
            cp.end_block()
            outs.append(out.cpu().numpy())
        runs[str(dev)] = (np.stack(outs), ring_mac.launches - before)
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=2e-5)
    assert runs["cuda"][1] == 40 and runs["cpu"][1] == 0


@pytest.mark.parametrize("ring,strategy", [(False, "allk"), (True, "selected"),
                                           (False, "selected")])
def test_roll_and_selected_engines_on_the_card_match_the_cpu(cuda, ring,
                                                            strategy):
    """Steady blocks, a materializing re-select, general fade steps and a
    materialize_base: roll mode launches mac_shift on every block and
    ring_mac on none; 'selected' launches neither."""
    rng = np.random.default_rng(5)
    spectra = np.fft.rfft(rng.standard_normal((3, 2, 10, 64)), axis=-1
                          ).astype(np.complex64) * 0.1
    runs = {}
    for dev in ("cpu", cuda):
        eng = FMajorPartitionedConvolution(2, 32, 10, max_predelay=64,
                                           ring=ring, mac_strategy=strategy,
                                           num_irs=3, device=dev)
        bank = eng.prepare_bank(spectra)
        cp = ControlPlane(2, 3, 64, device=dev)
        cp.wet[:] = 0.8
        cp.predelay[:] = [[17, 3], [40, 0]]
        state = eng.init_converged(bank, cp.snapshot_device())
        before = (mac_shift.launches, ring_mac.launches)
        xs = np.random.default_rng(6).standard_normal((30, 2, 2, 32)) * 0.05
        outs = []
        for t, x in enumerate(xs.astype(np.float32)):
            if t == 8:
                old = cp.select.copy()
                cp.select[:] = [[1, 2], [2, 1]]
                cp.vsteps[:] = 8
                state = eng.collapse(
                    state, bank, torch.tensor(old, device=dev),
                    torch.ones((2, 2), dtype=torch.bool, device=dev),
                    torch.tensor(cp.select, device=dev))
            if t == 12:
                state = eng.materialize_base(state, bank)
            step = eng.step_coef if t >= 8 else eng.step_coef_steady
            state, out = step(state, bank, cp.snapshot_device(),
                              torch.tensor(x, device=dev))
            cp.end_block()
            outs.append(out.cpu().numpy())
        runs[str(dev)] = (np.stack(outs), mac_shift.launches - before[0],
                          ring_mac.launches - before[1])
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], atol=2e-5)
    rolled = 30 if (not ring and strategy == "allk") else 0
    assert runs["cuda"][1:] == (rolled, 0) and runs["cpu"][1:] == (0, 0)


def _ws_irs(num_irs=6, n=1500, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((2, n - 13 * k)) * 0.3).astype(np.float32)
            for k in range(num_irs)]


@pytest.mark.parametrize("ring", [True, False])
def test_device_prep_and_slot_update_on_the_card_match_the_cpu(cuda, ring):
    """Device prep with cuFFT against the CPU path (pocketfft), then one
    in-place slot update on each, within 1e-6 of the bank's scale."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine import device_prep as dp

    irs = _ws_irs()
    bank = IRBank()
    for ir in irs[:3]:
        bank.append(ir)
    banks = {}
    for dev in ("cpu", cuda):
        eng = FMajorPartitionedConvolution(2, 32, 47, max_predelay=64,
                                           ring=ring, num_irs=3, device=dev)
        prepared = dp.prepare_fmajor_bank_device(eng, bank)
        before = {name: getattr(prepared, name).cpu().clone()
                  for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2")}
        assert eng.update_bank_slot(prepared, 1, irs[5]) is prepared
        banks[str(dev)] = (before, prepared)
    for name in ("mac_rhs", "rhs2", "spectra", "spectra_rev2"):
        for got, want in (
                (banks["cuda"][0][name], banks["cpu"][0][name]),
                (getattr(banks["cuda"][1], name).cpu(),
                 getattr(banks["cpu"][1], name))):
            scale = want.abs().max().item()
            assert (got - want).abs().max().item() <= 1e-6 * scale, name


def _ws_session(device, irs, async_paging, x, events):
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    bank = IRBank()
    for ir in irs:
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=2, block=32, max_predelay=64,
                              bank_capacity=3, async_paging=async_paging,
                              device=device)
    ws, cp = model.working_set, model.control
    ws.min_age_blocks = 20
    cp.wet[:] = 0.8
    cp.speed[:] = 6
    for v in range(2):
        for c in range(2):
            cp.set_mapping(v, c, CCMapping(message=0xB0, select=0x15 + 2 * v
                                           + c))
    if async_paging:
        cp.block_hooks.append(ws.drain)
    sink = WavSink("/dev/null", keep_data=True)
    before = ring_mac.launches
    session = model.session(WavSource(x, 2, 32), sink, warmup=0)
    session.run(model.init_state(), midi=MidiSchedule(list(events)))
    ws.close()
    return sink.data, ws, ring_mac.launches - before, session.blocks_streamed


def test_async_paging_session_on_the_card_matches_the_cpu(cuda):
    """A 3-slot working set whose pager packs every fault on its own CUDA
    stream while blocks stream, drained at every block end: the same
    residency and counters as the CPU run of the same session, outputs
    within 2e-5, every block on ring_mac. A publish that did not wait for
    the pager's stream, or that raced the blocks in flight, would play a
    half-written slot."""
    irs = _ws_irs(num_irs=7)
    x = (np.random.default_rng(8).standard_normal((2, 2, 32 * 120)) * 0.05
         ).astype(np.float32)
    events = [(5, "", bytes([0xB0, 0x15, 100])),
              (9, "", bytes([0xB0, 0x16, 127])),
              (14, "", bytes([0xB0, 0x17, 127])),
              (30, "", bytes([0xB0, 0x15, 127])),
              (105, "", bytes([0xB0, 0x18, 60]))]
    runs = {str(dev): _ws_session(dev, irs, True, x, events)
            for dev in ("cpu", cuda)}
    (got, gws, launches, steps), (want, wws, cpu_launches, _) = (
        runs["cuda"], runs["cpu"])
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(want).max() > 1e-2
    assert gws.slot_to_full == wws.slot_to_full
    assert (gws.misses, gws.hits, gws.deferred) == (
        wws.misses, wws.hits, wws.deferred)
    assert gws.misses >= 3 and gws.deferred >= 3
    assert launches == steps == 120 and cpu_launches == 0


@pytest.mark.parametrize("f,vi,pp,kod", [
    (33, 8, 8, 12), (129, 2, 16, 12), (257, 64, 32, 16), (513, 8, 48, 16)])
@pytest.mark.parametrize("phase", [0, 1, -1])
def test_kernel_matches_plain_version_at_cascade_shapes(cuda, f, vi, pp, kod,
                                                        phase):
    """The cascade's two MAC stages at small widths: the head (F1 = B+1,
    VI = 2V, P1p) and one group's tail (F2 = ratio*B+1, VI = 2V/ratio,
    P2p), whose few rows leave most of a 128-row tile empty."""
    _check_ring_mac_kernel(cuda, f, vi, pp, kod, phase, seed=f + vi + kod)


# row counts below the 128-row tile: single rows, several bins to a tile
# (1 to 24), one small tile (40, 64), even splits of a ragged VI (72 to
# 200: VI = 160 is the 1280-voice cascade tail)
SMALL_ROWS = (1, 7, 8, 16, 24, 40, 64, 72, 96, 136, 160, 200)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kod", [12, 16, 20, 36, 64, 68])
@pytest.mark.parametrize("pp", [48, 696])
@pytest.mark.parametrize("vi", SMALL_ROWS)
def test_kernel_matches_plain_version_at_small_row_counts(cuda, vi, pp, kod,
                                                          dtype):
    """Both forms at row counts below the 128-row tile, the cascade tails'
    Pp and the 64-voice line's, every column tile and a second column
    group (KOD 68). F = 5 leaves the last tile of packed bins part empty."""
    for phase in (0, 1, -1):
        _check_ring_mac_kernel(cuda, 5, vi, pp, kod, phase,
                               seed=[vi, pp, kod, phase + 1],
                               dtype=DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("vi,pp", [(1, 4), (8, 4), (24, 8), (72, 12),
                                   (160, 8)])
def test_kernel_matches_plain_version_below_one_chunk(cuda, vi, pp, dtype):
    """Q = 2Pp below one chunk of q (32 in f32, 64 in bf16): one ragged
    chunk, zero-filled past Q."""
    for phase in (0, 1, -1):
        _check_ring_mac_kernel(cuda, 9, vi, pp, 16, phase,
                               seed=[vi, pp, phase + 1], dtype=DTYPES[dtype])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("vi", [8, 64, 160])
def test_kernel_matches_plain_version_at_the_cascade_tails(cuda, vi, dtype):
    """The cascade's tail at full width (F = 16 * 256 + 1, Pp = 48, KOD
    16): 64, 512 and 1280 voices, many more tiles than the card holds
    blocks at once."""
    for phase in (0, 1, -1):
        _check_ring_mac_kernel(cuda, 4097, vi, 48, 16, phase,
                               seed=[vi, phase + 1], dtype=DTYPES[dtype])


def _cascade_session(device, side, x):
    """ConvolutionReverb(engine='cascade') over 3 IRs at 4 voices, ratio 4:
    a re-select, an interrupt and a predelay edit through MIDI."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule

    bank = IRBank()
    for ir in _ws_irs(num_irs=3, n=1200, seed=9):
        bank.append(ir)
    model = ConvolutionReverb(bank, num_voices=4, block=32, max_predelay=273,
                              engine="cascade", cascade_ratio=4,
                              predelay_side=side, device=device)
    cp = model.control
    cp.wet[:] = 0.8
    cp.speed[:] = 8
    cp.predelay[:, 0] = [273, 9, 100, 63]
    for v in range(4):
        for c in range(2):
            cp.set_mapping(v, c, CCMapping(message=0xB0, select=0x15,
                                           predelay=0x16))
    events = [(5, "", bytes([0xB0, 0x15, 64])),
              (9, "", bytes([0xB0, 0x15, 127])),
              (50, "", bytes([0xB0, 0x16, 10]))]
    sink = WavSink("/dev/null", keep_data=True)
    before = ring_mac.launches
    session = model.session(WavSource(x, 4, 32), sink, warmup=0)
    session.run(model.init_state(), midi=MidiSchedule(events))
    return (sink.data, ring_mac.launches - before, session.blocks_streamed,
            session.indexed_blocks)


@pytest.mark.parametrize("side", ["write", "read"])
def test_cascade_session_on_the_card_matches_the_cpu(cuda, side):
    """Both MAC stages launch ring_mac: two launches per block on the card,
    none on the CPU, outputs within 2e-5."""
    x = (np.random.default_rng(10).standard_normal((4, 2, 32 * 70)) * 0.05
         ).astype(np.float32)
    runs = {str(dev): _cascade_session(dev, side, x) for dev in ("cpu", cuda)}
    (got, launches, steps, indexed), (want, cpu_launches, _, cpu_indexed) = (
        runs["cuda"], runs["cpu"])
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert np.abs(want).max() > 0.1
    assert launches == 2 * steps == 140 and cpu_launches == 0
    assert indexed == cpu_indexed >= 10


@pytest.mark.parametrize("side", ["write", "read"])
def test_cascade_steps_never_sync(cuda, side):
    """The steady and indexed steps read nothing back from the device: the
    host counter picks the group, the slots and the MAC windows, and the
    read side's retime is selected on the device. A predelay edit between
    the steps takes the retime path."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine import device_prep as dp
    from tpu_audio_torch.engine.cascade import CascadeConvolution

    bank = IRBank()
    for ir in _ws_irs(num_irs=3, n=1200, seed=9):
        bank.append(ir)
    eng = CascadeConvolution(4, 32, 38, ratio=4, max_predelay=273,
                             predelay_side=side, num_irs=3, device=cuda)
    prepared = dp.prepare_cascade_bank_device(eng, bank)
    cp = ControlPlane(4, 3, 273, device=cuda)
    cp.wet[:] = 0.8
    cp.predelay[:, 0] = [273, 9, 100, 63]
    p1 = cp.snapshot_device()
    cp.predelay[:, 0] = [5, 200, 40, 273]
    p2 = cp.snapshot_device()
    x = torch.randn((4, 2, 32), device=cuda) * 0.05
    state = eng.init_converged(prepared, p1)
    state, _ = eng.step_coef_indexed(state, prepared, p2, x)   # warm-up
    torch.cuda.synchronize()
    before = ring_mac.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for t in range(8):
            params = p1 if t % 3 else p2
            step = eng.step_coef_steady if t % 2 else eng.step_coef_indexed
            state, out = step(state, prepared, params, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ring_mac.launches - before == 16
    assert state.step == 9 and int(state.t) == 9
    assert bool(torch.isfinite(out).all())


def _offline_model(device, kind, automate=False):
    """A small bounce set-up: 'ring' or 'selected' fmajor (2 voices, 3 IRs
    of 300 samples), a 'roll' fmajor engine (no model builds one: the
    (engine, spectra, control) triple render_offline reads), or the
    'cascade' (4 voices, ratio 4, 1200-sample IRs)."""
    import types

    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb

    voices = 4 if kind == "cascade" else 2
    if kind == "roll":
        rng = np.random.default_rng(3)
        spectra = (np.fft.rfft(rng.standard_normal((3, 2, 10, 64)), axis=-1)
                   * 0.1).astype(np.complex64)
        eng = FMajorPartitionedConvolution(voices, 32, 10, max_predelay=64,
                                           ring=False, num_irs=3,
                                           device=device)
        model = types.SimpleNamespace(
            engine=eng, spectra=eng.prepare_bank(spectra),
            control=ControlPlane(voices, 3, 64, device=device))
    else:
        bank = IRBank()
        for ir in _ws_irs(num_irs=3, n=1200 if kind == "cascade" else 300,
                          seed=9):
            bank.append(ir)
        kwargs = ({"engine": "cascade", "cascade_ratio": 4}
                  if kind == "cascade" else
                  {"mac_strategy": "selected" if kind == "selected"
                   else "allk"})
        model = ConvolutionReverb(bank, num_voices=voices, block=32,
                                  max_predelay=64, device=device, **kwargs)
    cp = model.control
    cp.wet[:] = 0.8
    cp.predelay[:, 0] = [17, 40, 3, 63][:voices]
    cp.select[:, 1] = 2
    if automate:
        cp.speed[:] = 8
        for v in range(voices):
            for c in range(2):
                cp.set_mapping(v, c, CCMapping(message=0xB0, select=0x15,
                                               wet=0x16))
    return model


def _bounce_steps(engine, t_blocks, segments, automated=False):
    """Steps of a whole-track bounce: warm-up plus one segment."""
    fast = hasattr(engine, "prime_fdl")
    warmup = engine.prime_blocks if fast else engine.history_blocks
    ratio = getattr(engine, "ratio", 1) if automated else 1
    warmup = -(-warmup // ratio) * ratio
    seg_len = -(-(t_blocks + engine.history_blocks) // segments)
    return warmup + -(-seg_len // ratio) * ratio


@pytest.mark.parametrize("kind", ["ring", "roll", "cascade"])
def test_offline_bounce_on_the_card_matches_the_cpu(cuda, kind):
    """A static bounce on the card against the same model's CPU bounce,
    within 3e-5; every step launches the mode's kernel (twice per step on
    the cascade) and the CPU bounce none."""
    from tpu_audio_torch.runtime.offline import render_offline

    x = (np.random.default_rng(11).standard_normal((2, 32 * 60 + 5)) * 0.05
         ).astype(np.float32)
    outs, counts = {}, {}
    for dev in ("cpu", cuda):
        model = _offline_model(dev, kind)
        before = (ring_mac.launches, mac_shift.launches)
        outs[str(dev)] = render_offline(model, x, segments=3)
        counts[str(dev)] = (ring_mac.launches - before[0],
                            mac_shift.launches - before[1])
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=3e-5)
    assert np.abs(outs["cpu"]).max() > 1e-2
    steps = _bounce_steps(model.engine, 61, 3)
    want = {"ring": (steps, 0), "roll": (0, steps),
            "cascade": (2 * steps, 0)}[kind]
    assert counts["cuda"] == want and counts["cpu"] == (0, 0)


def test_offline_input_buffer_on_the_card_is_pinned_and_reused(cuda):
    """Two bounces of different 16-bit stems of one shape on the card go
    up as int16 from one page-locked host buffer, allocated by the first
    and reused by the second; each equals the CPU bounce within 3e-5."""
    x = [(np.random.default_rng(seed).integers(-3000, 3000, (2, 2, 32 * 60
                                                               + 5))
          / 65536.0).astype(np.float32) for seed in (13, 14)]
    model = _offline_model(cuda, "ring")
    for i, xi in enumerate(x):
        got = model.render_offline(xi, segments=3, input_wire="auto")
        c = model.offline_counters()
        assert c["input_wire"] == "pcm16"
        assert c["input_buffer_reused"] == i
        assert model.engine._offline_input[1].is_pinned()
        want = _offline_model("cpu", "ring").render_offline(
            xi, segments=3, input_wire="auto")
        np.testing.assert_allclose(got, want, atol=3e-5)
        assert np.abs(want).max() > 1e-2


@pytest.mark.parametrize("kind,wire,automated", [
    ("ring", "pcm16", False), ("ring", "f32", True),
    ("selected", "f32", True), ("cascade", "pcm16", True)])
def test_offline_step_loops_never_sync(cuda, monkeypatch, kind, wire,
                                       automated):
    """The static and automated step loops run under
    set_sync_debug_mode("error") up to the final collection: no step
    uploads or reads back anything (the per-step inputs, parameters and
    events are laid out on the device before the loop). Re-selects land
    inside segments; the output equals the CPU bounce's within 3e-5 (one
    LSB on the pcm16 wire)."""
    from tpu_audio_torch.runtime import offline
    from tpu_audio_torch.runtime.stream import MidiSchedule

    strict_calls = []
    loop = offline._step_loop

    def strict(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        strict_calls.append(1)
        return ok

    x = (np.random.default_rng(12).standard_normal((2, 32 * 50)) * 0.05
         ).astype(np.float32)
    events = [(6, "", bytes([0xB0, 0x15, 64])), (21, "", bytes([0xB0, 0x16,
                                                               90])),
              (33, "", bytes([0xB0, 0x15, 127]))]
    outs = {}
    for dev in ("cpu", cuda):
        model = _offline_model(dev, kind, automate=automated)
        kwargs = {"segments": 3, "wire": wire}
        if automated:
            kwargs["schedule"] = MidiSchedule(list(events))
        if dev == cuda:
            monkeypatch.setattr(offline, "_step_loop", strict)
            before = ring_mac.launches
        outs[str(dev)] = offline.render_offline(model, x, **kwargs)
    assert strict_calls == [1]
    # two f32 outputs within 3e-5 (< 1 LSB) quantize at most 1 LSB apart
    atol = 3e-5 if wire == "f32" else 1.001 / 32767
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=atol)
    steps = _bounce_steps(model.engine, 50, 3, automated)
    per_step = {"ring": 1, "selected": 0, "cascade": 2}[kind]
    assert ring_mac.launches - before == per_step * steps


@pytest.mark.parametrize("kind,wire,automated", [
    ("ring", "pcm16", False), ("ring", "f32", True),
    ("cascade", "f32", False)])
def test_offline_step_chunks_on_the_card(cuda, monkeypatch, kind, wire,
                                         automated):
    """A bounce collected in step chunks of 4 kept steps (the staging
    budget cut to their rows): every chunk's step loop runs under
    set_sync_debug_mode("error"), the output equals the CPU bounce's within
    3e-5 (one LSB on the pcm16 wire), and the card launches `ring_mac` as
    often as the one-chunk bounce does."""
    from tpu_audio_torch.runtime import offline
    from tpu_audio_torch.runtime.stream import MidiSchedule

    strict_calls = []
    loop = offline._step_loop

    def strict(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ok = loop(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        strict_calls.append(1)
        return ok

    x = (np.random.default_rng(14).standard_normal((2, 32 * 50 + 9)) * 0.05
         ).astype(np.float32)
    events = [(6, "", bytes([0xB0, 0x15, 64])), (21, "", bytes([0xB0, 0x16,
                                                               90]))]
    outs = {}
    for dev in ("cpu", cuda):
        model = _offline_model(dev, kind, automate=automated)
        kwargs = {"segments": 3, "wire": wire}
        if automated:
            kwargs["schedule"] = MidiSchedule(list(events))
        if dev == cuda:
            vv = 3 * model.engine.num_voices
            monkeypatch.setattr(offline, "_STAGING_BYTES", 4 * vv * 2
                                * model.engine.block * (2 if wire == "pcm16"
                                                        else 4))
            monkeypatch.setattr(offline, "_step_loop", strict)
            before = ring_mac.launches
        counters = {}
        outs[str(dev)] = offline.render_offline(model, x, counters=counters,
                                                **kwargs)
    assert len(strict_calls) == counters["output_chunks"] > 2
    atol = 3e-5 if wire == "f32" else 1.001 / 32767
    np.testing.assert_allclose(outs["cuda"], outs["cpu"], atol=atol)
    assert np.abs(outs["cpu"]).max() > 1e-2
    steps = _bounce_steps(model.engine, 51, 3, automated)
    per_step = {"ring": 1, "cascade": 2}[kind]
    assert ring_mac.launches - before == per_step * steps
    assert counters["steps"] == steps


# -- checkpoints and recovery on the card ---------------------------------------------


def _ckpt_model(device, voices=64, **kwargs):
    """ConvolutionReverb's defaults (ring, 'allk'; `kwargs` override them)
    at `voices` voices over 2 short IRs, a select CC (0x15) and a wet CC
    (0x18) mapped, a 12-block fade speed."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.models.reverb import ConvolutionReverb

    rng = np.random.default_rng(12)
    bank = IRBank()
    for _ in range(2):
        ir = rng.standard_normal((2, 900)).astype(np.float32)
        bank.append(ir * (0.4 / np.abs(ir).max()))
    model = ConvolutionReverb(bank, num_voices=voices, block=64,
                              max_predelay=128, device=device, **kwargs)
    cp = model.control
    cp.wet[:], cp.dry[:], cp.speed[:], cp.predelay[:] = 0.8, 0.2, 12, 40
    for v in range(voices):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=0x15,
                                            wet=0x18))
    return model


def _ckpt_midi():
    from tpu_audio_torch.runtime.stream import MidiSchedule

    return MidiSchedule([(4, "", bytes([0xB0, 0x15, 100])),
                         (13, "", bytes([0xB0, 0x18, 40]))])


def test_checkpoint_round_trip_of_a_64_voice_ring_state_is_bit_exact(
        cuda, tmp_path):
    """A 64-voice ring state saved mid-fade at block 10 on the card loads
    back on the card field for field to the bit (the bf16 snapshot
    included), and the resumed blocks equal the uninterrupted run's."""
    from dataclasses import fields

    from tpu_audio_torch.runtime.backends import WavSource
    from tpu_audio_torch.runtime.checkpoint import (
        load_checkpoint, save_checkpoint,
    )

    x = (np.random.default_rng(13).standard_normal((64, 2, 64 * 19)) * 0.05
         ).astype(np.float32)

    class Keep:
        def __init__(self):
            self.blocks = []

        def write(self, block):
            self.blocks.append(np.array(block))

        def close(self):
            pass

    model = _ckpt_model(cuda)
    sink, midi = Keep(), _ckpt_midi()
    session = model.session(WavSource(x, 64, 64), sink, warmup=0)
    state = session.run(model.init_state(), max_blocks=10, midi=midi)
    assert float(state.coef_a.max()) > 1e-3       # mid-fade
    save_checkpoint(tmp_path / "c", state, model.control,
                    meta={"block_index": 10})
    fresh = _ckpt_model(cuda)
    loaded, meta = load_checkpoint(tmp_path / "c", fresh.engine.init_state(),
                                   fresh.control)
    assert meta == {"block_index": 10}
    for f in fields(state):
        got, want = getattr(loaded, f.name), getattr(state, f.name)
        assert got.device == want.device and got.dtype == want.dtype
        assert torch.equal(got, want), f.name
    assert loaded.base.dtype == torch.bfloat16

    session.run(state, midi=midi, start_block=10)   # the uninterrupted rest
    midi = _ckpt_midi()
    midi.rewind_to(10)
    src = WavSource(x, 64, 64)
    src.seek(10)
    resumed = Keep()
    before = ring_mac.launches
    fresh.session(src, resumed, warmup=0).run(loaded, midi=midi,
                                              start_block=10)
    assert ring_mac.launches - before == 9
    np.testing.assert_array_equal(np.concatenate(resumed.blocks, axis=-1),
                                  np.concatenate(sink.blocks[10:], axis=-1))


def test_run_resilient_on_the_card_equals_the_uninterrupted_run(
        cuda, tmp_path):
    """run_resilient at 64 voices on the card: a sink failure at delivered
    block 14 rebuilds the model, loads the checkpoint at 12, replays the
    wet change at 13 and delivers the uninterrupted run's blocks to the
    bit."""
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.recovery import run_resilient

    x = (np.random.default_rng(14).standard_normal((64, 2, 64 * 24)) * 0.05
         ).astype(np.float32)
    want = WavSink("/dev/null", keep_data=True)
    _ckpt_model(cuda).process(WavSource(x, 64, 64), want, midi=_ckpt_midi(),
                              warmup=0)

    class CrashOnce:
        def __init__(self):
            self.blocks, self.failed = [], False

        def write(self, block):
            if not self.failed and len(self.blocks) == 14:
                self.failed = True
                raise RuntimeError("simulated transport failure")
            self.blocks.append(np.array(block))

        def close(self):
            pass

    sink = CrashOnce()
    _, summary = run_resilient(lambda: _ckpt_model(cuda), WavSource(x, 64, 64),
                               sink, tmp_path / "r.ckpt", checkpoint_every=6,
                               midi=_ckpt_midi(),
                               session_kwargs=dict(warmup=0))
    assert summary["restarts"] == 1
    assert summary["recoveries"][0]["resume_block"] == 12
    np.testing.assert_array_equal(np.concatenate(sink.blocks, axis=-1),
                                  want.data)


@pytest.mark.parametrize("kind", ["coef", "materialized", "monolithic"])
def test_partitioned_and_monolithic_steps_on_the_card_match_the_cpu(cuda,
                                                                   kind):
    """Steady blocks, a re-select (the coef variant's collapse) and fade
    blocks through each engine's steps on the card (cuFFT, the elementwise
    MACs) against the CPU; neither engine launches ring_mac or mac_shift."""
    from tpu_audio_torch.engine.bank import IRBank
    from tpu_audio_torch.engine.monolithic import MonolithicConvolution
    from tpu_audio_torch.engine.partitioned import PartitionedConvolution

    bank = IRBank()
    for ir in np.random.default_rng(8).standard_normal((3, 2, 600)):
        bank.append((ir * 0.05).astype(np.float32))
    if kind == "monolithic":
        host = bank.monolithic_spectra(2048, reserve=256)
    else:
        host = bank.partitioned_spectra(32)
    runs = {}
    for dev in ("cpu", cuda):
        if kind == "monolithic":
            eng = MonolithicConvolution(2, 2048, 32, max_predelay=64,
                                        device=dev)
        else:
            eng = PartitionedConvolution(2, 32, bank.max_partitions(32),
                                         max_predelay=64, variant=kind,
                                         device=dev)
        spectra = torch.from_numpy(host).to(dev)
        cp = ControlPlane(2, 3, 64, device=dev)
        cp.wet[:] = 0.8
        cp.predelay[:] = [[17, 3], [40, 0]]
        cp.pan_wet[:] = [[0.3, -0.4], [-1.0, 0.5]]
        state = eng.init_converged(spectra, cp.snapshot_device())
        before = (ring_mac.launches, mac_shift.launches)
        xs = np.random.default_rng(9).standard_normal((30, 2, 2, 32)) * 0.05
        outs = []
        for t, x in enumerate(xs.astype(np.float32)):
            if t == 8:
                old = cp.select.copy()
                cp.select[:] = [[1, 2], [2, 1]]
                cp.vsteps[:] = 8
                if kind == "coef":
                    state = eng.collapse(
                        state, spectra, torch.tensor(old, device=dev),
                        torch.ones((2, 2), dtype=torch.bool, device=dev))
            step = eng.step
            if kind == "coef" and t < 8:
                step = eng.step_coef_steady
            state, out = step(state, spectra, cp.snapshot_device(),
                              torch.tensor(x, device=dev))
            cp.end_block()
            outs.append(out.cpu().numpy())
        runs[str(dev)] = np.stack(outs)
        assert (ring_mac.launches, mac_shift.launches) == before
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], atol=2e-5)
    assert np.abs(runs["cpu"]).max() > 1e-2


# -- bf16 and the 'selected' cascade ---------------------------------------------------


# the tensor-core kernels' tile edges, (F, VI, Pp, KOD): Pp 4 (Q = 8, less
# than one k16 step), KOD 12 and 20 (half an n8 tile), VI 1 and 17 (below
# and across one m16 tile), the long lines, and (ring_mac only) the
# 2048-voice cascade's head and tail
BF16_EDGES = [(3, 130, 4, 16), (3, 17, 4, 12), (3, 130, 44, 12),
              (3, 130, 44, 20), (3, 1, 44, 16), (3, 17, 44, 36),
              (2, 130, 2048, 16), (2, 130, 2048, 64), (2, 130, 8192, 16),
              (2, 130, 8192, 64)]
BF16_CASCADE_2048 = [(257, 4096, 32, 16), (4097, 256, 48, 16)]
# mac_shift's warp-slab tiles, (F, VI, Pp, KOD): one slab (VI 8), one tile
# of 2 to 4 slabs (24, 64), even splits (96: 6 slabs, 160: 2 x 5, 192: 2 x
# 6), whole tiles of 8 slabs (128, 256: 2 x 8), every column tile, KOD 80
# at VI 64 (the shift in the last column group), Pp 20, 44 and 136 (a 64-q
# chunk across the plane boundary), the mesh's shard (VI 64, Pp 348), and
# many bins of a few rows each (F = 1101)
BF16_MAC_SHIFT_SLABS = [(2, 128, 136, 64), (2, 256, 44, 16),
    (5, 8, 44, 16), (3, 24, 20, 32), (3, 64, 136, 48), (3, 64, 44, 64),
    (3, 64, 44, 80), (3, 64, 348, 16), (4, 96, 20, 20), (2, 160, 136, 36),
    (2, 192, 44, 16), (2, 192, 136, 68), (1101, 8, 44, 16),
    (1101, 24, 20, 12), (1101, 40, 8, 64)]


@pytest.mark.parametrize("kernel,f,vi,pp,kod", [
    *(pytest.param(kernel, 3, 130, pp, kod, id=f"{kernel}-{pp}-{kod}")
      for kernel in ("ring_mac", "mac_shift") for pp in (20, 44, 136)
      for kod in (4, 16, 36, 64, 68)),
    *(pytest.param(kernel, *shape, id=f"{kernel}-{'-'.join(map(str, shape))}")
      for kernel in ("ring_mac", "mac_shift") for shape in BF16_EDGES),
    *(pytest.param("mac_shift", *shape,
                   id=f"mac_shift-{'-'.join(map(str, shape))}")
      for shape in BF16_MAC_SHIFT_SLABS),
    *(pytest.param("ring_mac", *shape,
                   id=f"ring_mac-{'-'.join(map(str, shape))}")
      for shape in BF16_CASCADE_2048)])
def test_bf16_kernels_match_plain_version(cuda, kernel, f, vi, pp, kod):
    """The bf16 kernels against their plain versions (bf16 operands
    upcast, float64 sums) at Pp no multiple of 32 (a chunk across the plane
    boundary), KOD 4 to 68 (every column tile; 68 takes two column groups)
    and VI 130 (a ragged second row tile), and at the tensor-core tiles'
    edges (BF16_EDGES, BF16_CASCADE_2048): m within 1e-5 of scale, the
    shifted line bit for bit, one launch each."""
    rng = np.random.default_rng(pp * 100 + kod if (f, vi) == (3, 130)
                                and pp in (20, 44, 136) else [f, vi, pp, kod])

    def bf16(*shape):
        return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=cuda).to(torch.bfloat16)

    fdl = bf16(f, vi, 2, pp)
    if kernel == "ring_mac":
        rhs2 = bf16(f, 2, 2 * pp, kod)
        for phase in (0, 1, -1):
            w = phase % pp
            before = ring_mac.launches
            got = ring_mac(torch.tensor(w, dtype=torch.int32, device=cuda),
                           fdl, rhs2)
            torch.cuda.synchronize()
            assert ring_mac.launches == before + 1
            want = ring_mac_reference(w, fdl.double(), rhs2.double())
            err = (got.double() - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item()
        return
    x_new, rhs = bf16(f, vi, 2, 1), bf16(f, 2, pp, kod)
    want_fdl, _ = mac_shift_reference(fdl, x_new, rhs)
    _, want = mac_shift_reference(fdl.double(), x_new.double(), rhs.double())
    before = mac_shift.launches
    got_fdl, got = mac_shift(fdl, x_new, rhs)
    torch.cuda.synchronize()
    assert got_fdl is fdl and mac_shift.launches == before + 1
    assert torch.equal(got_fdl.view(torch.int16), want_fdl.view(torch.int16))
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item()


# (F, VI, Pp, KOD) of the f32 kernels' fixed-seed check: every column tile
# (16, 32, 48, 64, and 64 + 16 at KOD 68), ragged rows, the 64-voice line,
# and row counts below the 128-row tile: packed bins (the 64-voice cascade
# tail's VI = 8), a 64-voice mesh shard (VI = 64), even splits (VI = 160,
# and VI = 192: a 96-voice roll session's line)
F32_SHAPES = [(3, 130, 44, 68), (3, 129, 20, 32), (16, 128, 696, 16),
              (16, 128, 696, 36), (16, 128, 696, 64), (64, 8, 48, 16),
              (16, 64, 696, 64), (8, 160, 48, 16), (4, 192, 696, 16)]
# sha256 of those outputs, as f32_output_digests gave them on an H100
# with the f32 kernels' sources from before the bf16 kernels moved to the
# tensor cores (the first five shapes), from before ring_mac's tiles
# followed VI below 128 rows (the next three) and from before mac_shift's
# did (the last: mac_shift's 128-row tiles, ring_mac's small ones)
F32_DIGESTS = {
    "ring_mac 3x130x44x68":
        "e8fcb210e6757d47f20395a5ec6c41e13f242efbc74860d43ac7d14a0b343818",
    "mac_shift 3x130x44x68":
        "4f00a3074eac4b1bdaff33ec4680427ae972e6e247c1860ebdd1fdae03ca6cf7",
    "ring_mac 3x129x20x32":
        "4aa3840fe1ad4ed583dcb0789601eefe351009cd56c90e3dc98a23592ff62be5",
    "mac_shift 3x129x20x32":
        "35b5e0400356dbc003e8278e27023c5b1ef7dfad21acb28bfd90d6aa0b034c8b",
    "ring_mac 16x128x696x16":
        "177593c2c9f918c98fe5e7229ead0f9f9c076af9a3407240669b3b12e4b6a7fb",
    "mac_shift 16x128x696x16":
        "e518798197a45304be175acba563419476a6b5d323f37d1e2386baa907e54cff",
    "ring_mac 16x128x696x36":
        "e0b166c5f74c49ead0ae9bf7367dd4884f582ae16e9d3f4b2c6ca9862671784c",
    "mac_shift 16x128x696x36":
        "73bf510d0656460a6cc1fc6b4bba997a42e9d1f63c352b654858d54f62798f37",
    "ring_mac 16x128x696x64":
        "1dc4a75851d508ea0c513f1e56e25141005ebd25daf2dc101bdb21a2628b5a11",
    "mac_shift 16x128x696x64":
        "15321067a4a5a19dded834d671cb79a179bad9d32d9026b3e1e82b7a473704a7",
    "ring_mac 64x8x48x16":
        "5b4798d193ea14253431b5cd233bb9604b765948fe3199a3b1ace9efedfa832c",
    "mac_shift 64x8x48x16":
        "25f5a6b5ef812c09ef012758d4e045518f8c9c3db2560387f10758e15021ef07",
    "ring_mac 16x64x696x64":
        "1606915b479754dc80794a214bab1e50234818535e2d81e5b2e9d142aea90ecc",
    "mac_shift 16x64x696x64":
        "6bb69db64c8d46bdff77c21cd811182bb340c828eb8e68066f0de11b75876619",
    "ring_mac 8x160x48x16":
        "e24ac407814486da2bed6827947959d782bf54dd0bba67e60db77b40283a1660",
    "mac_shift 8x160x48x16":
        "667cc57fe3511821f4d0449050118fce8faf2b48520fd1c8e87116a803857bdc",
    "ring_mac 4x192x696x16":
        "60924fcdeceacd1c404e2232bc1740c2f4808bf667ae32240a30bd7e88fd518b",
    "mac_shift 4x192x696x16":
        "6003b4859e9d814e74f25fcf9b87d60979533d1970d3c12a5e3e738e2978a000",
}


def f32_output_digests(dev):
    """{name: sha256} of ring_mac's m (ring slot 7) and mac_shift's shifted
    line and m on f32 inputs from numpy seeds, at F32_SHAPES."""
    import hashlib

    digests = {}
    for f, vi, pp, kod in F32_SHAPES:
        rng = np.random.default_rng([f, vi, pp, kod])

        def f32(*shape):
            return torch.tensor(rng.standard_normal(shape, dtype=np.float32),
                                device=dev)

        fdl, rhs2 = f32(f, vi, 2, pp), f32(f, 2, 2 * pp, kod)
        x_new, rhs = f32(f, vi, 2, 1), f32(f, 2, pp, kod)
        m = ring_mac(torch.tensor(7, dtype=torch.int32, device=dev), fdl,
                     rhs2)
        line, m2 = mac_shift(fdl.clone(), x_new, rhs)
        for name, outs in (("ring_mac", (m,)), ("mac_shift", (line, m2))):
            digest = hashlib.sha256()
            for t in outs:
                digest.update(t.cpu().numpy().tobytes())
            digests[f"{name} {f}x{vi}x{pp}x{kod}"] = digest.hexdigest()
    return digests


def test_f32_kernels_are_unchanged_at_a_fixed_seed(cuda):
    """The f32 kernels keep their outputs bit for bit beside the bf16
    tensor-core kernels: the sha256 of every output at F32_SHAPES equals
    the one the earlier f32 kernels gave on the same inputs."""
    assert f32_output_digests(cuda) == F32_DIGESTS


def test_bf16_kernel_refuses_a_pp_not_divisible_by_4(cuda):
    """A bf16 row of Q = 2*Pp values starts on 16 bytes only when Pp % 4 ==
    0: Pp 18 raises on the card (the CPU path takes it)."""
    fdl = torch.zeros((1, 2, 2, 18), dtype=torch.bfloat16, device=cuda)
    rhs2 = torch.zeros((1, 2, 36, 4), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        ring_mac(torch.zeros((), dtype=torch.int32, device=cuda), fdl, rhs2)


def test_bmm_f32_takes_bf16_operands_on_the_card(cuda):
    """The per-voice MACs' product (engine/fmajor.py:bmm_f32) on bf16
    operands on the card: f32 out, within 1e-5 of scale of the float64
    product of the operands, on a transposed view and on a strided window
    view as the engines pass them, with no f32 copy of the operands made
    (the peak allocation grows by less than one)."""
    from tpu_audio_torch.engine.fmajor import bmm_f32

    rng = np.random.default_rng(13)
    batch, pp = 4096, 136
    a = torch.tensor(rng.standard_normal((batch, 2, pp), dtype=np.float32),
                     device=cuda).to(torch.bfloat16)
    cols = torch.tensor(rng.standard_normal((batch, 2 * pp, 4),
                                            dtype=np.float32),
                        device=cuda).to(torch.bfloat16)
    rhs = torch.tensor(rng.standard_normal((batch, 4, pp), dtype=np.float32),
                       device=cuda).to(torch.bfloat16)
    for b in (rhs.transpose(1, 2), cols[:, pp - 5: 2 * pp - 5]):
        bmm_f32(a, b)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = bmm_f32(a, b)
        torch.cuda.synchronize()
        grown = torch.cuda.max_memory_allocated() - base
        want = torch.bmm(a.double(), b.double())
        assert got.dtype == torch.float32
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item()
        assert grown < a.numel() * 4, grown


@pytest.mark.parametrize("kind", ["ring_bf16", "roll_bf16", "cascade_bf16",
                                  "cascade_selected", "selected_bf16",
                                  "cascade_selected_bf16"])
def test_bf16_and_selected_engines_on_the_card_match_the_cpu(cuda, kind):
    """Steady blocks, a re-select and fade blocks on the card against the
    CPU: bf16 within 2e-3 of scale (cuFFT and pocketfft round a few values
    to neighbouring bf16 values), the f32 'selected' cascade within 2e-5
    of scale. The bf16 engines launch their kernel's bf16 instantiation
    on every block (the cascade twice); the 'selected' engines (fmajor
    ring and the cascade) launch none."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine.cascade import CascadeConvolution

    rng = np.random.default_rng(9)
    bank = IRBank()
    for _ in range(3):
        bank.append((rng.standard_normal((2, 1200)) * 0.05).astype(np.float32))
    runs = {}
    for dev in ("cpu", cuda):
        selected = "selected" in kind
        options = {"mac_dtype": "bf16" if "bf16" in kind else "f32",
                   "mac_strategy": "selected" if selected else "allk"}
        if kind.startswith("cascade"):
            eng = CascadeConvolution(
                4, 32, bank.max_partitions(32), ratio=4, max_predelay=64,
                num_irs=3, device=dev, **options)
            spectra = eng.prepare_bank(bank)
        else:
            eng = FMajorPartitionedConvolution(
                4, 32, bank.max_partitions(32), max_predelay=64,
                ring=kind != "roll_bf16", num_irs=3, device=dev, **options)
            spectra = eng.prepare_bank(bank.partitioned_spectra(32))
        cp = ControlPlane(4, 3, 64, device=dev)
        cp.wet[:] = 0.8
        cp.speed[:] = 6
        cp.predelay[:, 0] = [0, 9, 37, 63]
        state = eng.init_converged(spectra, cp.snapshot_device())
        before = (ring_mac.launches, mac_shift.launches)
        xs = np.random.default_rng(6).standard_normal((30, 4, 2, 32)) * 0.05
        outs = []
        for t, x in enumerate(xs.astype(np.float32)):
            if t == 8:
                old = cp.select.copy()
                cp.select[:] = (old + 1) % 3
                cp.vsteps[:] = cp.speed
                args = (torch.tensor(old, device=dev),
                        torch.ones((4, 2), dtype=torch.bool, device=dev))
                if selected:
                    state = eng.collapse(state, spectra, *args,
                                         torch.tensor(cp.select, device=dev),
                                         cp.snapshot_device())
                elif kind == "cascade_bf16":
                    state = eng.collapse_pure(state, *args,
                                              cp.snapshot_device())
                else:
                    state = eng.collapse_pure(state, *args)
            if t < 8:
                step = eng.step_coef_steady
            elif selected:
                step = eng.step_coef
            else:
                step = eng.step_coef_indexed
            state, out = step(state, spectra, cp.snapshot_device(),
                              torch.tensor(x, device=dev))
            cp.end_block()
            outs.append(out.cpu().numpy())
        runs[str(dev)] = (np.stack(outs), ring_mac.launches - before[0],
                          mac_shift.launches - before[1])
    got, want = runs["cuda"][0], runs["cpu"][0]
    rel = 2e-5 if kind == "cascade_selected" else 2e-3
    assert np.abs(got - want).max() <= rel * np.abs(want).max()
    launches = {"ring_bf16": (30, 0), "roll_bf16": (0, 30),
                "cascade_bf16": (60, 0)}.get(kind, (0, 0))
    assert runs["cuda"][1:] == launches and runs["cpu"][1:] == (0, 0)


@pytest.mark.parametrize("kind", ["ring_bf16", "cascade_selected"])
def test_run_resilient_of_the_later_paths_on_the_card(cuda, tmp_path, kind):
    """run_resilient at 64 voices on the card over a bf16 ring model and a
    'selected' cascade: a sink failure at delivered block 14 resumes from
    the checkpoint at 12 (mid-fade) and delivers the uninterrupted run's
    blocks to the bit."""
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.recovery import run_resilient

    kwargs = ({"mac_dtype": "bf16"} if kind == "ring_bf16"
              else {"engine": "cascade", "mac_strategy": "selected"})
    x = (np.random.default_rng(15).standard_normal((64, 2, 64 * 24)) * 0.05
         ).astype(np.float32)
    want = WavSink("/dev/null", keep_data=True)
    _ckpt_model(cuda, **kwargs).process(WavSource(x, 64, 64), want,
                                        midi=_ckpt_midi(), warmup=0)

    class CrashOnce:
        def __init__(self):
            self.blocks, self.failed = [], False

        def write(self, block):
            if not self.failed and len(self.blocks) == 14:
                self.failed = True
                raise RuntimeError("simulated transport failure")
            self.blocks.append(np.array(block))

        def close(self):
            pass

    sink = CrashOnce()
    _, summary = run_resilient(lambda: _ckpt_model(cuda, **kwargs),
                               WavSource(x, 64, 64), sink,
                               tmp_path / "r.ckpt", checkpoint_every=6,
                               midi=_ckpt_midi(),
                               session_kwargs=dict(warmup=0))
    assert summary["restarts"] == 1
    assert summary["recoveries"][0]["resume_block"] == 12
    np.testing.assert_array_equal(np.concatenate(sink.blocks, axis=-1),
                                  want.data)


def _chunk_session(device, ring, chunk, x):
    """A roll or ring 'allk' session at 4 voices on `device`, a re-select
    at 8 and an interrupt at 16 (on the chunk grid), in chunks of `chunk`;
    returns (sink data, kernel launches)."""
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    rng = np.random.default_rng(21)
    spectra = np.fft.rfft(rng.standard_normal((3, 2, 12, 128)), axis=-1
                          ).astype(np.complex64) * 0.1
    eng = FMajorPartitionedConvolution(4, 64, 12, max_predelay=64, num_irs=3,
                                       ring=ring, device=device)
    bank = eng.prepare_bank(spectra)
    cp = ControlPlane(4, 3, 64, device=device)
    cp.wet[:], cp.dry[:], cp.speed[:] = 0.8, 0.2, 10
    for v in range(4):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=0x15))
    sink = WavSink("/dev/null", keep_data=True)
    session = StreamSession(eng, bank, cp, WavSource(x, 4, 64), sink,
                            warmup=0, chunk_blocks=chunk)
    counter = ring_mac if ring else mac_shift
    before = counter.launches
    session.run(eng.init_converged(bank, cp.snapshot_device()),
                midi=MidiSchedule([(8, "", bytes([0xB0, 0x15, 64])),
                                   (16, "", bytes([0xB0, 0x15, 127]))]))
    return sink.data, counter.launches - before


@pytest.mark.parametrize("ring", [True, False])
def test_chunked_session_on_the_card_matches_its_per_block_run(cuda, ring):
    """chunk_blocks=8 over 43 blocks (a partial last chunk): one ring_mac
    (ring) or mac_shift (roll) launch per block, the output equal to the
    per-block session's on the card to the bit (every event on the chunk
    grid, the fades outlast the run) and to the CPU's within 2e-5."""
    x = (np.random.default_rng(22).standard_normal((4, 2, 64 * 43)) * 0.05
         ).astype(np.float32)
    chunked, launches = _chunk_session(cuda, ring, 8, x)
    per_block, launches1 = _chunk_session(cuda, ring, 1, x)
    on_cpu, cpu_launches = _chunk_session("cpu", ring, 8, x)
    assert launches == launches1 == 43 and cpu_launches == 0
    np.testing.assert_array_equal(chunked, per_block)
    np.testing.assert_allclose(chunked, on_cpu, atol=2e-5)


def test_cli_profile_trace_holds_ring_mac(cuda, tmp_path, capsys):
    """--profile on the card: the trace's kernel events hold the
    hand-written ring_mac (launched through ctypes, seen by CUPTI), and
    `tools profile` lists it."""
    import os

    from tpu_audio_torch.app.main import main as app_main
    from tpu_audio_torch.app.tools import main as tools_main
    from tpu_audio_torch.io.wav import write_wav
    from tpu_audio_torch.utils import trace

    ir = np.random.default_rng(23).standard_normal((3000, 2)) * 0.1
    write_wav(tmp_path / "ir.wav", ir.astype(np.float32), 44100, bits=32)
    (tmp_path / "bank.index").write_text("ir.wav\n")
    (tmp_path / "settings.txt").write_text("conv.count 2\n" + "".join(
        f"conv[{c}].index bank.index\nconv[{c}].maxPredelay 256\n"
        for c in range(2)))
    before = ring_mac.launches
    assert app_main(["--settings", str(tmp_path / "settings.txt"), "--root",
                     str(tmp_path), "--signal", "noise", "--blocks", "12",
                     "--chunk-blocks", "4", "--profile",
                     str(tmp_path / "prof"), "--quiet"]) == 0
    assert ring_mac.launches - before == 12
    path = trace.newest_trace(tmp_path / "prof")
    assert os.path.basename(path) == f"{os.getpid()}.pt.trace.json"
    kernels = trace.category_events(path)["kernel"]
    # CUPTI can drop an event at the trace's edge (chip_smoke.py phase 31
    # once counted 39 of 40 launches), so at least 11 of the 12
    assert 11 <= sum(len(d) for name, d in kernels.items()
                     if "ring_mac" in name) <= 12
    capsys.readouterr()
    assert tools_main(["profile", str(tmp_path / "prof"), "--top", "40"]) == 0
    out = capsys.readouterr().out
    assert "ring_mac" in out.split("category 'kernel'")[1]


# -- the device mesh on the card ---------------------------------------------------------


def _mesh_session(device, kind, mesh, x):
    """8 voices of fmajor ring, roll or the cascade (ratio 2) on `device`
    over `mesh` (None: one device), a re-select at 10 and an interrupt at
    20; returns (sink data, the MAC kernel's launches)."""
    from tpu_audio_torch.engine.cascade import CascadeConvolution
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    rng = np.random.default_rng(31)
    if kind == "cascade":
        from tpu_audio_torch.engine.bank import IRBank

        bank = IRBank()
        for _ in range(3):
            bank.append((rng.standard_normal((2, 900)) * 0.1
                         ).astype(np.float32))
        eng = CascadeConvolution(8, 32, bank.max_partitions(32), ratio=2,
                                 max_predelay=64, num_irs=3, device=device)
        spectra = eng.prepare_bank(bank)
    else:
        eng = FMajorPartitionedConvolution(8, 64, 16, max_predelay=64,
                                           num_irs=3, ring=kind == "ring",
                                           device=device)
        spectra = eng.prepare_bank(
            np.fft.rfft(rng.standard_normal((3, 2, 16, 128)), axis=-1
                        ).astype(np.complex64) * 0.1)
    cp = ControlPlane(8, 3, 64, device=device)
    cp.wet[:], cp.dry[:], cp.speed[:] = 0.8, 0.2, 10
    for v in range(8):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=0x15))
    sink = WavSink("/dev/null", keep_data=True)
    session = StreamSession(eng, spectra, cp,
                            WavSource(x[..., :eng.block * 40], 8, eng.block),
                            sink, warmup=0, mesh=mesh)
    counter = mac_shift if kind == "roll" else ring_mac
    before = counter.launches
    session.run(eng.init_converged(spectra, cp.snapshot_device()),
                midi=MidiSchedule([(10, "", bytes([0xB0, 0x15, 64])),
                                   (20, "", bytes([0xB0, 0x15, 127]))]))
    return sink.data, counter.launches - before


@pytest.mark.parametrize("kind,voice,part", [
    ("ring", 2, 1), ("roll", 1, 2), ("cascade", 2, 1)])
def test_virtual_mesh_on_the_card_matches_one_device(cuda, kind, voice,
                                                    part):
    """A 2-shard mesh of cuda:0 (virtual shards) against the same session
    on one device: one kernel launch per shard per block (two on the
    cascade), the output within 2e-6 (voice shards) or 1e-5 (partition
    shards) absolute."""
    from tpu_audio_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    x = (np.random.default_rng(32).standard_normal((8, 2, 64 * 40)) * 0.05
         ).astype(np.float32)
    mesh = make_mesh(devices=[dev] * (voice * part), part=part)
    got, launches = _mesh_session(dev, kind, mesh, x)
    want, launches1 = _mesh_session(dev, kind, None, x)
    per_block = 2 if kind == "cascade" else 1
    assert launches1 == 40 * per_block
    assert launches == 40 * per_block * voice * part
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-6 if part == 1 else 1e-5)


@pytest.mark.skipif(torch.cuda.device_count() < 2,
                    reason="needs two CUDA devices")
@pytest.mark.parametrize("kind,part", [("ring", 1), ("roll", 2)])
def test_mesh_over_two_cards_matches_one_device(cuda, kind, part):
    """The same session over cuda:0 and cuda:1 (the peer copies of the
    part axis, each output fetched behind its own device's event)."""
    from tpu_audio_torch.parallel import make_mesh

    x = (np.random.default_rng(33).standard_normal((8, 2, 64 * 40)) * 0.05
         ).astype(np.float32)
    mesh = make_mesh(n_devices=2, part=part)
    got, launches = _mesh_session(torch.device("cuda", 0), kind, mesh, x)
    want, _ = _mesh_session(torch.device("cuda", 0), kind, None, x)
    assert launches == 80
    np.testing.assert_allclose(got, want, atol=2e-6 if part == 1 else 1e-5)


def _batched_session(device, x, **session_kwargs):
    """A ring 'allk' session at 4 voices on `device` with a re-select at 8
    (phase 4's model at a small size); returns (sink data, session,
    ring_mac launches)."""
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    rng = np.random.default_rng(41)
    spectra = np.fft.rfft(rng.standard_normal((3, 2, 12, 128)), axis=-1
                          ).astype(np.complex64) * 0.1
    eng = FMajorPartitionedConvolution(4, 64, 12, max_predelay=64, num_irs=3,
                                       device=device)
    bank = eng.prepare_bank(spectra)
    cp = ControlPlane(4, 3, 64, device=device)
    cp.wet[:], cp.dry[:], cp.speed[:] = 0.8, 0.2, 10
    for v in range(4):
        for ch in range(2):
            cp.set_mapping(v, ch, CCMapping(message=0xB0, select=0x15))
    sink = WavSink("/dev/null", keep_data=True)
    session = StreamSession(eng, bank, cp, WavSource(x, 4, 64), sink,
                            warmup=0, **session_kwargs)
    before = ring_mac.launches
    session.run(eng.init_converged(bank, cp.snapshot_device()),
                midi=MidiSchedule([(8, "", bytes([0xB0, 0x15, 64]))]))
    return sink.data, session, ring_mac.launches - before


def test_batched_session_syncs_once_per_batch(cuda, monkeypatch):
    """fetch_batch=4 over 18 blocks: the host waits on 5 events (4 full
    batches and the partial last one), not 18, makes 5 device-to-host
    copies, and delivers the per-block session's audio bit for bit, every
    block on ring_mac."""
    x = (np.random.default_rng(42).standard_normal((4, 2, 64 * 18)) * 0.05
         ).astype(np.float32)
    waits = []
    wait = torch.cuda.Event.synchronize

    def counted(event):
        waits.append(1)
        return wait(event)

    want, plain, _ = _batched_session(cuda, x)
    assert plain.fetch_copies == 18
    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted)
    got, session, launches = _batched_session(cuda, x, fetch_batch=4)
    assert len(waits) == 5 and session.fetch_copies == 5
    assert launches == 18
    assert session.fetch_bytes == plain.fetch_bytes == 18 * 4 * 2 * 64 * 4
    np.testing.assert_array_equal(got, want)


def test_pcm16_batch_leaves_the_card_as_int16(cuda, monkeypatch):
    """On the pcm16 wire each batch crosses as one int16 copy (half the f32
    bytes), and the decoded audio is the f32 session's within one step of
    the 16-bit grid."""
    from tpu_audio_torch.runtime import stream

    x = (np.random.default_rng(43).standard_normal((4, 2, 64 * 16)) * 0.05
         ).astype(np.float32)
    dtypes = []
    deliver = stream.StreamSession._deliver_batch

    def spy(self, hosts, n):
        dtypes.extend(h.dtype for h in hosts)
        return deliver(self, hosts, n)

    monkeypatch.setattr(stream.StreamSession, "_deliver_batch", spy)
    want, _, _ = _batched_session(cuda, x)
    got, session, _ = _batched_session(cuda, x, fetch_batch=8, wire="pcm16")
    assert dtypes == [torch.int16, torch.int16]
    assert session.fetch_copies == 2
    assert session.fetch_bytes == 16 * 4 * 2 * 64 * 2
    np.testing.assert_allclose(got, want, atol=1.01 / 32767)


def test_session_spans_and_counters_on_the_card(cuda):
    """Spans on the card change no output; each block has its span, the
    re-select block its select span, every block a fetch_wait on its own
    copy event; the counters hold the pinned uploads and the fetches."""
    from tpu_audio_torch.utils.profiling import Spans

    x = (np.random.default_rng(44).standard_normal((4, 2, 64 * 16)) * 0.05
         ).astype(np.float32)
    want, _, _ = _batched_session(cuda, x)
    spans = Spans()
    got, session, _ = _batched_session(cuda, x, spans=spans)
    np.testing.assert_array_equal(got, want)
    recs = spans.records()
    # 16 blocks, then the read that finds the source dry
    assert [r.block for r in recs if r.name == "block"] == list(range(17))
    steps = [r.name for r in recs if r.name.startswith("step.")]
    assert len(steps) == 16 and steps[8] == "step.indexed"
    assert [r.block for r in recs if r.name == "select"] == [8]
    assert [r.block for r in recs
            if r.name == "fetch_wait"] == list(range(16))
    counters = session.summary()["counters"]
    assert counters["upload_bytes"] == counters["fetch_bytes"] == (
        16 * 4 * 2 * 64 * 4)
    assert counters["fetch_copies"] == 16
    assert counters["collapses_pure"] == 1


def test_pcm16_bank_upload_equals_the_f32_upload_on_the_card(cuda):
    """A bank on the 16-bit WAV grid crosses as int16 and is decoded on the
    card: the prepared bank equals the f32 upload's bit for bit."""
    from tpu_audio_torch.engine import IRBank
    from tpu_audio_torch.engine import device_prep as dp

    bank = IRBank()
    for ir in _ws_irs():
        bank.append((np.round(np.clip(ir, -0.49, 0.49) * 65536) / 65536
                     ).astype(np.float32))
    td = dp.bank_time_domain(bank)
    tdev, used = dp.upload_bank_td(td, "auto", cuda)
    assert used == "pcm16" and tdev.dtype == torch.float32
    assert torch.equal(tdev.cpu(), torch.from_numpy(td))
    banks = [dp.prepare_fmajor_bank_device(
        FMajorPartitionedConvolution(4, 64, bank.max_partitions(64),
                                     max_predelay=64, device=cuda),
        bank, wire=wire) for wire in ("pcm16", "f32")]
    for name in ("rhs2", "spectra_rev2"):
        assert torch.equal(getattr(banks[0], name), getattr(banks[1], name))
