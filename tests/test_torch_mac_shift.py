"""The port's fused shift + MAC (tpu_audio_torch/ops/mac_shift.py) against the
JAX package's Pallas kernel (interpret mode) and its pure-jnp reference.

On the CPU the port's `mac_shift` takes its plain PyTorch version; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerances: the shifted line is
a copy and must be bit-equal; m to 1e-5 absolute, as in
tests/test_pallas_mac.py (both sides sum ~2P f32 products of unit-scale
values in different orders); against a from-scratch complex64 product-sum
3e-4, as the JAX test of the same stream states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.ops.pallas_mac import (
    double_reversed_rhs, mac_shift as jax_mac_shift,
    mac_shift_reference as jax_mac_shift_reference, pack_rhs_planes,
    pad_partitions,
)
from tpu_audio_torch.ops.mac_shift import mac_shift, mac_shift_reference
from tpu_audio_torch.ops.ring_mac import ring_mac

torch.set_num_threads(1)

F, VI, P, K, O = 8, 4, 16, 2, 2
KOD = K * O * 2


def _inputs(seed=0, vi=VI):
    """JAX-layout fdl [F, 2, VI, P], x_new [F, 2, VI, 1], the complex
    spectra and the packed natural-order rhs."""
    rng = np.random.default_rng(seed)
    fdl = rng.standard_normal((F, 2, vi, P)).astype(np.float32)
    x_new = rng.standard_normal((F, 2, vi, 1)).astype(np.float32)
    spectra = (rng.standard_normal((K, O, P, F))
               + 1j * rng.standard_normal((K, O, P, F))).astype(np.complex64)
    return fdl, x_new, spectra, pack_rhs_planes(spectra)


def _port(arr_jax: np.ndarray) -> torch.Tensor:
    """[F, 2, VI, n] (Pallas layout) -> [F, VI, 2, n] (the engine's)."""
    return torch.tensor(np.ascontiguousarray(np.swapaxes(arr_jax, 1, 2)))


def _jax(t: torch.Tensor) -> np.ndarray:
    """[F, VI, 2, n] -> [F, 2, VI, n]."""
    return np.swapaxes(t.numpy(), 1, 2)


@pytest.mark.parametrize("vi", [VI, 64, 192])
def test_mac_shift_matches_pallas_kernel_and_reference(vi):
    """VI 64 and 192 are row counts the CUDA kernel takes in tiles below
    its 128-row tile (one 64-row tile, an even split into three); the
    plain version the port runs here is held to the same functions."""
    fdl, x_new, _, rhs = _inputs(1, vi)
    want_fdl, want_m = jax_mac_shift_reference(
        jnp.asarray(fdl), jnp.asarray(x_new), jnp.asarray(rhs))
    kern_fdl, kern_m = jax_mac_shift(jnp.asarray(fdl), jnp.asarray(x_new),
                                     jnp.asarray(rhs), f_tile=2,
                                     interpret=True)
    got_fdl, got_m = mac_shift(_port(fdl), _port(x_new), torch.tensor(rhs))
    np.testing.assert_array_equal(_jax(got_fdl), np.asarray(want_fdl))
    np.testing.assert_array_equal(_jax(got_fdl), np.asarray(kern_fdl))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(kern_m), atol=1e-5)


@pytest.mark.parametrize("k", [5, 9, 15])
def test_mac_shift_matches_the_jax_package_at_all_k_bank_sizes(k):
    """KOD = 4K = 20, 36 and 60: bank sizes that mac_strategy='auto' sends
    through mac_shift and whose KOD is no multiple of 16 (the CUDA kernel
    covers them with one masked column tile)."""
    rng = np.random.default_rng(10 + k)
    p = 24
    fdl = rng.standard_normal((F, 2, VI, p)).astype(np.float32)
    x_new = rng.standard_normal((F, 2, VI, 1)).astype(np.float32)
    spectra = (rng.standard_normal((k, O, p, F))
               + 1j * rng.standard_normal((k, O, p, F))).astype(np.complex64)
    rhs = pack_rhs_planes(spectra)
    assert rhs.shape == (F, 2, p, 4 * k)
    want_fdl, want_m = jax_mac_shift_reference(
        jnp.asarray(fdl), jnp.asarray(x_new), jnp.asarray(rhs))
    kern_fdl, kern_m = jax_mac_shift(jnp.asarray(fdl), jnp.asarray(x_new),
                                     jnp.asarray(rhs), f_tile=2,
                                     interpret=True)
    got_fdl, got_m = mac_shift(_port(fdl), _port(x_new), torch.tensor(rhs))
    np.testing.assert_array_equal(_jax(got_fdl), np.asarray(want_fdl))
    np.testing.assert_array_equal(_jax(got_fdl), np.asarray(kern_fdl))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(kern_m), atol=1e-5)


def test_cpu_path_takes_an_odd_pp():
    """The CUDA kernel refuses an odd Pp (its 16-byte row copies); the plain
    version on the CPU takes any Pp, as the JAX package does."""
    rng = np.random.default_rng(9)
    p = 13
    fdl = rng.standard_normal((F, 2, VI, p)).astype(np.float32)
    x_new = rng.standard_normal((F, 2, VI, 1)).astype(np.float32)
    rhs = rng.standard_normal((F, 2, p, KOD)).astype(np.float32)
    want_fdl, want_m = jax_mac_shift_reference(
        jnp.asarray(fdl), jnp.asarray(x_new), jnp.asarray(rhs))
    got_fdl, got_m = mac_shift(_port(fdl), _port(x_new), torch.tensor(rhs))
    np.testing.assert_array_equal(_jax(got_fdl), np.asarray(want_fdl))
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5)


def test_mac_shift_streams_blocks_like_a_complex_delay_line():
    """Streaming blocks through mac_shift reproduces the partition MAC of a
    from-scratch complex delay line, sum_p X[t - p] * H_p, block for block."""
    rng = np.random.default_rng(2)
    _, _, spectra, rhs = _inputs(2)
    hc = np.transpose(spectra, (3, 2, 0, 1)).reshape(F, P, K * O)
    line = np.zeros((F, VI, P), np.complex64)
    fdl = torch.zeros((F, VI, 2, P))
    rhs_t = torch.tensor(rhs)
    for t in range(P + 4):  # past the point where the first block drops out
        xb = rng.standard_normal((F, VI, 2, 1)).astype(np.float32)
        fdl, m = mac_shift(fdl, torch.tensor(xb), rhs_t)
        line = np.concatenate([xb[:, :, 0] + 1j * xb[:, :, 1],
                               line[..., :-1]], axis=-1)
        want = np.einsum("fvp,fpk->fvk", line, hc)
        np.testing.assert_allclose(m.numpy()[..., 0::2], want.real,
                                   atol=3e-4, err_msg=f"block {t}")
        np.testing.assert_allclose(m.numpy()[..., 1::2], want.imag,
                                   atol=3e-4, err_msg=f"block {t}")
        np.testing.assert_array_equal(fdl.numpy()[:, :, 0], line.real)
        np.testing.assert_array_equal(fdl.numpy()[:, :, 1], line.imag)


def test_mac_shift_equals_ring_mac_over_a_stream():
    """The shift formulation equals the ring formulation (slot t mod P,
    doubled-reversed rhs window) block for block, across a wrap of the ring
    pointer: roll mode and ring mode run the same MAC."""
    rng = np.random.default_rng(4)
    _, _, _, rhs = _inputs(4)
    rhs_t = torch.tensor(rhs)
    rhs2 = torch.tensor(double_reversed_rhs(rhs))
    fdl_shift = torch.zeros((F, VI, 2, P))
    fdl_ring = torch.zeros((F, VI, 2, P))
    for t in range(P + 3):
        xb = torch.tensor(rng.standard_normal((F, VI, 2, 1)).astype(np.float32))
        _, m_shift = mac_shift(fdl_shift, xb, rhs_t)
        fdl_ring[..., t % P] = xb[..., 0]
        m_ring = ring_mac(torch.tensor(t, dtype=torch.int32), fdl_ring, rhs2)
        np.testing.assert_allclose(m_shift.numpy(), m_ring.numpy(),
                                   atol=1e-5, err_msg=f"block {t}")


def test_zero_partition_padding_is_inert():
    """13 bank partitions padded to 16 slots: the MAC over the padded line
    equals the complex product-sum over the 13 real partitions of the
    shifted line, although the last real partition shifts into a pad slot
    (whose rhs rows are zero) and the pad slots hold nonzero values."""
    rng = np.random.default_rng(5)
    p_real, pp = 13, 16
    spectra = (rng.standard_normal((K, O, p_real, F))
               + 1j * rng.standard_normal((K, O, p_real, F))
               ).astype(np.complex64)
    rhs_p = pad_partitions(pack_rhs_planes(spectra), axis=2, multiple=8)
    assert rhs_p.shape[2] == pp
    fdl = rng.standard_normal((F, VI, 2, pp)).astype(np.float32)
    xb = rng.standard_normal((F, VI, 2, 1)).astype(np.float32)
    shifted, m = mac_shift(torch.tensor(fdl), torch.tensor(xb),
                           torch.tensor(rhs_p))
    assert np.abs(shifted.numpy()[..., p_real:]).min() > 0  # pads are live
    x = np.concatenate([xb, fdl[..., :-1]], axis=-1)
    xc = x[:, :, 0].astype(np.complex128) + 1j * x[:, :, 1]   # [F, VI, Pp]
    h = np.transpose(spectra, (3, 2, 0, 1)).reshape(F, p_real, K * O)
    want = np.einsum("fvp,fpk->fvk", xc[..., :p_real], h)
    np.testing.assert_allclose(m.numpy()[..., 0::2], want.real, atol=1e-5)
    np.testing.assert_allclose(m.numpy()[..., 1::2], want.imag, atol=1e-5)


def test_mac_shift_updates_the_delay_line_in_place():
    """The Pallas call aliases its delay line in and out; the port shifts
    the tensor it is given and hands the same tensor back. The plain
    version is pure and leaves its input alone."""
    fdl, x_new, _, rhs = _inputs(6)
    line = _port(fdl)
    before = line.clone()
    shifted, _ = mac_shift_reference(line, _port(x_new), torch.tensor(rhs))
    np.testing.assert_array_equal(line.numpy(), before.numpy())
    ptr = line.data_ptr()
    out, _ = mac_shift(line, _port(x_new), torch.tensor(rhs))
    assert out is line and line.data_ptr() == ptr
    np.testing.assert_array_equal(line.numpy(), shifted.numpy())
    np.testing.assert_array_equal(line.numpy()[..., 1:],
                                  before.numpy()[..., :-1])


def test_reference_accepts_float64():
    """chip_smoke.py compares the kernel against the plain version in
    float64."""
    fdl, x_new, _, rhs = _inputs(7)
    _, got = mac_shift_reference(_port(fdl).double(), _port(x_new).double(),
                                 torch.tensor(rhs).double())
    _, want = jax_mac_shift_reference(jnp.asarray(fdl), jnp.asarray(x_new),
                                      jnp.asarray(rhs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_cpu_path_launches_no_kernel():
    fdl, x_new, _, rhs = _inputs(8)
    before = mac_shift.launches
    mac_shift(_port(fdl), _port(x_new), torch.tensor(rhs))
    assert mac_shift.launches == before


@pytest.mark.parametrize("case", [
    "fdl_f64", "rhs_f16", "x_new_int", "fdl_3d", "x_new_two_slots",
    "x_new_plane_major", "rhs_doubled_rows", "kod_not_multiple_of_4",
    "fdl_noncontiguous", "x_new_noncontiguous", "f_mismatch", "rhs_numpy",
    "x_new_inside_fdl"])
def test_mac_shift_rejects_what_the_kernel_does_not_take(case):
    fdl = torch.zeros((F, VI, 2, P))
    x_new = torch.zeros((F, VI, 2, 1))
    rhs = torch.zeros((F, 2, P, KOD))
    if case == "fdl_f64":
        fdl = fdl.double()
    elif case == "rhs_f16":
        rhs = rhs.half()
    elif case == "x_new_int":
        x_new = x_new.int()
    elif case == "fdl_3d":
        fdl = fdl.reshape(F, VI, 2 * P)
    elif case == "x_new_two_slots":
        x_new = torch.zeros((F, VI, 2, 2))
    elif case == "x_new_plane_major":
        x_new = torch.zeros((F, 2, VI, 1))
    elif case == "rhs_doubled_rows":
        rhs = torch.zeros((F, 2, 2 * P, KOD))
    elif case == "kod_not_multiple_of_4":
        rhs = torch.zeros((F, 2, P, 6))
    elif case == "fdl_noncontiguous":
        fdl = torch.zeros((F, 2, VI, P)).transpose(1, 2)
    elif case == "x_new_noncontiguous":
        x_new = torch.zeros((VI, F, 2, 1)).transpose(0, 1)
    elif case == "f_mismatch":
        rhs = torch.zeros((F + 1, 2, P, KOD))
    elif case == "rhs_numpy":
        rhs = np.zeros((F, 2, P, KOD), np.float32)
    elif case == "x_new_inside_fdl":
        x_new = fdl.reshape(-1)[: F * VI * 2].reshape(F, VI, 2, 1)
    with pytest.raises((TypeError, ValueError)):
        mac_shift(fdl, x_new, rhs)


def test_roll_session_at_three_voices_matches_the_jax_package():
    """A roll-mode session at 3 voices (VI = 6, a row count no power of
    two) through both packages' StreamSession: steady blocks, a re-select
    (collapse_pure, the indexed step), a swap_bank mid-fade (the general
    step) and an interrupting re-select, every block through mac_shift;
    the outputs agree within 2e-5."""
    import jax

    from tpu_audio.engine import ControlPlane as JaxControlPlane
    from tpu_audio.engine import IRBank as JaxIRBank
    from tpu_audio.engine.fmajor import (
        FMajorPartitionedConvolution as JaxFMajor,
    )
    from tpu_audio.engine.params import CCMapping as JaxCCMapping
    from tpu_audio.runtime.backends import WavSink as JaxWavSink
    from tpu_audio.runtime.backends import WavSource as JaxWavSource
    from tpu_audio.runtime.stream import MidiSchedule as JaxMidiSchedule
    from tpu_audio.runtime.stream import StreamSession as JaxSession
    from tpu_audio_torch.engine import ControlPlane, IRBank
    from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution
    from tpu_audio_torch.engine.params import CCMapping
    from tpu_audio_torch.runtime.backends import WavSink, WavSource
    from tpu_audio_torch.runtime.stream import MidiSchedule, StreamSession

    voices, block, num_irs, blocks, swap_at = 3, 32, 3, 40, 14
    rng = np.random.default_rng(16)
    irs = [ir * np.float32(0.4 / np.abs(ir).max()) for ir in
           rng.standard_normal((num_irs, 2, 300)).astype(np.float32)]
    x = (rng.standard_normal((voices, 2, blocks * block)) * 0.05
         ).astype(np.float32)
    events = [(10, 64), (swap_at + 4, 127)]     # CC 21: IR 1, then IR 2

    def run(jax_side):
        # the bank, then the one swapped in: its IRs reversed and halved
        banks = [JaxIRBank() if jax_side else IRBank() for _ in range(2)]
        for ir in irs:
            banks[0].append(ir)
        for ir in irs[::-1]:
            banks[1].append(ir * np.float32(0.5))
        kwargs = dict(max_predelay=64, ring=False, mac_strategy="allk",
                      num_irs=num_irs, swap_snapshot=True)
        p = banks[0].max_partitions(block)
        if jax_side:
            engine = JaxFMajor(voices, block, p, backend="fft", **kwargs)
            control = JaxControlPlane(voices, num_irs, 64)
            mapping, schedule = JaxCCMapping, JaxMidiSchedule
            source_cls, sink_cls = JaxWavSource, JaxWavSink
        else:
            engine = FMajorPartitionedConvolution(voices, block, p,
                                                  device="cpu", **kwargs)
            control = ControlPlane(voices, num_irs, 64, device="cpu")
            mapping, schedule = CCMapping, MidiSchedule
            source_cls, sink_cls = WavSource, WavSink
        control.wet[:] = 0.8
        control.dry[:] = 0.2
        control.speed[:] = 10
        control.predelay[:] = [[5, 0], [17, 40], [3, 3]]
        for v in range(voices):
            for ch in range(2):
                control.set_mapping(v, ch, mapping(message=0xB0, select=0x15))
        spectra = [engine.prepare_bank(b.partitioned_spectra(block))
                   for b in banks]
        extra = {"donate": False} if jax_side else {}
        session = (JaxSession if jax_side else StreamSession)(
            engine, spectra[0], control, None, None, warmup=0, **extra)
        params = (jax.tree.map(jax.numpy.asarray, control.snapshot())
                  if jax_side else control.snapshot_device())
        state = engine.init_converged(spectra[0], params)
        out = []
        # blocks [0, swap_at), then the swap and the rest of the stream
        for b0, b1 in ((0, swap_at), (swap_at, blocks)):
            if b0:
                session.swap_bank(spectra[1])
            session.source = source_cls(x[..., b0 * block: b1 * block],
                                        voices, block)
            session.sink = sink_cls("/dev/null", keep_data=True)
            state = session.run(state, midi=schedule(
                [(b - b0, "", bytes([0xB0, 0x15, value]))
                 for b, value in events if b0 <= b < b1]))
            out.append(session.sink.data)
        return np.concatenate(out, axis=-1), session

    got, session = run(jax_side=False)
    want, _ = run(jax_side=True)
    assert got.shape == want.shape == (voices, 2, blocks * block)
    assert session.indexed_blocks > 0 and session.general_blocks > 0
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=2e-5)
