"""The port's ring-pointer MAC (tpu_audio_torch/ops/ring_mac.py) against the
JAX package's Pallas kernel (interpret mode) and its pure-jnp reference.

On the CPU the port's `ring_mac` takes its plain PyTorch version; the CUDA
kernel is held against that plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py). Tolerance 1e-5 absolute, as in
tests/test_pallas_mac.py: both sides sum ~2P f32 products of unit-scale
values in different orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_audio.ops.pallas_mac import (
    double_reversed_rhs, mac_shift_reference, pack_rhs_planes,
    pad_partitions, ring_mac as jax_ring_mac,
    ring_mac_reference as jax_ring_mac_reference,
)
from tpu_audio_torch.ops.ring_mac import ring_mac, ring_mac_reference

torch.set_num_threads(1)

F, VI, P, K, O = 8, 4, 16, 2, 2
KOD = K * O * 2


def _inputs(seed=0):
    """JAX-layout fdl [F, 2, VI, P] and the packed natural-order rhs."""
    rng = np.random.default_rng(seed)
    fdl = rng.standard_normal((F, 2, VI, P)).astype(np.float32)
    spectra = (rng.standard_normal((K, O, P, F))
               + 1j * rng.standard_normal((K, O, P, F))).astype(np.complex64)
    return fdl, pack_rhs_planes(spectra)


def _port_fdl(fdl_jax: np.ndarray) -> torch.Tensor:
    """[F, 2, VI, P] (Pallas layout) -> [F, VI, 2, P] (the engine's)."""
    return torch.tensor(np.ascontiguousarray(np.swapaxes(fdl_jax, 1, 2)))


def _w(w: int) -> torch.Tensor:
    return torch.tensor(w, dtype=torch.int32)


@pytest.mark.parametrize("w", [0, 1, 7, P - 1])
def test_ring_mac_matches_pallas_kernel_every_phase(w):
    fdl, rhs = _inputs(3)
    rhs2 = double_reversed_rhs(rhs)
    want_kernel = np.asarray(jax_ring_mac(w, jnp.asarray(fdl),
                                          jnp.asarray(rhs2), f_tile=2,
                                          interpret=True))
    want_ref = np.asarray(jax_ring_mac_reference(w, jnp.asarray(fdl),
                                                 jnp.asarray(rhs2)))
    got = ring_mac(_w(w), _port_fdl(fdl), torch.tensor(rhs2)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


@pytest.mark.parametrize("w", [0, 1, P - 1])
@pytest.mark.parametrize("k", [5, 9, 15])
def test_ring_mac_matches_the_jax_package_at_all_k_bank_sizes(k, w):
    """KOD = 4K = 20, 36 and 60: bank sizes that mac_strategy='auto' sends
    through ring_mac and whose KOD is no multiple of 16 (the CUDA kernel
    covers them with one masked column tile of 32, 48 or 64)."""
    rng = np.random.default_rng(20 + k)
    fdl = rng.standard_normal((F, 2, VI, P)).astype(np.float32)
    spectra = (rng.standard_normal((k, O, P, F))
               + 1j * rng.standard_normal((k, O, P, F))).astype(np.complex64)
    rhs2 = double_reversed_rhs(pack_rhs_planes(spectra))
    assert rhs2.shape == (F, 2, 2 * P, 4 * k)
    want_kernel = np.asarray(jax_ring_mac(w, jnp.asarray(fdl),
                                          jnp.asarray(rhs2), f_tile=2,
                                          interpret=True))
    want_ref = np.asarray(jax_ring_mac_reference(w, jnp.asarray(fdl),
                                                 jnp.asarray(rhs2)))
    got = ring_mac(_w(w), _port_fdl(fdl), torch.tensor(rhs2)).numpy()
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


@pytest.mark.parametrize("kod", [16, 68])
@pytest.mark.parametrize("pp", [24, 48])
@pytest.mark.parametrize("vi", [1, 8, 20, 40])
def test_ring_mac_matches_the_jax_package_at_small_row_counts(vi, pp, kod):
    """Row counts below the CUDA kernel's 128-row tile, as the cascade's
    tails (VI = 8 at 64 voices) and the mesh's shards give it, at the
    tails' Pp = 48 and KOD 16 and 68 (two column groups on the card).
    Q = 2Pp is up to 96 products here, three times the cases above, and
    the f32 rounding of two correct sums grows with the sums: the operands
    are drawn at half scale, so the outputs stay at those cases'
    magnitudes under the same 1e-5."""
    rng = np.random.default_rng([vi, pp, kod])
    fdl = (0.5 * rng.standard_normal((4, 2, vi, pp))).astype(np.float32)
    rhs2 = (0.5 * rng.standard_normal((4, 2, 2 * pp, kod))).astype(np.float32)
    w = 5
    want_kernel = np.asarray(jax_ring_mac(w, jnp.asarray(fdl),
                                          jnp.asarray(rhs2), f_tile=2,
                                          interpret=True))
    want_ref = np.asarray(jax_ring_mac_reference(w, jnp.asarray(fdl),
                                                 jnp.asarray(rhs2)))
    got = ring_mac(_w(w), _port_fdl(fdl), torch.tensor(rhs2)).numpy()
    assert got.shape == (4, vi, kod)
    np.testing.assert_allclose(got, want_kernel, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


def test_ring_mac_reduces_the_block_counter_mod_p():
    """The engine passes its block counter (mod t_modulus), not the slot:
    any w congruent mod P selects the same window."""
    fdl, rhs = _inputs(6)
    rhs2 = torch.tensor(double_reversed_rhs(rhs))
    a = ring_mac(_w(5), _port_fdl(fdl), rhs2)
    b = ring_mac(_w(5 + 3 * P), _port_fdl(fdl), rhs2)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ring_mac_equals_shift_mac_over_a_stream():
    """Ring addressing (slot w = t mod P, doubled-reversed rhs window) equals
    the shift formulation (JAX mac_shift_reference) block for block, across
    a wrap of the ring pointer."""
    rng = np.random.default_rng(4)
    _, rhs = _inputs(4)
    rhs2 = torch.tensor(double_reversed_rhs(rhs))
    fdl_shift = jnp.zeros((F, 2, VI, P), jnp.float32)
    fdl_ring = torch.zeros((F, VI, 2, P))
    for t in range(P + 3):
        xb = rng.standard_normal((F, 2, VI, 1)).astype(np.float32)
        fdl_shift, m_shift = mac_shift_reference(fdl_shift, jnp.asarray(xb),
                                                 jnp.asarray(rhs))
        fdl_ring[..., t % P] = torch.tensor(xb[..., 0]).transpose(1, 2)
        m_ring = ring_mac(_w(t), fdl_ring, rhs2)
        np.testing.assert_allclose(m_ring.numpy(), np.asarray(m_shift),
                                   atol=1e-5, err_msg=f"block {t}")


@pytest.mark.parametrize("w", [0, 5, 15])
def test_zero_partition_padding_is_inert(w):
    """13 bank partitions padded to a 16-slot ring: the MAC equals the
    from-scratch complex product-sum over the 13 real partitions,
    m = sum_p X[(w - p) mod 16] * H_p, so the zero partitions add nothing
    (and the 2x2 real packing encodes the complex product)."""
    rng = np.random.default_rng(5)
    p_real, pp = 13, 16
    spectra = (rng.standard_normal((K, O, p_real, F))
               + 1j * rng.standard_normal((K, O, p_real, F))
               ).astype(np.complex64)
    rhs_p = pad_partitions(pack_rhs_planes(spectra), axis=2, multiple=8)
    assert rhs_p.shape[2] == pp
    fdl = rng.standard_normal((F, VI, 2, pp)).astype(np.float32)
    got = ring_mac(_w(w), torch.tensor(fdl),
                   torch.tensor(double_reversed_rhs(rhs_p))).numpy()
    x = fdl[:, :, 0].astype(np.complex128) + 1j * fdl[:, :, 1]  # [F, VI, Pp]
    slots = (w - np.arange(p_real)) % pp
    h = np.transpose(spectra, (3, 2, 0, 1)).reshape(F, p_real, K * O)
    want = np.einsum("fvp,fpk->fvk", x[..., slots], h)
    np.testing.assert_allclose(got[..., 0::2], want.real, atol=1e-5)
    np.testing.assert_allclose(got[..., 1::2], want.imag, atol=1e-5)


def test_reference_accepts_an_int_slot_and_float64():
    """chip_smoke.py compares the kernel against the plain version in
    float64 with the same window."""
    fdl, rhs = _inputs(7)
    rhs2 = double_reversed_rhs(rhs)
    got = ring_mac_reference(9, _port_fdl(fdl).double(),
                             torch.tensor(rhs2).double()).numpy()
    want = np.asarray(jax_ring_mac_reference(9, jnp.asarray(fdl),
                                             jnp.asarray(rhs2)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_cpu_path_takes_an_odd_pp():
    """The CUDA kernel refuses an odd Pp (its 16-byte row copies); the plain
    version on the CPU takes any Pp, as the JAX package does."""
    rng = np.random.default_rng(11)
    p = 13
    fdl = rng.standard_normal((F, 2, VI, p)).astype(np.float32)
    rhs2 = rng.standard_normal((F, 2, 2 * p, KOD)).astype(np.float32)
    for w in (0, 1, p - 1):
        want = np.asarray(jax_ring_mac_reference(w, jnp.asarray(fdl),
                                                 jnp.asarray(rhs2)))
        got = ring_mac(_w(w), _port_fdl(fdl), torch.tensor(rhs2)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel that includes csrc/*.cuh is rebuilt when a header changes:
    a stale library is never loaded."""
    from tpu_audio_torch.ops import cuda_build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    lib = cuda_build.CudaLibrary("k", [], source=tmp_path / "k.cu")
    first = lib.digest()
    assert lib.digest() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert lib.digest() != first


def test_build_hash_covers_the_headers_beside_the_source(tmp_path,
                                                         monkeypatch):
    """An earlier version of a kernel kept outside csrc/ builds against the
    headers beside it (nvcc looks there first): a change to one of them
    changes the build's hash too."""
    from tpu_audio_torch.ops import cuda_build
    (tmp_path / "csrc").mkdir()
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path / "csrc")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    lib = cuda_build.CudaLibrary("k", [], source=tmp_path / "k.cu")
    first = lib.digest()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert lib.digest() != first


def test_cpu_path_launches_no_kernel():
    fdl, rhs = _inputs(8)
    before = ring_mac.launches
    ring_mac(_w(0), _port_fdl(fdl), torch.tensor(double_reversed_rhs(rhs)))
    assert ring_mac.launches == before


@pytest.mark.parametrize("case", [
    "fdl_f64", "rhs2_f16", "w_int64", "w_python_int", "w_two_elements",
    "fdl_3d", "rhs2_window_rows", "kod_not_multiple_of_4",
    "fdl_noncontiguous", "f_mismatch"])
def test_ring_mac_rejects_what_the_kernel_does_not_take(case):
    fdl = torch.zeros((F, VI, 2, P))
    rhs2 = torch.zeros((F, 2, 2 * P, KOD))
    w = _w(0)
    if case == "fdl_f64":
        fdl = fdl.double()
    elif case == "rhs2_f16":
        rhs2 = rhs2.half()
    elif case == "w_int64":
        w = torch.tensor(0)
    elif case == "w_python_int":
        w = 0
    elif case == "w_two_elements":
        w = torch.zeros(2, dtype=torch.int32)
    elif case == "fdl_3d":
        fdl = fdl.reshape(F, VI, 2 * P)
    elif case == "rhs2_window_rows":
        rhs2 = torch.zeros((F, 2, P, KOD))
    elif case == "kod_not_multiple_of_4":
        rhs2 = torch.zeros((F, 2, 2 * P, 6))
    elif case == "fdl_noncontiguous":
        fdl = torch.zeros((F, 2, VI, P)).transpose(1, 2)
    elif case == "f_mismatch":
        rhs2 = torch.zeros((F + 1, 2, 2 * P, KOD))
    with pytest.raises((TypeError, ValueError)):
        ring_mac(w, fdl, rhs2)
