"""On-device bank prep (tpu_audio_torch/engine/device_prep.py) and the
engine's time-domain slot update (update_bank_slot) against the JAX
package's, on identical IRs.

The JAX engines are built with backend="fft" so both sides run an FFT;
banks agree to 1e-6 of their scale (f32 FFTs from two libraries). Against
the port's own host prep and a rebuild the packs are the same axis moves,
so only the FFT rounding separates them.
"""

import numpy as np
import pytest
import torch

from tpu_audio.engine import IRBank as JaxIRBank
from tpu_audio.engine import device_prep as jax_dp
from tpu_audio.engine.fmajor import (
    FMajorPartitionedConvolution as JaxFMajor,
)
from tpu_audio_torch.engine import IRBank
from tpu_audio_torch.engine import device_prep as dp
from tpu_audio_torch.engine.fmajor import FMajorPartitionedConvolution

torch.set_num_threads(1)

BLOCK = 32
LEAVES = ("mac_rhs", "rhs2", "spectra", "spectra_rev2")


def _irs(num_irs=6, seconds=0.05, seed=0):
    """Exponential-decay noise IRs of slightly different lengths."""
    rng = np.random.default_rng(seed)
    n = int(seconds * 44100)
    out = []
    for k in range(num_irs):
        env = np.exp(-np.arange(n - 9 * k, dtype=np.float32) / (0.4 * n))
        out.append(rng.standard_normal((2, n - 9 * k)).astype(np.float32)
                   * env * 0.3)
    return out


def _banks(irs):
    jbank, tbank = JaxIRBank(), IRBank()
    for ir in irs:
        jbank.append(ir)
        tbank.append(ir)
    return jbank, tbank


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-9)
    err = float(np.abs(got - want).max())
    assert err <= 1e-6 * scale, f"{what}: {err:.3e} vs scale {scale:.3e}"


def _engines(parts, ring, strategy, num_irs):
    kwargs = dict(max_predelay=64, ring=ring, mac_strategy=strategy,
                  num_irs=num_irs)
    return (JaxFMajor(2, BLOCK, parts, backend="fft", fault_upload="td",
                      **kwargs),
            FMajorPartitionedConvolution(2, BLOCK, parts, device="cpu",
                                         **kwargs))


@pytest.mark.parametrize("ring,strategy", [(True, "allk"), (True, "selected"),
                                           (False, "allk"),
                                           (False, "selected")])
def test_device_prep_matches_jax_and_the_host_prep(ring, strategy):
    irs = _irs()
    jbank, tbank = _banks(irs)
    parts = tbank.max_partitions(BLOCK)
    jeng, teng = _engines(parts, ring, strategy, len(irs))
    want = jax_dp.prepare_fmajor_bank_device(jeng, jbank, wire="f32")
    got = dp.prepare_fmajor_bank_device(teng, tbank)
    host = FMajorPartitionedConvolution(
        2, BLOCK, parts, max_predelay=64, ring=ring, mac_strategy=strategy,
        num_irs=len(irs), device="cpu").prepare_bank(
            tbank.partitioned_spectra(BLOCK))
    for name in LEAVES:
        _close(getattr(got, name), np.asarray(getattr(want, name)), name)
        _close(getattr(got, name), getattr(host, name), name + " vs host")
    assert teng.num_irs == got.num_irs == len(irs)


def test_device_prep_takes_a_time_domain_array_and_checks_num_irs():
    irs = _irs(3)
    _, tbank = _banks(irs)
    parts = tbank.max_partitions(BLOCK)
    td = dp.bank_time_domain(tbank)
    assert td.shape == (3, 2, max(ir.shape[-1] for ir in irs))
    np.testing.assert_array_equal(td, jax_dp.bank_time_domain(_banks(irs)[0]))
    eng = FMajorPartitionedConvolution(2, BLOCK, parts, max_predelay=64,
                                       num_irs=3, device="cpu")
    from_td = dp.prepare_fmajor_bank_device(eng, td)
    from_bank = dp.prepare_fmajor_bank_device(eng, tbank)
    for name in LEAVES:
        assert torch.equal(getattr(from_td, name), getattr(from_bank, name))
    with pytest.raises(ValueError, match="num_irs=3"):
        dp.prepare_fmajor_bank_device(eng, td[:2])


@pytest.mark.parametrize("ring", [True, False])
def test_update_bank_slot_matches_jax_and_a_rebuild(ring):
    """Slot 1 of a 3-slot bank takes IR 4 (shorter than the bank's longest,
    zero-padded to the engine's grid): in place in the port, equal to
    the JAX engine's functional update and to a fresh device prep of the
    IRs (0, 4, 2)."""
    irs = _irs()
    _, tbank = _banks(irs)
    parts = tbank.max_partitions(BLOCK)
    jeng, teng = _engines(parts, ring, "allk", 3)
    residents = JaxIRBank()
    tres = IRBank()
    for k in (0, 5, 2):
        residents.append(irs[k])
        tres.append(irs[k])
    jdev = jax_dp.prepare_fmajor_bank_device(jeng, residents, wire="f32")
    want = jeng.update_bank_slot(jdev, 1, irs[4])
    bank = dp.prepare_fmajor_bank_device(teng, tres)
    leaves_before = {name: getattr(bank, name) for name in LEAVES}
    got = teng.update_bank_slot(bank, 1, irs[4])
    assert got is bank
    for name in LEAVES:
        # in place: the same tensors, no second copy of the bank
        assert getattr(got, name) is leaves_before[name]
        _close(getattr(got, name), np.asarray(getattr(want, name)), name)
    rebuilt = IRBank()
    for k in (0, 4, 2):
        rebuilt.append(irs[k])
    fresh = dp.prepare_fmajor_bank_device(
        FMajorPartitionedConvolution(2, BLOCK, parts, max_predelay=64,
                                     ring=ring, num_irs=3, device="cpu"),
        rebuilt)
    for name in LEAVES:
        _close(getattr(got, name), getattr(fresh, name), name + " rebuild")
    # slots 0 and 2 are untouched, bit for bit
    before = dp.prepare_fmajor_bank_device(
        FMajorPartitionedConvolution(2, BLOCK, parts, max_predelay=64,
                                     ring=ring, num_irs=3, device="cpu"),
        tres)
    cols = got.rhs2 if ring else got.mac_rhs
    cols0 = before.rhs2 if ring else before.mac_rhs
    rows, rows0 = ((got.spectra_rev2, before.spectra_rev2) if ring
                   else (got.spectra, before.spectra))
    for k in (0, 2):
        assert torch.equal(cols[..., 4 * k: 4 * k + 4],
                           cols0[..., 4 * k: 4 * k + 4])
        assert torch.equal(rows[k], rows0[k])


def test_update_bank_slot_refuses_what_the_port_leaves_out(capsys):
    """'selected' banks take no slot writes (as in the JAX engine), a 'td'
    slot update takes a time-domain IR only, and the CLI takes the JAX
    package's three fault payloads (its default None resolves per engine
    in the model) and refuses any other."""
    from tpu_audio_torch.app.main import build_parser

    irs = _irs(3)
    _, tbank = _banks(irs)
    parts = tbank.max_partitions(BLOCK)
    eng = FMajorPartitionedConvolution(2, BLOCK, parts, max_predelay=64,
                                       mac_strategy="selected", num_irs=3,
                                       device="cpu")
    bank = dp.prepare_fmajor_bank_device(eng, tbank)
    with pytest.raises(ValueError, match="'allk'"):
        eng.update_bank_slot(bank, 0, irs[1])
    allk = FMajorPartitionedConvolution(2, BLOCK, parts, max_predelay=64,
                                        num_irs=3, device="cpu")
    spectra = tbank.partitioned_spectra(BLOCK)
    with pytest.raises(ValueError, match="time-domain"):
        allk.update_bank_slot(allk.prepare_bank(spectra), 0, spectra[1])
    parser = build_parser()
    assert parser.parse_args([]).fault_upload is None
    for payload in ("td", "dual", "derived"):
        assert parser.parse_args(["--fault-upload",
                                  payload]).fault_upload == payload
    with pytest.raises(SystemExit):
        parser.parse_args(["--fault-upload", "nope"])
    assert "invalid choice" in capsys.readouterr().err
