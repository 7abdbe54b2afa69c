"""The float64 reference against a direct time-domain sum, the roundings
of the controls, and the roofline counts of both cells' shapes."""

import numpy as np
import pytest

from portbench.reference import precision
from portbench.reference.convolve import Reference, pan_gains
from portbench.roofline import ring_mac_work, roofline_s


def direct(x, ir_pair, wet_gain, dry_gain, predelay):
    """out[o][n] = clip(sum_i wet_gain[o] * sum_k h_i[o][k] x_i[n - pd - k])
    + dry_gain[o] * (x_0[n] + x_1[n]), by the plain double loop's sum."""
    t = x.shape[-1]
    out = np.zeros((2, t))
    for o in range(2):
        wet = np.zeros(t)
        for i in range(2):
            h = ir_pair[i][o]
            for n in range(predelay, t):
                m = n - predelay
                k = np.arange(min(len(h), m + 1))
                wet[n] += np.dot(h[k], x[i, m - k])
        out[o] = np.clip(wet * wet_gain[o], -1, 1) + dry_gain[o] * (x[0] + x[1])
    return out


@pytest.mark.parametrize("predelay", [0, 5, 24])
def test_reference_matches_a_direct_sum(predelay):
    rng = np.random.default_rng(7)
    block, blocks = 8, 12
    irs = rng.standard_normal((3, 2, 29))        # not a multiple of B
    x = rng.standard_normal((2, blocks * block)) * 0.3
    params = {"wet": 0.9, "dry": 0.3, "predelay": predelay, "pan_wet": 0.25,
              "pan_dry": -0.5, "level": 0.8}
    ref = Reference(irs, block, params)
    select = (2, 1)

    def inputs(js):
        return np.stack([x[:, max(j, 0) * block:(max(j, 0) + 1) * block]
                         for j in js])

    got = ref.render(inputs, select, np.arange(blocks))
    got = np.concatenate(list(got), axis=-1)
    level = params["level"]
    want = direct(x, [irs[select[0]], irs[select[1]]],
                  params["wet"] * level * pan_gains(params["pan_wet"]),
                  params["dry"] * level * pan_gains(params["pan_dry"]),
                  predelay)
    assert np.abs(want).max() > 1.0    # the clamp is exercised
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pan_law():
    np.testing.assert_array_equal(pan_gains(0.0), [1.0, 1.0])
    np.testing.assert_array_equal(pan_gains(0.5), [0.5, 1.0])
    np.testing.assert_array_equal(pan_gains(-0.25), [1.0, 0.75])


def test_roundings():
    x = np.array([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -9, 3.0, -0.1, 0.0])
    assert precision.tf32(x)[0] == 1.0          # below half an ulp of TF32
    assert precision.tf32(x)[1] == x[1]         # on the TF32 grid
    assert precision.bf16(x)[1] == 1.0          # below bf16's resolution
    rng = np.random.default_rng(1)
    y = rng.standard_normal(10000)
    for fmt, bits in (("tf32", 11), ("bf16", 8)):
        rel = np.abs(precision.FORMATS[fmt](y) - y) / np.abs(y)
        assert rel.max() <= 2.0 ** -bits
    q = precision.fp8_e4m3(y)
    scale = 448.0 / np.abs(y).max()
    assert np.abs(q * scale).max() == 448.0
    assert len(np.unique(np.round(np.abs(q * scale), 9))) <= 127
    big = np.abs(y) * scale >= 2 ** -6
    assert (np.abs(q - y)[big] / np.abs(y)[big]).max() <= 2.0 ** -4


def test_roofline_of_both_cells():
    # ring_f32.stream_1024v: F=257, VI=2048, Pp=696, KOD=64, f32 on the
    # CUDA cores: operations-bound, 93.78 GFLOP at 67 TFLOP/s
    nbytes, flops = ring_mac_work(257, 2048, 696, 64, "float32")
    assert flops == 93_780_443_136
    seconds, bound = roofline_s(nbytes, flops, "float32")
    assert bound == "operations" and seconds == pytest.approx(1.400e-3,
                                                              abs=1e-6)
    # ring_bf16.stream_2048v: VI=4096, bf16 operands, f32 m: bytes-bound,
    # the line 2.930 GB + the window 45.8 MB + m 269.5 MB at 3.35 TB/s
    nbytes, flops = ring_mac_work(257, 4096, 696, 64, "bfloat16")
    seconds, bound = roofline_s(nbytes, flops, "bfloat16")
    assert bound == "bytes" and nbytes == 3_245_914_112
    assert seconds == pytest.approx(0.9687e-3, abs=1e-6)
