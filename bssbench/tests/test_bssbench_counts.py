"""The roofline counts at a small shape, worked by hand."""

import types

import pytest

from bssbench import peaks
from bssbench.metrics import k1_roofline, k1b_roofline, step_mfu
from bssbench.reference import auxiva_ip1, gauss_ilrma_ip1

H100 = "NVIDIA H100 80GB HBM3"


def test_weighted_covariance_counts():
    # M = 2 channels: the upper half holds P = 3 entries, two on the diagonal. One bin, one frame, one source:
    # x0 x0*, x1 x1* (3 flops each) and x0 x1* (6) make 12; the weight times each and the sum, 2 + 2 + 4 = 8.
    assert k1_roofline.flops(M=2, N=1, I=1, T=1) == 20
    # X 2 complex64 (16 bytes), one float32 weight (4), the half of the output, 3 complex64 (24)
    assert k1_roofline.nbytes(M=2, N=1, I=1, T=1, per_bin=False) == 44
    # two bins, three frames, two sources: X 2*2*3 complex64, weights 2*3 (or 2*2*3) float32, output 2*2*3 complex64
    assert k1_roofline.flops(M=2, N=2, I=2, T=3) == 2 * 3 * (12 + 2 * 8)
    assert k1_roofline.nbytes(M=2, N=2, I=2, T=3, per_bin=False) == 96 + 24 + 96
    assert k1_roofline.nbytes(M=2, N=2, I=2, T=3, per_bin=True) == 96 + 48 + 96


def test_ip1_sweep_counts():
    # one bin, N = M = 2: per source W U_n 8*8 = 64, the LU 64/3, the two triangular solves and U_n w 16*4 = 64,
    # w^H U_n w 16
    assert k1b_roofline.flops(bins=1, N=2, M=2) == pytest.approx(2 * (64 + 64 / 3 + 64 + 16))
    # W read and written (2 * 4 complex64) and each U_n's upper half (2 * 3 complex64)
    assert k1b_roofline.nbytes(bins=1, N=2, M=2) == 64 + 48


def test_least_time_and_its_bound():
    assert peaks.least_seconds(H100, 495e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(H100, 0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_seconds("some other card", 1.0, 1.0) is None
    # at the benchmark's K1 shape the bytes govern: 10,908,608 bytes over 3.35 TB/s
    flops, nbytes = k1_roofline.flops(8, 8, 257, 626), k1_roofline.nbytes(8, 8, 257, 626, False)
    assert nbytes == 8 * 8 * 257 * 626 + 4 * 8 * 626 + 8 * 257 * 8 * 36
    assert peaks.least_seconds(H100, flops, nbytes) == pytest.approx(nbytes / 3.35e12)


def test_each_algorithm_counts_its_own_call():
    s = {"B": 2, "M": 2, "N": 2, "I": 3, "T": 4, "K": 2, "n_iter": 5, "n_fft": 4}
    ilrma, iva = gauss_ilrma_ip1.call_flops(s), auxiva_ip1.call_flops(s)
    assert ilrma - iva == 2 * 5 * (14 * 2 * 3 * 2 * 4 + 8 * 3 * 4 * 2 * 2 + 4 * 2 * 3 * 4)
    # the STFT of 2 channels and the iSTFT of 2 sources, 4 frames of a 4-point FFT; 5 iterations; the last product
    transforms = 4 * 4 * (2.5 * 4 * 2 + 4)
    per_iter = 8 * 3 * 4 * 2 * 2 + 4 * 2 * 3 * 4 + k1_roofline.flops(2, 2, 3, 4) + k1b_roofline.flops(3, 2, 2)
    assert iva == 2 * (transforms + 5 * per_iter + 8 * 3 * 4 * 2 * 2)


def test_step_mfu_reads_the_count_of_the_configurations_algorithm():
    trace = type("Trace", (), {"calls": [(0.0, 1e6)]})()  # one call of one second
    s = {"B": 1, "M": 8, "N": 8, "I": 257, "T": 626, "K": 0, "n_iter": 100, "n_fft": 512}
    ctx = {"reference": auxiva_ip1, "shapes": s, "device_name": H100, "config": {"algorithm": "auxiva_ip1"}}
    assert step_mfu.read(trace, ctx) == pytest.approx(100 * auxiva_ip1.call_flops(s) / 495e12)
    with pytest.raises(AttributeError, match="no call_flops"):
        step_mfu.read(trace, {**ctx, "reference": types.ModuleType("bssbench.reference.new_algorithm"),
                              "config": {"algorithm": "new_algorithm"}})
