"""The trace's interval arithmetic and the per-layer readers on a synthetic trace."""

import pytest

from bssbench import tracing
from bssbench.metrics import (device_idle, device_ms_per_iter, host_exposed_ms, k1_roofline, k1b_roofline,
                              launches_per_iter, memcpy_ms)
from bssbench.tracing import DeviceEvent, HostEvent, Trace

H100 = "NVIDIA H100 80GB HBM3"


def synthetic() -> Trace:
    """Two calls of 1,000 us with a 100 us host gap between them (times in us)."""
    device = [
        DeviceEvent("memcpy", "Memcpy HtoD (Pageable -> Device)", 50, 150),
        DeviceEvent("kernel", "void weighted_covariance_kernel<8, 8, true>(...)", 200, 300),
        DeviceEvent("kernel", "ampere_cgemm", 280, 500),  # overlaps the one before: the union counts it once
        DeviceEvent("kernel", "void ip1_sweep_kernel_warp<8>(...)", 600, 650),
        DeviceEvent("memcpy", "Memcpy DtoH (Device -> Pageable)", 900, 980),
        DeviceEvent("memcpy", "Memcpy DtoD (Device -> Device)", 980, 990),
        DeviceEvent("kernel", "void weighted_covariance_kernel<8, 8, true>(...)", 1200, 1400),
        DeviceEvent("kernel", "void ip1_sweep_kernel_warp<8>(...)", 1400, 1500),
        DeviceEvent("memset", "Memset (Device)", 1500, 1510),
        DeviceEvent("kernel", "spin_kernel", -500, -400),  # outside every call
    ]
    host = [
        HostEvent("bssbench.call", 0, 1000), HostEvent("bssbench.entry", 0, 890), HostEvent("aten::einsum", 150, 200),
        HostEvent("bssbench.call", 1100, 2100), HostEvent("bssbench.entry", 1100, 2000),
        HostEvent("aten::linalg_inv_ex", 1600, 1900),
    ]
    return Trace(calls=[(0, 1000), (1100, 2100)], device=device, host=host, launches=9)


def test_union_covered_and_gaps():
    merged = tracing.union([(5, 7), (0, 2), (1, 3), (3, 4)])
    assert merged == [(0, 4), (5, 7)]
    assert tracing.covered(merged, 1, 6) == 4
    assert tracing.gaps(merged, -1, 8) == [(-1, 0), (4, 5), (7, 8)]


def test_events_belong_to_the_call_that_holds_them():
    trace = synthetic()
    first, second = trace.in_calls()
    assert len(first) == 6 and len(second) == 3
    assert trace.seen() == 9 == trace.launches


def test_busy_idle_and_the_breakdown():
    trace = synthetic()
    # in [0, 2100]: 50-150, 200-500, 600-650, 900-990, 1200-1510 are busy: 100 + 300 + 50 + 90 + 310 = 850
    assert tracing.busy_us(trace) == pytest.approx(850)
    assert device_idle.read(trace, {}) == pytest.approx(100 * (1 - 850 / 2100))
    ops = dict(tracing.device_ops(trace))
    assert ops["void weighted_covariance_kernel<8, 8, true>(...)"] == pytest.approx(300e-6)
    assert "spin_kernel" not in ops
    gaps = dict(tracing.idle_gaps(trace))
    # the gaps by the innermost host operation that holds their midpoint
    assert gaps["aten::linalg_inv_ex"] == pytest.approx(590e-6)  # 1510-2100: its midpoint 1805 in 1600-1900
    assert gaps["aten::einsum"] == pytest.approx(50e-6)  # 150-200
    assert gaps["bssbench.entry"] == pytest.approx((50 + 100 + 250) * 1e-6)  # 0-50, 500-600, 650-900
    assert gaps["host: none"] == pytest.approx(210e-6)  # 990-1200 holds 1095, between the calls
    assert sum(gaps.values()) == pytest.approx((2100 - 850) * 1e-6)


def test_readers():
    trace = synthetic()
    ctx = {"shapes": {"n_iter": 2, "B": 1, "M": 8, "N": 8, "I": 257, "T": 626}, "config": {"weights_per_bin": False},
           "device_name": H100}
    # call 1: 1,000 us less 540 of device work; call 2: 1,000 less 310
    assert host_exposed_ms.read(trace, ctx) == pytest.approx((0.46 + 0.69) / 2)
    assert memcpy_ms.read(trace, ctx) == pytest.approx((0.1 + 0.08) / 2)  # HtoD and DtoH only
    assert device_ms_per_iter.read(trace, ctx) == pytest.approx((0.37 + 0.3) / 2 / 2)
    assert launches_per_iter.read(trace, ctx) == pytest.approx(5 / 2 / 2)
    least = 3.2563e-6  # K1 at (8, 8, 257, 626), by its bytes
    assert k1_roofline.read(trace, ctx) == pytest.approx(100 * least * 2 * 2 / 300e-6, rel=1e-4)
    assert k1b_roofline.read(trace, ctx) == pytest.approx(100 * 0.2553e-6 * 2 * 2 / 150e-6, rel=1e-3)
    assert k1_roofline.read(trace, dict(ctx, device_name="cpu")) is None


def test_readers_find_nothing_in_an_empty_trace():
    trace = Trace(calls=[(0, 10)], device=[])
    ctx = {"shapes": {"n_iter": 1, "B": 1, "M": 2, "N": 2, "I": 1, "T": 1}, "config": {"weights_per_bin": False},
           "device_name": H100}
    for reader in (memcpy_ms, device_ms_per_iter, launches_per_iter, k1_roofline, k1b_roofline, device_idle):
        assert reader.read(trace, ctx) is None
