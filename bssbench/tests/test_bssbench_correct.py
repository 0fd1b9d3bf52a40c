"""What decides ``correct``: a sound run passes; the control and each fault a cell can have fail.

Each test drives a whole run on the CPU (``harness.run`` with ``device="cpu"``, past the look for a card) at a
size a test can hold: 4 channels, 1 s recordings, 20 iterations, against the cells' own limits.
"""

import pytest
import torch

import ssspy_tpu_torch.fast
import ssspy_tpu_torch.ops.iva_steps
import ssspy_tpu_torch.parallel
import ssspy_tpu_torch.transform
from bssbench import harness, mixture
from conftest import ROOT

BATCHED, ILRMA, SINGLE = "auxiva_ip1_8ch.batch16_10s", "gauss_ilrma_ip1_8ch.single_60s", "auxiva_ip1_8ch.single_60s"


def small(workload: str) -> harness.Cell:
    cell = harness.Cell(ROOT, workload)
    cell.config.update(n_channels=4, n_sources=4, n_iter=20)
    batch = 4 if cell.traffic["recordings_per_call"] > 1 else 1
    cell.traffic.update(recording_seconds=1.0, recordings_per_call=batch, pool=2, compare_calls=2)
    return cell


def run(cell: harness.Cell, seed: int = 2**31 + 3) -> dict:
    result, checks, _ = harness.run(cell, seed, 0.3, False, "cpu")
    assert list(result)[-1] == "checks" and result["checks"] is checks
    return result


@pytest.mark.parametrize("workload", [BATCHED, ILRMA, SINGLE])
def test_a_sound_run_is_correct(workload):
    result = run(small(workload))
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    for name in harness.NUMBERS:
        assert result["checks"][name]["value"] < result["checks"][name]["limit"]


@pytest.mark.parametrize("workload", [BATCHED, ILRMA])
def test_the_control_fails(workload):
    cell = small(workload)
    pool = mixture.make_pool(5, cell.config, cell.traffic)
    found = harness.control_numbers(cell, pool, [0, 1], "cpu")
    assert any(found[name] > cell.limits[name]["limit"] for name in harness.NUMBERS)


def _unchanged_iva(X, W, eps=1e-10, bin_sum=None):
    return W


def _unchanged_ilrma(X, W, *factors, **kwargs):
    return (W, *factors)


@pytest.mark.parametrize("workload", [BATCHED, ILRMA, SINGLE])
def test_a_step_that_returns_its_state_fails(workload, monkeypatch):
    monkeypatch.setattr(ssspy_tpu_torch.ops.iva_steps, "auxiva_ip1_step", _unchanged_iva)
    monkeypatch.setitem(ssspy_tpu_torch.fast._AUXIVA_STEPS, "IP1", _unchanged_iva)
    monkeypatch.setattr(ssspy_tpu_torch.fast, "ilrma_ip_step", _unchanged_ilrma)
    result = run(small(workload))
    assert result["correct"] is False and result["checks"][harness.GAP_P90]["value"] > 0.1


def test_half_the_batch_left_out_fails(monkeypatch):
    real = ssspy_tpu_torch.parallel.make_batched_auxiva_wave_runner

    def half(layout=None, **kwargs):
        inner = real(layout, **kwargs)

        def run_half(waveforms, n_iter):
            k = waveforms.shape[0] // 2
            y = inner(waveforms[:k], n_iter)
            return torch.cat([y, y[: waveforms.shape[0] - k]])

        return run_half

    monkeypatch.setattr(ssspy_tpu_torch.parallel, "make_batched_auxiva_wave_runner", half)
    assert run(small(BATCHED))["correct"] is False


@pytest.mark.parametrize("workload", [BATCHED, ILRMA])
def test_an_answer_altered_where_it_is_made_fails(workload, monkeypatch):
    real = ssspy_tpu_torch.transform.istft

    def swapped(Y, **kwargs):  # the first two sources of the first recording change places
        y = real(Y, **kwargs).clone()
        first = y[0] if y.dim() == 3 else y
        first[[0, 1]] = first[[1, 0]]
        return y

    monkeypatch.setattr(ssspy_tpu_torch.transform, "istft", swapped)
    monkeypatch.setattr(ssspy_tpu_torch.fast, "istft", swapped)
    assert run(small(workload))["correct"] is False


@pytest.mark.parametrize("workload", [BATCHED, ILRMA, SINGLE])
def test_a_block_of_bins_altered_where_it_is_made_fails(workload, monkeypatch):
    real = ssspy_tpu_torch.transform.istft
    lo, hi = 100, 118  # 18 of 257 bins, fewer than the 90th percentile leaves out, each 5% low

    def blocked(Y, **kwargs):
        Y = Y.clone()
        Y[..., lo:hi, :] *= 0.95
        return real(Y, **kwargs)

    monkeypatch.setattr(ssspy_tpu_torch.transform, "istft", blocked)
    monkeypatch.setattr(ssspy_tpu_torch.fast, "istft", blocked)
    result = run(small(workload))
    checks = result["checks"]
    assert result["correct"] is False
    assert checks[harness.GAP_P90]["value"] <= checks[harness.GAP_P90]["limit"]  # the percentile alone misses it
    assert checks[harness.BINS_OVER]["value"] >= hi - lo > checks[harness.BINS_OVER]["limit"]


def test_a_call_that_raises_in_the_window_is_counted_and_fails(monkeypatch):
    real, calls = ssspy_tpu_torch.fast.fast_auxiva_wave, []

    def fails_third(*args, **kwargs):  # the two warm-up calls pass, the window's first raises
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("broken on purpose")
        return real(*args, **kwargs)

    monkeypatch.setattr(ssspy_tpu_torch.fast, "fast_auxiva_wave", fails_third)
    result = run(small(SINGLE))
    assert result["correct"] is False and result["failed"] == 1 and result["attempted"] == 1
    assert result["checks"]["calls_failed"] == {"value": 1, "limit": 0}
