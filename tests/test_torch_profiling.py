"""The port's profiling helpers (``ssspy_tpu_torch.utils.profiling``) on the CPU.

``timed`` and ``compiled_stats`` as ``tests/utils/test_utils.py`` holds the
JAX ones, and what the port's ``compiled_stats`` can measure without a
card; ``trace`` writes a Chrome / TensorBoard trace of a separator's run.
The readers of device time (``chain``, ``profile``, ``profiled_us``) are
held on fakes of ``torch.profiler`` in ``tests/test_torch_kernels.py``.
"""

import glob
import json
import os

import torch

from ssspy_tpu_torch.bss import AuxLaplaceIVA
from ssspy_tpu_torch.ops import kernels
from ssspy_tpu_torch.utils import host_stft, make_mixture
from ssspy_tpu_torch.utils.profiling import compiled_stats, timed, trace

torch.set_num_threads(1)


def test_profiling_timed_and_stats():
    def f(x):
        return (x @ x.T).sum()

    x = torch.ones((64, 64))
    seconds, result = timed(f, x, warmup=1, repeat=2)
    assert seconds >= 0
    assert float(result) == 64 * 64 * 64

    stats = compiled_stats(f, x)
    assert stats is None or "flops" in stats


def test_compiled_stats_counts_the_products_and_no_card_memory_on_the_cpu():
    x = torch.ones((64, 32), dtype=torch.float64)
    stats = compiled_stats(lambda a: (a @ a.T).sum(), x)
    assert stats == {"flops": 2 * 64 * 64 * 32, "bytes_accessed": None, "peak_bytes": None}


def test_compiled_stats_gives_no_flops_where_a_kernel_launched(monkeypatch):
    """The counter cannot see a hand-written kernel's work: a launch in the call leaves ``flops`` unknown."""
    monkeypatch.setattr(kernels.ip1_sweep, "launches", kernels.ip1_sweep.launches)

    def launching(a):
        kernels.ip1_sweep.launches += 1  # as the wrapper counts a launch on the card
        return a @ a

    assert compiled_stats(launching, torch.ones((8, 8)))["flops"] is None


def test_trace_writes_a_chrome_trace_of_a_separator(tmp_path):
    x = make_mixture(seed=0, n_channels=2, duration_s=0.05)
    X = torch.from_numpy(host_stft(x, n_fft=32, hop=16))
    log_dir = str(tmp_path / "trace")
    with trace(log_dir):
        AuxLaplaceIVA(spatial_algorithm="IP1", device="cpu")(X, n_iter=2)
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        names = {event.get("name", "") for event in json.load(f)["traceEvents"]}
    assert any(name.startswith("aten::") for name in names)
