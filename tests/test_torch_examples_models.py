"""The complex64 kernel paths of the model scripts (FastGaussMNMF, IPSDTA, cACGMM, HVA) against the JAX scripts.

As ``tests/test_torch_examples_fast.py`` holds the IVA, ILRMA, FDICA and
fixed-point scripts (``torch_examples_helpers.hold_kernel_path``): each
``--fast`` branch on a 1 s cut (the first 16,000 samples) of its own
mixture, at the script's own keywords, STFT and iterations, against the
JAX script's float32 fast path on the same cut; the worst per-source SI-SDR
at least 30 dB (cACGMM's sources matched by the best permutation first).
Dense GaussMNMF is in tests/test_torch_examples_dense.py.
"""

import pytest
import torch

from .torch_examples_helpers import CUT, hold_kernel_path

torch.set_num_threads(1)

# (script, port keywords of run, the JAX script's command line)
MODEL_BRANCHES = [
    ("separate_mnmf", {"fast": True}, ["--fast"]),
    ("separate_ipsdta", {"fast": True}, ["--fast"]),
    ("separate_cacgmm", {"fast": True}, ["--fast"]),
    ("separate_hva", {"fast": True}, ["--fast"]),
]


@pytest.mark.parametrize("name, kwargs, argv", MODEL_BRANCHES, ids=[" ".join([n, *a]) for n, _, a in MODEL_BRANCHES])
def test_kernel_path_matches_the_jax_fast_path(monkeypatch, tmp_path, name, kwargs, argv):
    hold_kernel_path(monkeypatch, tmp_path, name, kwargs, argv, CUT)
