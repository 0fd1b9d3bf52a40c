"""``separate_gauss_mnmf_dense`` (dense GaussMNMF), both branches, against the JAX script on the CPU.

The class branch in complex128 as tests/test_torch_examples.py holds the
class branches (``hold_class_branch``), the ``--fast`` branch in complex64
as tests/test_torch_examples_fast.py holds the kernel paths
(``hold_kernel_path``: 30 dB against the JAX float32 fast path), each on a
1 s cut (the first 16,000 samples) of the script's mixture, at its
``n_basis=4``, STFT 512/256 and 30 iterations. The heaviest model, in a
file of its own (the JAX package compiles each branch's step for ~20 s).
"""

import torch

from .torch_examples_helpers import CUT, hold_class_branch, hold_kernel_path

torch.set_num_threads(1)


def test_class_branch_matches_the_jax_script(monkeypatch, tmp_path):
    hold_class_branch(monkeypatch, tmp_path, "separate_gauss_mnmf_dense", {}, [])


def test_kernel_path_matches_the_jax_fast_path(monkeypatch, tmp_path):
    hold_kernel_path(monkeypatch, tmp_path, "separate_gauss_mnmf_dense", {"fast": True}, ["--fast"], CUT)
