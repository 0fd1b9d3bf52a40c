"""The complex128 class branches of the model scripts (FastGaussMNMF, IPSDTA, cACGMM) against the JAX scripts'.

As tests/test_torch_examples.py holds the other scripts
(``torch_examples_helpers.hold_class_branch``): each on a 1 s cut (the
first 16,000 samples) of its own mixture, at the script's own keywords,
STFT and iterations, in complex128, within 1e-9 of the JAX output's
largest magnitude or, where the path amplifies rounding, within 10 times
the JAX script's own one-ulp control; cACGMM within ``CACGMM_ATOL`` (its
E-step's eigenvalue floor, a listed departure). Dense GaussMNMF is in
tests/test_torch_examples_dense.py.
"""

import pytest
import torch

from .torch_examples_helpers import hold_class_branch

torch.set_num_threads(1)

# (script, port keywords of run, the JAX script's command line)
CLASS_BRANCHES = [
    ("separate_mnmf", {}, []),
    ("separate_ipsdta", {}, []),
    ("separate_cacgmm", {}, []),
]


@pytest.mark.parametrize("name, kwargs, argv", CLASS_BRANCHES, ids=[n for n, _, _ in CLASS_BRANCHES])
def test_class_branch_matches_the_jax_script(monkeypatch, tmp_path, name, kwargs, argv):
    hold_class_branch(monkeypatch, tmp_path, name, kwargs, argv)
