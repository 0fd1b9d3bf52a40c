"""The complex64 kernel paths of ``separate_prox_iva`` (PDSIVA, ``--admm``: ADMMIVA) against the JAX script.

As ``tests/test_torch_examples_fast.py`` holds the other scripts
(``torch_examples_helpers.hold_kernel_path``), on the script's whole 4 s
mixture, not the 1 s cut: on the cut the proximal steps amplify rounding
in both packages (the JAX script's own one-ulp control ends at -1.8 dB
against it after 100 PDS iterations) and ADMMIVA leaves float32 before its
200th iteration in both. On the whole mixture ADMMIVA still amplifies
rounding (its one-ulp control keeps 11.7 dB against the JAX output) and is
held on its loss, AuxLaplaceIVA's (the L21 penalty and -log|det W|) of the
fast path's input and filters, within 10 times the control's gap.
"""

import pytest
import torch

from ssspy_tpu_torch.ops.iva_steps import iva_laplace_loss

from .torch_examples_helpers import hold_kernel_path

torch.set_num_threads(1)

# (script, port keywords of run, the JAX script's command line)
PROX_BRANCHES = [
    ("separate_prox_iva", {}, []),
    ("separate_prox_iva", {"admm": True}, ["--admm"]),
]
# the fast path each branch calls and the port's loss of its (X, W), for a branch held on its loss
LOSSES = {
    "separate_prox_iva": ("fast_pds_iva", iva_laplace_loss),
    "separate_prox_iva --admm": ("fast_admm_iva", iva_laplace_loss),
}


@pytest.mark.parametrize("name, kwargs, argv", PROX_BRANCHES, ids=[" ".join([n, *a]) for n, _, a in PROX_BRANCHES])
def test_kernel_path_matches_the_jax_fast_path(monkeypatch, tmp_path, name, kwargs, argv):
    hold_kernel_path(monkeypatch, tmp_path, name, kwargs, argv, cut=None, losses=LOSSES)
