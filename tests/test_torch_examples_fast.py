"""The complex64 kernel paths of the port's example scripts against the JAX scripts' float32 fast paths, on the CPU.

Each script's branch that runs the port's complex64 path (``--fast``, and
the scripts that have only that path: ``separate_f32_mode``,
``separate_tilrma``, ``separate_fixed_point_iva``) runs at the script's
own algorithm, keywords, STFT and iterations against the JAX script run as
its command line gives it on the same mixture
(``torch_examples_helpers.run_jax_script``), a 1 s cut (the first 16,000
samples) of the script's own. On the CPU the port's kernel wrappers take
their plain versions; the JAX package runs its float32 fast paths.

Complex64 against float32 planes, in other orders of summation: the worst
per-source SI-SDR of the port's separated waveforms against the JAX
script's must be at least ``MIN_SI_SDR_DB`` (30 dB, chip_smoke's gate of
a kernel path against its plain twin); cACGMM's sources are matched by the
best permutation first (its source labels are the alignment's choice).
Where the SI-SDR misses, the JAX script runs once more on its mixture
times (1 + 1e-7 noise), one float32 ulp; if that control keeps 10 dB more
than the gate against the JAX output, the miss fails. Otherwise the path
amplifies rounding (AuxLaplaceFDICA's 100 iterations on the cut) and is
held on its loss, the fast path's input
and demixing filters through the port's loss of the family: the port's
relative loss gap to the JAX run within ``CONTROL_MULTIPLE`` times the
control's, as chip_smoke.py holds FDICA.

The model scripts are in tests/test_torch_examples_models.py and
tests/test_torch_examples_dense.py, the proximal ones in
tests/test_torch_examples_prox.py, with the same machinery
(``torch_examples_helpers.hold_kernel_path``).
"""

import pytest
import torch

from ssspy_tpu_torch.ops.fdica_steps import fdica_laplace_loss

from .torch_examples_helpers import CUT, hold_kernel_path

torch.set_num_threads(1)

# (script, port keywords of run, the JAX script's command line): the IVA, ILRMA, FDICA and fixed-point scripts
FAST_BRANCHES = [
    ("separate_auxiva", {"fast": True}, ["--fast"]),
    ("separate_f32_mode", {}, []),
    ("separate_ilrma", {"fast": True}, ["--fast"]),
    ("separate_tilrma", {}, []),
    ("separate_tilrma", {"ggd": True}, ["--ggd"]),
    ("separate_fdica", {"fast": True}, ["--fast"]),
    ("separate_fixed_point_iva", {}, []),
    ("separate_fixed_point_iva", {"faster": True}, ["--faster"]),
]
# the branches held on their loss where the SI-SDR cannot tell: the fast path each calls, and its loss of (X, W)
LOSSES = {"separate_fdica --fast": ("fast_aux_fdica", fdica_laplace_loss)}


@pytest.mark.parametrize("name, kwargs, argv", FAST_BRANCHES, ids=[" ".join([n, *a]) for n, _, a in FAST_BRANCHES])
def test_kernel_path_matches_the_jax_fast_path(monkeypatch, tmp_path, name, kwargs, argv):
    hold_kernel_path(monkeypatch, tmp_path, name, kwargs, argv, CUT, LOSSES)
