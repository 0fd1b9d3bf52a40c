"""The port's example scripts on the card's branch, driven on the CPU: what each branch other than the default launches.

Every branch of ``chip_smoke.py``'s ``EXAMPLE_RUNS`` (the table its
``[examples]`` phase holds the card to) but the scripts' default branches
runs on a 0.25 s cut of its script's mixture (``separate_ipsdta --fast``
on a 1 s cut, on which its 64 blocks stay finite; ``separate_prox_iva
--admm`` on all of it: on a cut ADMMIVA leaves float32, in the JAX package
too, tests/test_torch_examples_prox.py) with each kernel wrapper replaced by its
own checks (all but the device), a count and its plain version
(``torch_examples_helpers.counting``): each branch must launch exactly the
kernels, and as often, as the table says (iteration counts do not depend
on the length); the complex128 class branches none. The default branches
are held to the table through each script's ``main``, in
tests/test_torch_examples_main.py.
"""

import numpy as np
import pytest
import torch

from .torch_examples_helpers import CUT, counting, cut_mixture, example_runs, load

torch.set_num_threads(1)

# batch_mesh's ranks launch in their own processes
BRANCHES = [run for run in example_runs() if run[1] and run[2] is not None]
SHORT = 4_000  # a quarter second: the launches follow the iterations, not the length
CUTS = {"separate_ipsdta": CUT, "separate_prox_iva": None}


@pytest.mark.parametrize("name, kwargs, uses", BRANCHES, ids=[" ".join([n, *k]) for n, k, _ in BRANCHES])
def test_each_branch_launches_what_chip_smoke_holds_it_to(monkeypatch, tmp_path, name, kwargs, uses):
    counts = counting(monkeypatch)
    script = load(name)
    if name == "batch_mesh":
        mix = [cut_mixture(tmp_path, cut=SHORT, **script.MIXTURE, seed=seed)[0] for seed in script.SEEDS]
    else:
        mix, _ = cut_mixture(tmp_path, cut=CUTS.get(name, SHORT), **script.MIXTURE)
    y = script.run(mix, device="cpu", **kwargs)
    assert np.isfinite(y).all()
    assert {k: v for k, v in counts.items() if v} == uses
