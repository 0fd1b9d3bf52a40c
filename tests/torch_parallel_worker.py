"""The ranks of tests/test_torch_parallel.py and tests/test_torch_parallel_runners.py: the runners of
``ssspy_tpu_torch.parallel`` over one spawned world.

Imported by the spawned ranks, so it imports no JAX (the JAX references
run in the test's own process). Each rank runs every case of
:data:`ssspy_tpu_torch.parallel.dryrun.CASES` but :data:`RUNNERS` in complex128 on the CPU
at :data:`N_BINS` bins (:data:`WIDE` also at 257), which no bin layout of 2 or 4 ranks divides, and
returns the global outputs, the all-reduces through the bin hook, the
two losses computed on the rank's own bins under the hook and whether a
second layout reused the first one's bin group (:func:`run_world`); or
each of :data:`RUNNERS` and :data:`EXTRA` at :data:`RUNNER_BINS` bins,
with the outputs and all-reduces (:func:`run_runner_world`).
"""

import numpy as np
import torch

from ssspy_tpu_torch.ops.ilrma_steps import ilrma_loss
from ssspy_tpu_torch.ops.iva_steps import iva_laplace_loss
from ssspy_tpu_torch.parallel import (
    _extent,
    make_batched_grad_iva_runner,
    make_batched_ica_runner,
    make_layout,
)
from ssspy_tpu_torch.parallel.dryrun import CASES, N_STEPS, make_inputs, run_case

N_BINS = 33
N_BATCH = 2
REAL = np.float64
# these runners also run at the dry run's 257 bins (n_fft = 512)
WIDE = ("ip1", "iss1", "ilrma")
WIDE_BINS = 257
# the runners of tests/test_torch_parallel_runners.py, at bin counts that 2 and 4 shards do not and do divide
RUNNERS = ("fast_iva", "faster_iva", "fdica_ip1", "fdica_ip2", "grad_iva", "grad_fdica", "fast_mnmf", "pds_iva",
           "admm_iva", "hva", "ica")
RUNNER_BINS = (33, 32)
# the cases of :func:`run_world`: the others
WORLD_CASES = tuple(name for name in CASES if name not in RUNNERS)
# the other variants of two of them: (factory, the case whose inputs they take)
EXTRA = {
    "grad_iva_natural": (lambda layout: make_batched_grad_iva_runner(layout, natural=True), "grad_iva"),
    "ica_grad": (lambda layout: make_batched_ica_runner(layout, variant="grad"), "ica"),
}


def inputs(name: str, n_bins: int = N_BINS) -> tuple:
    return make_inputs(name, n_batch=N_BATCH, n_bins=n_bins, real=REAL)


def run_world(shape) -> dict:
    layout = make_layout(shape=shape, device="cpu")
    again = make_layout(shape=shape, device="cpu")  # no new group: the first layout's is reused
    report = {"shape": layout.shape, "cases": {},
              "bin_group_reused": layout.bin_sum is None or again.bin_sum.group is layout.bin_sum.group}
    for name in WORLD_CASES:
        before = 0 if layout.bin_sum is None else layout.bin_sum.calls
        outputs = run_case(name, layout, inputs(name))
        calls = (0 if layout.bin_sum is None else layout.bin_sum.calls) - before
        report["cases"][name] = {"outputs": [o.numpy() for o in outputs], "calls": calls}
    for name in WIDE:
        report["cases"][f"{name}@{WIDE_BINS}"] = {
            "outputs": [o.numpy() for o in run_case(name, layout, inputs(name, WIDE_BINS))]
        }

    # the losses of utterance 0 on the rank's bins alone, summed over the row by the hook
    ext = _extent(layout, N_BINS)
    bins = slice(ext.first, ext.first + ext.real)  # the real bins the rank holds
    X, W0 = torch.as_tensor(inputs("ip1")[0][0]), torch.as_tensor(report["cases"]["ip1"]["outputs"][0][0])
    report["iva_loss"] = float(iva_laplace_loss(X[:, bins], W=W0[bins], bin_sum=layout.bin_sum))
    X = torch.as_tensor(inputs("ilrma")[0][0])
    W0, T0, V0 = (torch.as_tensor(o[0]) for o in report["cases"]["ilrma"]["outputs"])
    report["ilrma_loss"] = float(ilrma_loss(X[:, bins], T0[:, bins], V0, W=W0[bins], bin_sum=layout.bin_sum))
    return report


def runner_inputs(name: str, n_bins: int) -> tuple:
    return inputs(EXTRA[name][1] if name in EXTRA else name, n_bins)


def run_runner_world(shape) -> dict:
    layout = make_layout(shape=shape, device="cpu")
    report = {"shape": layout.shape, "cases": {}}
    for n_bins in RUNNER_BINS:
        for name in RUNNERS + tuple(EXTRA):
            before = 0 if layout.bin_sum is None else layout.bin_sum.calls
            args = runner_inputs(name, n_bins)
            if name in EXTRA:
                outputs = (EXTRA[name][0](layout)(args[0], args[1], N_STEPS),)
            else:
                outputs = run_case(name, layout, args)
            calls = (0 if layout.bin_sum is None else layout.bin_sum.calls) - before
            report["cases"][f"{name}@{n_bins}"] = {"outputs": [o.numpy() for o in outputs], "calls": calls}
    return report
