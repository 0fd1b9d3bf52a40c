#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ssspy_tpu_torch) on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``ssspy_tpu_torch/ops/csrc`` (one
``nvcc`` per source, all started together) and checks each against its
plain PyTorch version at the main-path shapes. Then it drives the port's
paths on the 8-channel, 10 s, 16 kHz synthetic mixture (STFT 512/256: 257
bins x 626 frames), 100 iterations each, through the entry points a user
calls, on the default device:

- AuxIVA-IP1: ``AuxLaplaceIVA(spatial_algorithm="IP")``,
  ``fast_auxiva(algorithm="IP1")`` and the waveform-to-waveform ``separate``;
- GaussILRMA-IP1 (``n_basis=8``): ``GaussILRMA(spatial_algorithm="IP")`` and
  ``fast_gauss_ilrma(algorithm="IP1")``;
- GaussILRMA-ISS1: ``GaussILRMA(spatial_algorithm="ISS1")``,
  ``fast_gauss_ilrma(algorithm="ISS1")`` and ``separate`` with it;
- AuxIVA-ISS1: ``AuxLaplaceIVA(spatial_algorithm="ISS1")`` and
  ``fast_auxiva(algorithm="ISS1")``;
- TILRMA and GGDILRMA, IP1 and ISS1, 10 iterations each;
- AuxIVA-IPA and GaussILRMA-IPA (``n_basis=8``, MM):
  ``fast_auxiva(algorithm="IPA")`` and ``fast_gauss_ilrma(algorithm="IPA")``,
  100 iterations each, whose congruence sweep launches the weighted
  covariance K1 once, and the Jacobi eigh K7 (the 14 x 14 embedded LQPQM
  pencil) and the congruence round K6 once per source, per iteration; and
  the classes ``AuxLaplaceIVA(spatial_algorithm="IPA")`` (100 iterations at
  its float32 floor, 10 at ``flooring_fn="f64"``) and
  ``GaussILRMA(spatial_algorithm="IPA")`` (10). The IPA paths are gated on
  their loss, not on an SI-SDR against the plain run: see the comment at
  their phase;
- the prox family: ``PDSIVA()`` and ``fast_pds_iva``, ``ADMMIVA()`` and
  ``fast_admm_iva``, ``HVA()`` and ``fast_hva``, and ``MaskingADMMHVA()``
  (10 iterations), all on the spectrogram divided by its spectral norm,
  scaled from a host copy by ``normalize_by_spectral_norm`` on the card
  (one K7 launch; the scaling tests/test_fast_fidelity.py:314-318 gives
  ADMM). There ``mu1 mu2 max_i ||X_i||^2 <= 1``, the PDS step-size
  condition; on the spectrogram over its largest magnitude (bench.py:413)
  it is broken by orders of magnitude and PDSIVA's loss climbs, in the
  JAX package too (tests/test_torch_prox.py). Each path launches the
  Jacobi eigh K7 once per iteration (the ADMM paths on the stacked left
  and right Grams, ``B = 2I``) and no other kernel, must stay finite, and
  the PDSIVA and ADMMIVA classes' loss must end below where it started.
  HVA's step also runs on the unscaled
  spectrogram, as bench.py:277-290 feeds it: its raw filter grows by
  orders of magnitude per iteration there and leaves f32 within a few
  iterations, in the JAX package's f32 step too (tests/test_hard_fidelity.py:27-32
  records the same growth); the iteration at which it does is printed, and
  must be the same through the kernel and through the plain version;
- dense GaussMNMF (``n_basis=8``, 8 sources): ``GaussMNMF`` and
  ``fast_gauss_mnmf_dense``, 100 iterations each, on the float32 route:
  the fused model pass K5 three times (twice the traces alone, once the
  sums alone) and the Jacobi eigh K7 twice per iteration (the geometric
  mean's 16 x 16 embedding and the new spatial covariances' eigenvalue
  floor, ``B = 2,056`` each);
  and 10 iterations of ``gauss_mnmf_step(psd_impl="eigh")`` with its loss,
  the unfused route: the inverse sandwich K4 three times per iteration and
  K7 on every PSD projection, ``B = 160,882`` for each model;
- IPSDTA (``n_basis=8``, 64 blocks: 63 of 4 bins and one of 5, the JAX
  package's timing configuration, scripts/tpu_bench.py:260-277):
  ``fast_gauss_ipsdta`` and ``fast_t_ipsdta`` (``dof=1000``), 20 iterations
  each, whose model inverse launches K3 three times per part and iteration
  and whose geometric mean (Gauss) or square roots (t) launch K7 once or
  twice per part; ``GaussIPSDTA``, which must equal the fast path from the
  same draws; and ``GaussIPSDTA`` in complex64 on the hard scenario of
  tests/test_hard_fidelity.py:352-400 (4 channels, 257 bins in 16 blocks of
  16 and 17 bins), where K3 takes m = 17 and the 34 x 34 embedded eigh takes
  ``torch.linalg.eigh``, held to its fidelity pin;
- FastGaussMNMF (``n_basis=4``) on the mixture's first 4 channels, as
  bench.py:230-252 runs it: ``FastGaussMNMF`` and ``fast_gauss_mnmf``, 100
  iterations each, the weighted covariance K1 with per-channel weights
  ``(4, 257, 626)`` and the IP1 sweep K1b (``M = 4``, its warp variant) once
  per iteration; the class must equal the fast path from the same draws;
- cACGMM on all 8 channels (N = M = 8), as bench.py:255-274 runs it:
  ``CACGMM`` (aligned by its posterior score) and ``fast_cacgmm`` (aligned
  by amplitude correlation), 100 iterations each, the Jacobi eigh K7 on the
  E-step's and the M-step's embedded 16 x 16 pencils (``B = N I = 2,056``)
  twice per iteration; unaligned, the class must equal the fast path from
  the same draws; the EM once more with TF32 allowed, whose masks are
  printed against full float32; ``impl="chol"`` and the K1 covariance
  option run and are timed beside the default;
- both on the hard scenario at the STFT of tests/test_hard_fidelity.py:67
  (4096/1024, 2,049 bins, 4 channels): ``fast_cacgmm`` (50 iterations)
  within 0.1 dB of the pin ``hard_cacgmm`` and ``fast_gauss_mnmf`` (40)
  within 0.5 dB of ``hard_fast_gauss_mnmf``, and ``FastGaussMNMF`` once
  more in complex128, with how much of the float32 gap the basis and
  activation carry;
- the routers of K1, K1b, K2 and K6 on the card: AuxLaplaceIVA-IP1,
  GaussILRMA-ISS1 and AuxLaplaceIVA-IPA on a complex128 input (the plain
  versions, each within 1e-6 of the same class on the CPU), ``separate`` on
  a float64 waveform with GaussILRMA-ISS1, and ``fast_auxiva`` on 18
  channels (K1, and the plain IP1 sweep past K1b's 17); each prints the
  route it took;
- the waveform entry points ``fast_auxiva_wave`` and
  ``fast_gauss_ilrma_wave`` (IP1), each against ``stft``, the spectrogram
  path and ``istft`` on the same card;
- the pairwise updates: AuxIVA-IP2 and AuxIVA-ISS2 (``AuxLaplaceIVA`` and
  ``fast_auxiva``) and GaussILRMA-IP2 and GaussILRMA-ISS2 (``n_basis=8``,
  ``GaussILRMA`` and ``fast_gauss_ilrma``), 100 iterations each: IP2
  launches the weighted covariance K1 at two sources once a pair (eight
  times an iteration) in AuxIVA and once an iteration in ILRMA, and never
  the IP1 sweep K1b; ISS2 launches no kernel;
- FastIVA and FasterIVA (``FastIVA``/``FasterIVA`` and ``fast_fast_iva``/
  ``fast_faster_iva``), 100 iterations each: the whitening and the polar
  factor on the Jacobi eigh K7 (257 x 16 x 16), FasterIVA's per-source
  covariance on K1 and its top eigenvectors on K7 (2,056 x 16 x 16);
- GradIVA and NaturalGradIVA (Laplace, holonomic: ``GradLaplaceIVA``,
  ``NaturalGradLaplaceIVA`` and ``fast_grad_iva``), 100 iterations, no
  kernel;
- FastGaussMNMF with the IP2 diagonalizer (4 channels, ``n_basis=4``): K1
  once an iteration and four pair updates, no K1b;
- ``NaturalGradLaplaceICA`` on bench.py:370's configuration (the mixture's
  first two channels, float32, 100 iterations), no kernel, and on
  ``natural_grad_laplace_ica.npz`` in float64 within its 1e-6;
- FDICA: ``AuxLaplaceFDICA`` and ``fast_aux_fdica``, IP1 (K1 with per-scalar
  weights ``(8, 257, 626)`` and K1b once an iteration) and IP2 (K1 at two
  sources once a pair), 100 iterations, aligned across bins at 8 sources
  and projected back as a user calls them, and once unaligned and unscaled,
  held against the plain twin; ``GradLaplaceFDICA`` and
  ``NaturalGradLaplaceFDICA`` with ``fast_grad_fdica`` (holonomic and not),
  no kernel; each class's last iterate equals its fast path's to the bit;
  the easy-tier pins of all four, and ``fast_aux_fdica`` (IP1, 50
  iterations) on the hard scenario at STFT 4096/1024 within 0.4 dB of
  ``hard_aux_fdica_IP1``;
- the eigendecomposition-free routes, each from the same input as its eigh
  route: one IPA sweep's secular roots (``secular_impl="solve"``) against
  the root on K7's spectrum, and 10 iterations of AuxIVA-IPA with it against
  the eigh route's loss; the QDWH polar factor on FastIVA's input; the
  shift-invert top eigenvectors on FasterIVA's covariances against K7's top
  eigenvalues; and FastIVA (``polar_impl="qdwh"``) and FasterIVA
  (``eig_impl="solve"``: shift-invert and the QDWH polar, no K7) over 100
  steps with their launch counts, each against its eigh route's loss;
- the multi-device runners (``ssspy_tpu_torch.parallel``, ``[parallel]``
  lines): ``fast_auxiva_batch`` on two mixtures of the main configuration
  (seeds 0 and 1), 100 iterations in one process with no group, K1 once
  per utterance and K1b once per iteration, each utterance held against
  ``fast_auxiva`` on it (the main path's loss and SI-SDR gates), and the
  batched step's device time per utterance beside ``fast_auxiva``'s; the
  runners of the other families (FastIVA and FasterIVA on each mixture
  whitened, AuxFDICA IP1 and IP2, GradIVA, GradFDICA, FastGaussMNMF on the
  first 4 channels with ``n_basis = 4``, PDSIVA, ADMMIVA and HVA on each
  mixture over its spectral norm, time-domain ICA on the first 2 channels)
  at world size 1 on the same two mixtures, 5 steps (``N_ITER_RUNNERS``),
  each utterance held against its fast path (ICA: the class) with the path
  gates (FasterIVA on its loss alone), bit-equality printed, and the
  batched step's kernel time per utterance beside the fast path's (the
  summed durations of their kernels by ``torch.profiler``: AuxFDICA-IP2's
  host enqueues its thousands of launches a step slower than the card runs
  them, so an event pair would time the host); HVA and FastGaussMNMF at
  that width over 2 gloo ranks against world size 1, through the dry run's
  comparison (each rank's kernel calls held); then
  every runner (``parallel.dryrun.CASES``: AuxIVA IP1, IP2,
  ISS1, ISS2 and IPA, GaussILRMA-IP1, dense GaussMNMF with and without
  partitioning, cACGMM, GaussIPSDTA, the waveform runner, FastIVA,
  FasterIVA, AuxFDICA IP1 and IP2, GradIVA, GradFDICA, FastGaussMNMF,
  PDSIVA, ADMMIVA, HVA and time-domain ICA) at the JAX dry
  run's reduced shapes (257 bins, 2 steps, float32) over 2 and 4 gloo
  ranks sharing the card, layouts (1, 2) and (2, 2) (and NCCL ranks on
  cards of their own where there are several), each rank holding each
  runner against the same runner at world size 1 and its all-reduces per
  iteration against the JAX pins (HVA's against the port's 1, not the JAX
  package's 2: ``make_batched_hva_runner``); each runner's launches summed over the
  ranks must equal its count (``Case.launches``), and each rank holds every
  kernel call of its sharded run against the kernel's plain version at the
  rank's own shapes (M = N = 3, 32 frames, 129 of 257 bins, 65 of the
  waveform runner's 129, 17 of dense MNMF's 33, IPSDTA's 4 x 4 blocks), at
  the gates of phases 3-4g (RANK_KERNEL_TOLS);
- WAV in, separated WAVs out (``[wav]`` lines, 5o): the native codec built
  from ``ssspy_tpu_torch/native`` (the phase fails where it did not build);
  the peak-normalized mixture written as 8-channel 16-bit PCM by
  ``native.wav_write_i16`` and read back by ``wavread`` and
  ``native.wav_read``, which must agree to the bit; ``separate`` with
  AuxIVA-IP1 on what was read, 100 iterations, K1 and K1b once an
  iteration, equal to the bit to the same call on the quantized mixture in
  memory and held against its plain twin with the path gates; each source
  peak-normalized, written as mono by ``wavwrite`` and read back within
  ``WAV_SI_SDR_DB`` of itself;
- the spatial updates ``update_by_*`` at the main path's shapes in
  complex64 (``[update_by]``, 5p): ``update_by_ip1`` (K1b once) equal to
  ``ip1_update`` to the bit and within 1e-4 of the exact twin,
  ``update_by_iss1`` (K2 once) within 1e-4 of the plain version,
  ``update_by_ipa`` (K1 once, K7 and K6 once per source), each K6 round
  within 1e-5 and each K7 call equal to the plain version, its loss within
  3e-4 of the plain twin's; ``update_by_ip2``, ``update_by_iss2`` and
  ``update_by_block_decomposition_vcd`` (no kernel) in complex128 on the
  card within 1e-6 of the CPU, and finite in complex64;
- a ``flooring_fn`` that is not ``max(., eps)`` (``[flooring]``, 5q): one
  class or more of each family that takes one, with ``v + 1e-10`` in
  complex128 on the 4-channel 2 s cut of 5i, 10 iterations, no kernel
  launched and the loss within 1e-6 of the CPU's (the CPU twins run on a
  thread beside the card); AuxLaplaceIVA-IP1 at full width in complex64
  with ``v + 1e-6``, 20 iterations: K1 once an iteration and K1b never
  (the plain sweep), the loss falling; and the default floor, which still
  launches K1b;
- checkpoint / resume (``[checkpoint]``, 5r): ``AuxLaplaceIVA("IP")``,
  ``AuxLaplaceIVA("ISS1", scale_restoration=False)`` and
  ``GaussILRMA("IP", n_basis=8)`` (k = 50), ``CACGMM`` at 8 sources (25)
  and ``GaussIPSDTA`` (``n_basis=8``, 64 blocks: a basis of two parts; 10)
  run k iterations, save a checkpoint (``utils.checkpoint``), and a fresh
  instance resumes it for k more: its output and loss history must equal
  an uninterrupted run of 2k to the bit, both halves must launch their
  kernels (K1 and K1b, K2, K1 and K1b, K7, K3 and K7) exactly as often as
  the iterations make them, and the file must hold exactly the class's
  declared keywords (no unit input for cACGMM), in the JAX package's
  layout;
- the profiling helpers (``[profiling]``, 5s; ``utils.profiling``):
  ``trace`` around 10 ``fast_auxiva`` IP1 steps writes a Chrome trace that
  names K1's and K1b's kernels (up to three sessions, as a CUPTI session
  may drop events), ``timed`` on the same call reads more than 0 s, and
  ``compiled_stats`` on one step reads a peak of the card's memory above 0
  and no FLOP count, since hand-written kernels launched.

Each class there runs with the fast path's floor (``flooring_fn="f64"``
where its floor differs) and must equal its fast path to the bit; each path
that runs a kernel is held against its plain twin; each path that runs
none (ISS2, gradient IVA, ICA) is held to its easy-tier fidelity pin
(tests/fidelity_pins.json, on tests/test_fast_fidelity.py's mixture and
STFT) or fixture, and prints its loss against its complex128 (float64) run
on the card. AuxIVA-IP2 and FasterIVA also run once with TF32 allowed, and
print how far that moves their output.

K7 is held to its plain version bit for bit, at the prox and IPA inputs
and at the batches of the other paths (dense GaussMNMF's floor, IPSDTA's
geometric mean, the eigh model's 160,882 matrices, compared on 4,096 at
each end); K5 within 2e-4, and two launches of each to the bit. K1 is held
within 1e-5, Hermitian to the bit and two launches to the bit, at the main
path, at the edges of its geometry (frame counts of 1, 129 and 1,000,
the generic instance, the size contract's largest M, N and item count) and
at FastGaussMNMF's per-channel weights, at IP2's pair weights (N = 2,
``(2, T)`` and ``(2, I, T)``) and at FDICA's per-scalar weights (IP1's
``(8, I, T)``, IP2's ``(2, I, T)``), and K1b on FDICA's covariances; K7 also at cACGMM's E-step and M-step
pencils and at FasterIVA's top-eigenvector and polar inputs, and K1b at
FastGaussMNMF's diagonalizer (M = 4);
K3 bit for bit at every input (IPSDTA's two parts, m = 1 .. 8, 16, 17 and
32, batches of 1, 31 and 33) and within 1e-5. K1b is held within 1e-4 of
its exact elimination twin (silent bins frozen) and K2 within 1e-4 of its
plain version (silent bins exactly zero; at one frame to the bit), two
launches of each to the bit, at the main path and in every variant: K1b's
warp variant at M = 5 with a part-full block and its block variant at
M = 17; K2's register variant at 16 sources and 384 frames and at one
frame, its resident variant at 2,000 frames and its streamed variant on
the long case. K6 is held within 1e-5 (zero bins exactly zero, two
launches to the bit) on a random input, a sweep's first and last rounds
and two zero bins, and at N = 2, 7 and 16 (``IPA_EDGES``); K4 bit for bit
(two launches too) on the model after two iterations, on an edge batch
(zero XX bins, a tiny-Lamb bin, a zero R bin floored to 1e20 I), and in
its columns variant at m = 5 and its rows variant at m = 9 and 16
(``SANDWICH_EDGES``).

Every launch count is set to 0 just before a path and read just after it,
and each path must have launched the kernels it runs (and no other). The
outputs are held against the same iterations run through the plain
versions on the card. Last, it times each kernel against its plain
version, its bound and (where one exists) the one PyTorch call that
computes the same function, between CUDA events and (its own duration per
launch) by ``torch.profiler`` (the readers ``profiled_us`` and ``profile``
of ``ssspy_tpu_torch.utils.profiling``), beside the events its session saw of those
launched (a CUPTI session may drop some), and each path's iterations per
second and device time per iteration by ``torch.profiler``, read the
same way (each session opens with a spin kernel, and the events seen are
printed beside those its steps make; kernel names whose events do not
divide by the steps are listed apart, with the time read without
rounding them up). Each phase's seconds are printed as it ends
(``[phase]`` lines, the numbered sections of ``main``; section 6 in three:
the kernel times, the path rates, the profiles).

Run from the repository root, with one CUDA device:

    python3 chip_smoke.py

Each phase prints one line; any failure exits non-zero. The last three
lines are the kernels' JSON summary, the card as ``nvidia-smi`` names it,
and ``{"ok": true, "device": {...}}``, after a ``[done]`` line with the
script's seconds. Imports nothing of JAX.
"""

import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ssspy_tpu_torch import native, wavread, wavwrite
from ssspy_tpu_torch import separate as separate_waveform
from ssspy_tpu_torch.algorithm import correlation_based_permutation_solver, permutation_align
from ssspy_tpu_torch.bss import (
    ADMMIVA,
    CACGMM,
    GGDILRMA,
    HVA,
    PDSIVA,
    TIPSDTA,
    AuxGaussIVA,
    AuxLaplaceFDICA,
    AuxLaplaceIVA,
    FasterIVA,
    FastGaussMNMF,
    FastIVA,
    GaussILRMA,
    GaussIPSDTA,
    GaussMNMF,
    GradLaplaceFDICA,
    GradLaplaceIVA,
    MaskingADMMHVA,
    NaturalGradLaplaceFDICA,
    NaturalGradLaplaceICA,
    NaturalGradLaplaceIVA,
    TILRMA,
)
from ssspy_tpu_torch.bss._update_spatial_model import (
    update_by_block_decomposition_vcd,
    update_by_ip1,
    update_by_ip2,
    update_by_ipa,
    update_by_iss1,
    update_by_iss2,
)
from ssspy_tpu_torch.fast import (
    fast_admm_iva,
    fast_aux_fdica,
    fast_auxiva,
    fast_auxiva_batch,
    fast_auxiva_wave,
    fast_cacgmm,
    fast_fast_iva,
    fast_faster_iva,
    fast_grad_iva,
    fast_gauss_ilrma,
    fast_gauss_ilrma_wave,
    fast_gauss_ipsdta,
    fast_gauss_mnmf,
    fast_gauss_mnmf_dense,
    fast_grad_fdica,
    fast_hva,
    fast_pds_iva,
    fast_t_ipsdta,
)
from ssspy_tpu_torch.linalg import eig_free
from ssspy_tpu_torch.ops import _build
from ssspy_tpu_torch.ops import kernels as K
from ssspy_tpu_torch.ops import (
    cacgmm_steps,
    fast_mnmf_steps,
    fdica_steps,
    fixed_point_iva_steps,
    ipa_steps,
    ipsdta_steps,
    prox_steps,
)
from ssspy_tpu_torch.ops.ica_steps import grad_ica_step
from ssspy_tpu_torch.ops.ilrma_steps import ilrma_ip_step, ilrma_iss_step, ilrma_loss
from ssspy_tpu_torch.ops.mnmf_steps import (
    gauss_mnmf_loss,
    gauss_mnmf_step,
    instant_covariance,
    psd_project,
    wiener_separate,
)
from ssspy_tpu_torch.ops.iva_steps import (
    auxiva_ip1_step,
    auxiva_ip2_step,
    auxiva_ipa_step,
    auxiva_iss1_step,
    auxiva_iss2_step,
    grad_laplace_iva_step,
    ip1_update,
    iva_laplace_loss,
    separate,
)
from ssspy_tpu_torch.parallel import (
    make_batched_admm_iva_runner,
    make_batched_fast_iva_runner,
    make_batched_fast_mnmf_runner,
    make_batched_faster_iva_runner,
    make_batched_fdica_runner,
    make_batched_grad_fdica_runner,
    make_batched_grad_iva_runner,
    make_batched_hva_runner,
    make_batched_ica_runner,
    make_batched_pds_iva_runner,
    make_layout,
)
from ssspy_tpu_torch.parallel import dryrun as parallel_dryrun
from ssspy_tpu_torch.parallel.dryrun import CASES as PARALLEL_CASES, dryrun_multichip
from ssspy_tpu_torch.special.psd import eigh_in_batches
from ssspy_tpu_torch.transform import istft, stft
from ssspy_tpu_torch.utils import profiling
from ssspy_tpu_torch.utils.checkpoint import resume, save_checkpoint
from ssspy_tpu_torch.utils.dataset import HOP, N_FFT, hard_speech_mixture, make_mixture, sample_speech_mixture
# N_ITER (100: each path's iterations, chain's default) and N_TIMED (30: timed runs per measurement) come with the
# readers of device time
from ssspy_tpu_torch.utils.profiling import N_ITER, N_TIMED, chain, profile, profiled_us

N_ITER_MODELS = 10  # TILRMA / GGDILRMA
N_BASIS = 8  # bench.py:42
FAST_EPS = 1e-10  # fast_auxiva / auxiva_ip1_step default
ILRMA_EPS = 1e-6  # the ILRMA steps' f32 floor
WCOV_TOL = 1e-5  # both sides sum 626 f32 terms, in different orders
SWEEP_TOL = 1e-4
ISS1_TOL = 1e-4  # 626 f32 terms summed in different orders, over 8 sequential updates
LOSS_TOL = 1e-3
MIN_SI_SDR_DB = 30.0
SILENT_BINS = (0, 128)
SPIN_CYCLES = 20_000_000  # ~10 ms of device spin ahead of a "queued" timing
LONG_SHAPE = (8, 16, 4000)  # (N, I, T) whose bin exceeds shared memory: the streamed K2
# (M, I, variant): K1b's warp variant at an odd M and a part-full last block, and the block variant at its largest M
IP1_EDGES = ((5, 33, "warp"), (17, 9, "block"))
# (N, I, T, variant): K2's register variant at the most frames 16 sources hold and at one frame, and the
# resident variant past the register variant's frames
ISS1_EDGES = ((16, 9, 384, "registers"), (3, 33, 1, "registers"), (8, 3, 2000, "resident"))
# (N, S, I): K6's instances at two channels (eight items a warp), at an odd N (lanes of 8 bytes) and at its largest N
IPA_EDGES = ((2, 2, 257), (7, 7, 257), (16, 16, 33))
# (m, B, variant): K4's columns variant at an odd m (8-byte copies) and its rows variant at both ends of its sizes
SANDWICH_EDGES = ((5, 4099, "columns"), (9, 4099, "rows"), (16, 2053, "rows"))
EIGH_TOL = 1e-5  # the same 90 rounds in the same order on both sides; f32 rounding may differ
PROX_TOL = 1e-5
JACOBI_SIZES = (2, 3, 7, 16, 32)
EIGH_SLICE = 4096  # matrices of the eigh model's batch held against the plain version, at each end
N_ITER_MASKING_ADMM = 10
N_ITER_IPA_CLASSES = 10
N_ITER_IPA_PLAIN_RATE = 5  # the plain Jacobi eigh takes ~30 ms, eight times per IPA iteration (cut from 10 for time)
IPA_TOL = 1e-5  # 8-term f32 complex sums, in another order on each side
IPA_PERTURBATION = 1e-7  # relative noise on the control run's input: one f32 ulp
# the SI-SDR gate against the plain twin holds where the control run keeps this much more than MIN_SI_SDR_DB
# under IPA_PERTURBATION on its input; below that (IPA, IP2 and FasterIVA in float32) the path is held on its loss
SENSITIVITY_MARGIN_DB = 10.0
# a path held on its loss alone: its final loss within this of the plain twin's. The sound paths' largest gap is
# 6.3e-5 (FasterIVA) and one ulp of noise on the input moves GaussILRMA-IPA's loss by 6.1e-5 (PERF.md, section 6)
SENSITIVE_LOSS_TOL = 3e-4
# how far such a path's final loss may stay above its anchor's: the same model from the same start with a one-row
# update (IPA against ISS1, ILRMA's IP2 against IP1), 100 iterations
ANCHOR_TOL = 1e-2
MNMF_EPS = 1e-10  # the dense-MNMF step's floor and ridge, class and fast path
INV_SANDWICH_TOL = 1e-5  # the same elimination on both sides, sums in another order
MODEL_TRACES_TOL = 2e-4  # relative to max, the JAX package's own tolerance for this pass (tests/ops/test_pallas_kernels.py:101-105)
N_ITER_MNMF_EIGH = 10  # the eigh route: K7 on 160,882 matrices four times per iteration, its plain twin ~1 s each
N_ITER_MNMF_PLAIN_RATE = 10  # the plain fused pass takes tens of ms, three times per iteration
N_ITER_MNMF_EIGH_RATE = 2
GJ_INVERSE_TOL = 1e-5  # the same elimination on both sides; fused multiply-adds round differently
# beyond the timing shape's 4 and 5: every other m of the one-thread-per-system instance, K4's former
# limit, the hard tier's 17, the kernel's limit; and batches that leave a block part-full
GJ_INVERSE_SIZES = (1, 2, 3, 6, 7, 8, 16, 17, 32)
GJ_INVERSE_BATCHES = (1, 31, 33)
# (M, I, T, N) beyond the main path: frame counts that the chunks do not divide, the generic instance,
# and the size contract's largest M, largest N and most work items
WCOV_EDGES = ((8, 257, 1, 8), (8, 257, 129, 8), (8, 257, 1000, 8), (2, 9, 129, 2), (3, 9, 129, 5),
              (47, 3, 129, 1), (1, 5, 129, 93), (42, 3, 129, 9))
N_ITER_IPSDTA = 20
N_ITER_IPSDTA_PLAIN_RATE = 5
IPSDTA_BLOCKS = 64  # scripts/tpu_bench.py:260-277: 63 blocks of 4 bins and one of 5
IPSDTA_DOF = 1000  # TIPSDTA's dof, as the regression fixture takes it (tests/regression/test_regression.py:316-322)
IPSDTA_EPS = 1e-10  # the IPSDTA step's floor and ridge, class and fast path
# the hard scenario of tests/test_hard_fidelity.py:352-400 and its pin (tests/fidelity_pins.json:36)
HARD_N_FFT, HARD_HOP, HARD_BLOCKS, HARD_BASIS, HARD_ITER, HARD_SEED = 512, 256, 16, 2, 5, 29
HARD_PIN_DB, HARD_PIN_TOL_DB = -11.41965, 0.1
FAST_MNMF_CHANNELS, FAST_MNMF_BASIS = 4, 4  # bench.py:230-252: the first 4 channels, n_basis = 4
N_ITER_CACGMM_PLAIN_RATE = 10  # the plain Jacobi eigh takes ~60 ms, twice per EM step
N_ITER_FIXED_POINT_PLAIN_RATE = 10  # FastIVA and FasterIVA: the plain Jacobi eigh once (B = 257) or twice (and 2,056) a step
N_ITER_PROX_PLAIN_RATE = 20  # the prox family's plain twins run at ~14 it/s (the plain Jacobi eigh once a step)
N_ITER_PAIRWISE_RATE = 10  # IP2 and ISS2 launch ~1,400 device operations a step (~40 it/s, host-paced): rate and profile
N_ITER_PROFILE = 5  # chained steps a profiler session traces; the host-paced paths take seconds a session to trace
RATE_WARMUP = 2  # chained steps ahead of each timed chain of a path rate (the whole chain before: half the phase)
# the hard tier of tests/test_hard_fidelity.py:67, :252-283 and :448-493 and its pins (tests/fidelity_pins.json)
HARD_TIER_N_FFT, HARD_TIER_HOP = 4096, 1024
HARD_CACGMM_ITER, HARD_CACGMM_SEED, HARD_CACGMM_PIN_DB, HARD_CACGMM_TOL_DB = 50, 3, -1.088889, 0.1
HARD_FAST_MNMF_ITER, HARD_FAST_MNMF_SEED, HARD_FAST_MNMF_BASIS = 40, 23, 4
HARD_FAST_MNMF_PIN_DB, HARD_FAST_MNMF_TOL_DB = -5.776799, 0.5
ROUTE_LOSS_TOL = 1e-6  # a complex128 class on the card's plain routes against the same class on the CPU
ROUTE_ITER = 10
WAVE_TOL = 1e-4  # a waveform entry point against stft -> the spectrogram path -> istft on the same card
# the easy tier of tests/test_fast_fidelity.py:34, :62-75 and its pins (tests/fidelity_pins.json): the paths without a
# kernel (ISS2, gradient IVA) are held there, within 0.1 dB
EASY_N_FFT, EASY_HOP, EASY_PIN_TOL_DB = 256, 128, 0.1
EASY_ITER, EASY_GRAD_ITER = 30, 100  # tests/test_fast_fidelity.py:108, :213
ICA_CHANNELS = 2  # bench.py:589: NaturalGradLaplaceICA on the mixture's first two channels
# the hard tier of FDICA (tests/test_hard_fidelity.py:206-248): IP1, aligned and projected back, and its pin
HARD_FDICA_ITER, HARD_FDICA_PIN_DB, HARD_FDICA_TOL_DB = 50, 5.560804, 0.4
# the eigendecomposition-free routes against their eigh routes: the secular roots within the JAX package's own
# float32 bound at 12 trips (splitc.py:1541-1546), the QDWH polar unitary and near the eigh polar, the shift-invert
# top eigenvector's Rayleigh quotient near K7's top eigenvalue
SECULAR_ROOT_TOL = 1.2e-3
QDWH_UNITARY_TOL, QDWH_POLAR_TOL, TOP_EIGVEC_TOL = 1e-5, 1e-4, 1e-5
# FDICA's bins iterate apart, and over 100 float32 iterations one ulp of input noise moves its loss past
# SENSITIVE_LOSS_TOL (AuxFDICA-IP2: 5.5e-4 on the card, PERF.md section 6): the kernel paths are held
# against their plain twins at this depth; at 100 iterations the kernel path's loss gap to the plain twin is held
# to FDICA_CONTROL_MULTIPLE times the one-ulp control's (the readings: IP1 3.4x, IP2 1.5x, PERF.md section 6)
N_ITER_FDICA_HOLD = 10
FDICA_CONTROL_MULTIPLE = 10.0
# the free routes' chained steps for a rate and a profile: AuxIVA-IPA with secular_impl="solve" issues ~50,000 device
# operations a step (~0.9 s, and a profiler session of 10 steps took ~95 s), FasterIVA's and FastIVA's ~3,000 and ~750
N_ITER_FREE_RATE = {"AuxIVA-IPA solve": 1, "FasterIVA solve": 5, "FastIVA qdwh": 10}
N_ITER_IPA_RATE = 20  # AuxIVA-IPA and GaussILRMA-IPA: chained steps a rate reads (cut from 100 for time)
N_PARALLEL_TIMED = 10  # chained AuxIVA-IP1 steps a device time of the batched step reads
# the runners of the other families at full width: steps a run takes (the depth is cut for time; no gate is), the
# chained steps a profile of their kernel time reads, and the relative error of a run over 2 gloo ranks against world
# size 1
N_ITER_RUNNERS = 5
N_RUNNERS_TIMED = 5
RUNNER_RANKS_TOL = 1e-4
# the sharded runners' kernel calls against their plain versions, at the gates of phases 3-4g: relative to the
# plain output's largest magnitude, 0 for bit for bit (K7 and K3 keep the plain version's bits)
RANK_KERNEL_TOLS = {"weighted_covariance": WCOV_TOL, "ip1_sweep": SWEEP_TOL, "iss1_sweep": ISS1_TOL,
                    "jacobi_eigh": 0.0, "ipa_congruence": IPA_TOL, "gj_inverse": 0.0,
                    "inv_sandwich": INV_SANDWICH_TOL, "model_traces": MODEL_TRACES_TOL}
ICA_FIXTURE_TOL = 1e-6  # tests/regression/test_regression.py:179-186
WAV_SI_SDR_DB = 60.0  # a separated source through its 16-bit WAV file against itself in memory
N_ITER_FLOORING = 20  # AuxLaplaceIVA-IP1 at full width with a flooring_fn that is not max(., eps)
N_ITER_TRACE = 10  # fast_auxiva IP1 steps traced, timed (per call) by the profiling helpers
TRACE_ATTEMPTS = 3  # trace sessions until one names K1's and K1b's kernels (a CUPTI session may drop events)
REPO = os.path.dirname(os.path.abspath(__file__))

# the card's peaks for the bound: NVIDIA H100 SXM data sheet, at 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

KERNELS = {
    "weighted_covariance": {
        "source": "ssspy_tpu_torch/ops/csrc/weighted_covariance.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:155",
    },
    "ip1_sweep": {
        "source": "ssspy_tpu_torch/ops/csrc/ip1_sweep.cu",
        "replaces": "ssspy_tpu/ops/splitc.py:281",
    },
    "iss1_sweep": {
        "source": "ssspy_tpu_torch/ops/csrc/iss1_sweep.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:773",
    },
    "jacobi_eigh": {
        "source": "ssspy_tpu_torch/ops/csrc/jacobi_eigh.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:894",
    },
    "ipa_congruence": {
        "source": "ssspy_tpu_torch/ops/csrc/ipa_congruence.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:462",
    },
    "gj_inverse": {
        "source": "ssspy_tpu_torch/ops/csrc/gj_inverse.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:284",
    },
    "inv_sandwich": {
        "source": "ssspy_tpu_torch/ops/csrc/inv_sandwich.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:349",
    },
    "model_traces": {
        "source": "ssspy_tpu_torch/ops/csrc/mnmf_model_traces.cu",
        "replaces": "ssspy_tpu/ops/pallas_kernels.py:607",
    },
}
WRAPPERS = {name: getattr(K, name) for name in KERNELS}
PLAIN = {
    "weighted_covariance": K.weighted_covariance_plain,
    "ip1_sweep": K.ip1_sweep_plain,  # "lu"
    "iss1_sweep": K.iss1_sweep_plain,
    "jacobi_eigh": K.jacobi_eigh_plain,
    "ipa_congruence": K.ipa_congruence_plain,
    "gj_inverse": K.gj_inverse_plain,
    "inv_sandwich": K.inv_sandwich_plain,
    "model_traces": K.model_traces_plain,
}


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {message}")


class Laps:
    """The seconds each phase of ``main`` takes, as ``[phase]`` lines: ``laps(name)`` ends the running phase, prints
    its time, and starts ``name``."""

    def __init__(self):
        self.name, self.start = "1", time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        say("phase", name=repr(self.name), seconds=f"{now - self.start:.1f}")
        self.name, self.start = name, now


def check(condition, message: str) -> None:
    if not condition:
        fail(message)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def all_finite(*tensors) -> bool:
    return all(bool(torch.isfinite(torch.view_as_real(t) if t.is_complex() else t).all()) for t in tensors)


def si_sdr_db(est: np.ndarray, ref: np.ndarray) -> float:
    est, ref = est.ravel(), ref.ravel()
    alpha = np.vdot(ref, est) / np.vdot(ref, ref)
    err = est - alpha * ref
    with np.errstate(divide="ignore", invalid="ignore"):  # identical signals: +inf dB
        return float(10 * np.log10(np.real(np.vdot(alpha * ref, alpha * ref) / np.vdot(err, err))))


def min_si_sdr(est: torch.Tensor, ref: torch.Tensor) -> float:
    """Worst per-source SI-SDR of ``est`` against ``ref`` (sources on axis 0), in float64."""
    est = est.cpu().numpy().astype(np.complex128)
    ref = ref.cpu().numpy().astype(np.complex128)
    return min(si_sdr_db(est[n], ref[n]) for n in range(est.shape[0]))


def median_ms(fn, queued: bool, n_runs: int = N_TIMED, n_warmup: int = 3) -> float:
    """Median time of ``fn()`` between two CUDA events, over ``n_runs`` runs.

    ``queued=False``: the device starts idle, so the time includes every
    gap in which it waits for the host to enqueue ``fn``'s launches (what
    a caller pays per call). ``queued=True``: the device is first kept busy
    with a spin kernel long enough for the host to enqueue the events and
    all of ``fn``'s launches, so the time is the device's own, from the
    first to the last launch of ``fn``.
    """
    for _ in range(n_warmup):
        fn()
    times = []
    for _ in range(n_runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@contextlib.contextmanager
def plain_versions():
    """Route every step through the plain versions: the kernel wrappers are swapped out."""
    for name, fn in PLAIN.items():
        setattr(K, name, fn)
    try:
        yield
    finally:
        for name, fn in WRAPPERS.items():
            setattr(K, name, fn)


def counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def drive(label: str, run, uses, totals: dict, least: int = N_ITER, exact: bool = False):
    """Run ``run()`` with every launch count at 0; the kernels in ``uses`` must launch >= ``least`` times
    (exactly ``least`` with ``exact``), the others never. ``uses`` may map each kernel to its own ``least``."""
    uses = uses if isinstance(uses, dict) else {name: least for name in uses}
    torch.cuda.synchronize()
    for fn in WRAPPERS.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = counts()
    say("path", path=repr(label), launches=launches, seconds=f"{seconds:.3f}",
        peak_mib=f"{torch.cuda.max_memory_allocated() / 2**20:.1f}")
    for name, count in launches.items():
        if name in uses:
            check(count == uses[name] if exact else count >= uses[name],
                  f"{label}: launched {name} {count} times ({'!=' if exact else '<'} {uses[name]})")
        else:
            check(count == 0, f"{label}: launched {name} {count} times; the path does not run it")
        totals[name] += count
    return out


def run_plain(run):
    """``run()`` through the plain versions; no kernel may launch."""
    before = counts()
    with plain_versions():
        out = run()
    torch.cuda.synchronize()
    check(counts() == before, "a kernel launched inside the plain-version run")
    return out


def first_divergence(loss, plain_loss, tol: float):
    """First iteration whose loss differs from the plain run's by more than ``tol`` (relative)."""
    for it, (a, b) in enumerate(zip(loss, plain_loss)):
        if abs(a - b) > tol * abs(b):
            return it
    return None


def hold(label: str, Y, Y_plain, loss, loss_plain, **extra) -> None:
    """Gate a path's output against its plain twin: final loss and worst SI-SDR."""
    rel = abs(loss - loss_plain) / abs(loss_plain)
    sdr = min_si_sdr(Y, Y_plain)
    say("path vs plain", path=repr(label), loss=loss, plain_loss=loss_plain, loss_rel_diff=rel,
        min_si_sdr_db=sdr, **extra)
    check(all_finite(Y), f"{label}: non-finite output")
    check(rel <= LOSS_TOL, f"{label}: loss {loss} vs plain {loss_plain}")
    check(sdr >= MIN_SI_SDR_DB, f"{label}: output vs plain {sdr:.2f} dB")


def hold_sensitive(label: str, Y, Y_plain, perturbed, loss, loss_plain, loss_first=None, anchor=None, **extra) -> None:
    """Gate a path that may amplify rounding: ``hold`` where the output keeps MIN_SI_SDR_DB against the plain
    twin's. Below that, ``perturbed()`` gives ``(Y, loss)`` of the path (or its plain twin) run again on its input
    times (1 + IPA_PERTURBATION noise): where that output keeps MIN_SI_SDR_DB + SENSITIVITY_MARGIN_DB against the
    plain twin's, ``hold`` fails as it should; otherwise the SI-SDR cannot tell a kernel's fault from one ulp of
    rounding, both SI-SDRs are printed, and the loss alone is gated: it falls below ``loss_first`` (where given),
    it ends within SENSITIVE_LOSS_TOL of the plain twin's, and with ``anchor = (name, loss)`` no higher (by more
    than ANCHOR_TOL) than where the anchor takes the same model from the same start."""
    if loss_first is not None:
        extra["loss_first"] = loss_first
    sdr = min_si_sdr(Y, Y_plain)
    if sdr >= MIN_SI_SDR_DB:
        hold(label, Y, Y_plain, loss, loss_plain, **extra)
        return
    Y_perturbed, loss_perturbed = perturbed()
    control = min_si_sdr(Y_perturbed, Y_plain)
    if control >= MIN_SI_SDR_DB + SENSITIVITY_MARGIN_DB:
        hold(label, Y, Y_plain, loss, loss_plain, perturbed_input_min_si_sdr_db=control, **extra)
        return
    rel = abs(loss - loss_plain) / abs(loss_plain)
    if anchor is not None:
        extra.update(anchor=repr(anchor[0]), anchor_loss=anchor[1],
                     loss_rel_diff_to_anchor=(loss - anchor[1]) / abs(anchor[1]))
    say("path vs plain", path=repr(label), loss=loss, plain_loss=loss_plain, loss_rel_diff=rel, min_si_sdr_db=sdr,
        perturbed_input_loss=loss_perturbed,
        perturbed_input_loss_rel_diff=abs(loss_perturbed - loss_plain) / abs(loss_plain),
        perturbed_input_min_si_sdr_db=control, input_perturbation=IPA_PERTURBATION, gate=repr("loss"),
        **extra)
    check(all_finite(Y), f"{label}: non-finite output")
    check(loss_first is None or loss < loss_first, f"{label}: loss did not fall: {loss_first} -> {loss}")
    check(rel <= SENSITIVE_LOSS_TOL, f"{label}: loss {loss} vs plain {loss_plain}")
    check(anchor is None or loss <= anchor[1] + ANCHOR_TOL * abs(anchor[1]),
          f"{label}: loss {loss} above {anchor and anchor[0]}'s {anchor and anchor[1]}")


def hold_class(label: str, method, Y, plain_method, Y_plain) -> None:
    check(len(method.loss) == N_ITER + 1 and method.loss[-1] < method.loss[0],
          f"{label}: class loss did not decrease: {method.loss[0]} -> {method.loss[-1]}")
    hold(label, Y, Y_plain, method.loss[-1], plain_method.loss[-1], loss_first=method.loss[0],
         first_divergent_iteration=first_divergence(method.loss, plain_method.loss, LOSS_TOL))


# ---- the bound: least time on the card for the same work --------------------------------


def bound_ms(n_bytes: float, flops: float):
    """``(ms, "bytes" | "operations")``: the larger of bytes over HBM rate and flops over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def wcov_bound(M, I, T, N, per_bin):
    # read X and phi once, write U once; per (bin, frame, pair p <= q) one
    # complex product x_p conj(x_q) (6 flops), then per source one weighted
    # complex accumulate (2 FMAs, 4 flops)
    n_bytes = M * I * T * 8 + (N * I * T if per_bin else N * T) * 4 + I * N * M * M * 8
    return bound_ms(n_bytes, I * T * (M * (M + 1) // 2) * (6 + 4 * N))


def ip1_bound(I, N, M):
    # read U and W, write W; per (bin, source): W U_n (8 M^3), complex LU
    # (8 M^3 / 3), two triangular solves and U_n w (24 M^2), w^H z (8 M)
    n_bytes = I * N * M * M * 8 + 2 * I * N * M * 8
    return bound_ms(n_bytes, I * N * (8 * M**3 + 8 * M**3 / 3 + 24 * M * M + 8 * M))


def iss1_bound(N, I, T, per_bin):
    # read Y and phi, write Y; per (source n, row m, bin, frame): the
    # weighted numerator (10 flops), the weighted denominator (2), the
    # rank-one update (8)
    n_bytes = 2 * N * I * T * 8 + (N * I * T if per_bin else N * T) * 4
    return bound_ms(n_bytes, 20 * N * N * I * T)


def jacobi_bound(B, n, sweeps=None):
    # read A, write lambda and V; per round the row pass of A, the column
    # pass of A and the column pass of V, 3 n^2 flops each, over
    # sweeps x rounds(n) rounds (the 2n divisions and square roots of the
    # rotations are not counted)
    sweeps = K.jacobi_sweeps(n) if sweeps is None else sweeps
    n_bytes = B * (2 * n * n + n) * 4
    return bound_ms(n_bytes, B * 9 * n * n * sweeps * len(K.round_pairs(n)))


def congruence_bound(I, S, N):
    # read T, U and G, write U and G; 2S + 1 complex N x N products of
    # 8 N^3 flops each
    n_bytes = I * N * N * 8 * (2 * S + 3)
    return bound_ms(n_bytes, I * 8 * N**3 * (2 * S + 1))


def gj_inverse_bound(B, m):
    # read R, write R^-1; the elimination updates every entry of [R | I] at
    # each of m steps (16 m^3 flops)
    return bound_ms(2 * B * m * m * 8, 16 * B * m**3)


def inv_sandwich_bound(B, m):
    # read R and C, write R^-1 and S; the elimination updates every entry of
    # [R | I] at each of m steps (16 m^3 flops), the two products 8 m^3 each
    return bound_ms(4 * B * m * m * 8, 32 * B * m**3)


def model_traces_bound(N, I, T, m):
    # read XX, Lamb and H, write t1, t2, P and Q; per (bin, frame): the model
    # 4 N m^2, the elimination 16 m^3, two products 16 m^3, two traces
    # 8 N m^2, the P and Q sums 8 N m^2 (bound_ms counts each once)
    n_bytes = I * T * m * m * 8 + 3 * N * I * T * 4 + 3 * N * I * m * m * 8
    return bound_ms(n_bytes, I * T * (20 * N * m * m + 32 * m**3))


# ---- the paths' helpers ----------------------------------------------------------------


def cacgmm_start(rng, n_channels, n_bins, device, n_sources=None):
    """``(alpha (N, I), B (N, I, M, M))``: ``fast_cacgmm``'s start from ``rng``, float32 and complex64 on ``device``."""
    n_sources = n_channels if n_sources is None else n_sources
    alpha = rng.random((n_sources, n_bins))
    B_diag = rng.random((n_sources, n_bins, n_channels))
    B = (B_diag / B_diag.sum(axis=-1, keepdims=True))[..., None] * np.eye(n_channels)
    return (torch.from_numpy((alpha / alpha.sum(axis=0)).astype(np.float32)).to(device),
            torch.from_numpy(B.astype(np.float32)).to(device=device, dtype=torch.complex64))


class FixedRng:
    """Hands out fixed draws in order, as tests/test_hard_fidelity.py:469-476 does for ``fast_gauss_mnmf``."""

    def __init__(self, *draws):
        self.draws = list(draws)

    def random(self, shape):
        value = self.draws.pop(0)
        check(value.shape == tuple(shape), f"fixed draw {value.shape} for {tuple(shape)}")
        return value


def fast_varphi(Y):
    """``fast_auxiva``'s Laplace weight ``(N, T)``."""
    return 1.0 / torch.clamp(torch.linalg.vector_norm(Y, dim=1), min=FAST_EPS)


def iterations_per_s(step, state, n_iter: int = N_ITER) -> float:
    """``n_iter`` chained steps between two CUDA events, after a warm-up chain of ``RATE_WARMUP`` steps."""
    chain(step, state, min(n_iter, RATE_WARMUP))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chain(step, state, n_iter)
    end.record()
    torch.cuda.synchronize()
    return n_iter / (start.elapsed_time(end) / 1e3)


@contextlib.contextmanager
def recording_jacobi(inputs: list, keep: bool = False):
    """Record the batch (or, with ``keep``, a copy) of every eigh the prox steps hand to K7.

    The recorder sits in front of ``prox_steps.symm_eigh``, which hands its
    input to ``K.jacobi_eigh`` as ``(B, n, n)``; the wrapper itself stays in
    place, so its launches count as ever.
    """
    symm_eigh = prox_steps.symm_eigh

    def recorder(S):
        A = S.reshape(-1, S.shape[-1], S.shape[-1])
        inputs.append(A.contiguous().clone() if keep else A.shape[0])
        return symm_eigh(S)

    prox_steps.symm_eigh = recorder
    try:
        yield
    finally:
        prox_steps.symm_eigh = symm_eigh


@contextlib.contextmanager
def recording_congruence(inputs: list):
    """Record ``(T, U, G)`` of every congruence round of a sweep that runs through the plain versions.

    Only for use inside :func:`plain_versions`: the recorder takes the
    place of ``K.ipa_congruence`` and answers with the plain version, so no
    kernel launches and no count moves.
    """
    inner = K.ipa_congruence

    def recorder(T, U, G):
        inputs.append((T.clone(), U.clone(), G.clone()))
        return K.ipa_congruence_plain(T, U, G)

    K.ipa_congruence = recorder
    try:
        yield
    finally:
        K.ipa_congruence = inner


def hold_trace(label: str, Y, Y_plain, loss, loss_plain) -> None:
    """Gate a path whose loss is not monotone (PDS/ADMM): every iteration's loss within LOSS_TOL of the plain run's,
    and the last one below the first."""
    check(len(loss) == len(loss_plain), f"{label}: {len(loss)} vs {len(loss_plain)} losses")
    diverged = [it for it, (a, b) in enumerate(zip(loss, loss_plain)) if not (a == b or abs(a - b) <= LOSS_TOL * abs(b))]
    finite = [(a, b) for a, b in zip(loss, loss_plain) if np.isfinite(a) and np.isfinite(b)]
    worst = max(abs(a - b) / abs(b) for a, b in finite)
    sdr = min_si_sdr(Y, Y_plain)
    say("path vs plain", path=repr(label), loss_first=loss[0], loss_last=loss[-1], plain_loss_last=loss_plain[-1],
        worst_loss_rel_diff=worst, non_finite_losses=len(loss) - len(finite), diverged_iterations=diverged[:5],
        min_si_sdr_db=sdr)
    check(all_finite(Y), f"{label}: non-finite output")
    check(not diverged, f"{label}: loss left the {LOSS_TOL} band at iterations {diverged[:5]}")
    check(np.isfinite(loss[-1]) and loss[-1] < loss[0], f"{label}: loss did not fall: {loss[0]} -> {loss[-1]}")
    check(sdr >= MIN_SI_SDR_DB, f"{label}: output vs plain {sdr:.2f} dB")


@contextlib.contextmanager
def recording(module, name: str, record):
    """Hand the arguments of every call to ``module.name`` to ``record`` first; the call still runs.

    The recorder sits in front of a router (``ipsdta_steps.hermitian_inverse``,
    ``prox_steps.symm_eigh``) or of a step's PyTorch operations
    (``ipsdta_steps.vcd_sweep``), never in place of a kernel wrapper, whose
    launch count goes through its module attribute; the wrappers behind it
    count as ever.
    """
    inner = getattr(module, name)

    def recorder(*args, **kwargs):
        record(*args, **kwargs)
        return inner(*args, **kwargs)

    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, inner)


def size_of(sizes: list):
    """A ``record`` for :func:`recording`: the trailing size of the first argument."""
    return lambda A, *args, **kwargs: sizes.append(A.shape[-1])


def best_permutation_si_sdr(y: np.ndarray, refs: np.ndarray) -> float:
    """Mean SI-SDR of ``y`` against ``refs`` under the best source permutation (tests/test_hard_fidelity.py:102-114)."""

    def si_sdr(est, ref):
        alpha = np.sum(est * ref) / np.sum(ref**2)
        ref = alpha * ref
        return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))

    n = refs.shape[0]
    return max(np.mean([si_sdr(y[perm[s]], refs[s]) for s in range(n)]) for perm in itertools.permutations(range(n)))


def relative_error(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def library_inv_sandwich(R, C):
    """K4's function in PyTorch calls: ``inv_ex`` and two ``matmul`` (the library yardstick)."""
    R_inv = torch.linalg.inv_ex(R)[0]
    return R_inv, (R_inv @ C) @ R_inv


def library_model_traces(Lamb, H, XX, eps):
    """K5's function as ``model_traces_plain`` composes it, with ``inv_ex`` for the Gauss-Jordan (the library yardstick)."""
    Hh = (H + H.mH) / 2
    Lc = Lamb.to(H.dtype)
    R = torch.einsum("nit,nipq->itpq", Lc, Hh)
    R_inv = torch.linalg.inv_ex((R + R.mH) / 2 + eps * torch.eye(R.shape[-1], dtype=R.dtype, device=R.device))[0]
    Mm = (R_inv @ XX) @ R_inv
    return (torch.einsum("itab,niba->nit", Mm, Hh).real, torch.einsum("itab,niba->nit", R_inv, Hh).real,
            torch.einsum("nit,itpq->nipq", Lc, R_inv), torch.einsum("nit,itpq->nipq", Lc, Mm))


def hold_sdr(label: str, Y, Y_plain) -> None:
    """Gate a path without a loss (the masking paths): finite output, worst SI-SDR against the plain run."""
    sdr = min_si_sdr(Y, Y_plain)
    say("path vs plain", path=repr(label), min_si_sdr_db=sdr)
    check(all_finite(Y), f"{label}: non-finite output")
    check(sdr >= MIN_SI_SDR_DB, f"{label}: output vs plain {sdr:.2f} dB")


def eigh_errors(A, lamb, V, lamb_ref):
    """Eigenvalue error against the plain version, reconstruction and orthogonality, relative to max |lambda|."""
    scale = float(lamb_ref.abs().max()) or 1.0
    eye = torch.eye(A.shape[-1], device=A.device)
    return (
        float((lamb - lamb_ref).abs().max()) / scale,
        float(((V * lamb[:, None, :]) @ V.transpose(-1, -2) - A).abs().max()) / scale,
        float((V.transpose(-1, -2) @ V - eye).abs().max()),
    )


def main() -> None:
    # ---- 1. device ----------------------------------------------------------
    started = time.perf_counter()
    laps = Laps()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    nvcc_version = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else "unknown"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(
        "device", name=repr(kind), nvidia_smi=repr(card), count=torch.cuda.device_count(),
        driver=repr(driver), torch=torch.__version__, cuda=torch.version.cuda, nvcc=repr(nvcc_version),
        python=sys.version.split()[0],
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
    )

    # ---- 2. build: one nvcc per source, all started together --------------------
    laps("2")
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        list(pool.map(_build.load, map(K.source_of, KERNELS)))
    build_s = time.perf_counter() - start
    say("build", seconds=f"{build_s:.3f}", **{f"{k}_seconds": f"{v['seconds']:.3f}" for k, v in _build.build_info.items()})
    for name in KERNELS:
        ptxas = " | ".join(
            line.split("ptxas info    : ")[-1].strip()
            for line in _build.build_info[K.source_of(name)]["log"].splitlines()
            if "Used" in line or "spill" in line
        )
        say("build", kernel=name, ptxas=repr(ptxas))

    # main-path input, made on the host from a seed and transformed on the card
    wave = torch.from_numpy(make_mixture(seed=0)).to(device=device, dtype=torch.float32)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP, device=device)
    check(tuple(X.shape) == (8, 257, 626) and X.dtype == torch.complex64, f"main-path STFT {tuple(X.shape)} {X.dtype}")
    M, I, T = X.shape
    rng = np.random.default_rng(0)
    W_eye = torch.eye(M, dtype=X.dtype, device=device).expand(I, -1, -1).contiguous()
    errors = {}

    # ---- 3. K1 against its plain version --------------------------------------
    laps("3")
    phi_scalar = fast_varphi(separate(X, W_eye)).contiguous()
    phi_bins = torch.from_numpy(rng.random((M, I, T), dtype=np.float32) + 0.1).to(device)
    wcov_abs = 0.0

    def hold_wcov(label, X_in, phi):
        """K1 against its plain version within WCOV_TOL, Hermitian to the bit, and two launches to the bit."""
        U = K.weighted_covariance(X_in, phi)
        U_2 = K.weighted_covariance(X_in, phi)
        U_ref = K.weighted_covariance_plain(X_in, phi)
        torch.cuda.synchronize()
        abs_err = float((U - U_ref).abs().max())
        rel_err = abs_err / float(U_ref.abs().max())
        hermitian = float((U - U.transpose(-2, -1).conj()).abs().max())
        repeat = bool(torch.equal(U, U_2))
        M_, I_, T_ = X_in.shape
        geometry = K.weighted_covariance_geometry(M_, phi.shape[0], I_, T_)
        say("K1 weighted_covariance", weights=repr(label), shape=(M_, phi.shape[0], I_, T_), max_abs_err=abs_err,
            rel_err=rel_err, tol=WCOV_TOL, hermitian_err=hermitian, two_launches_equal=repeat,
            instance="M = N = 8" if (M_, phi.shape[0]) == (8, 8) else "generic",
            warps=geometry["warps"], passes=geometry["passes"])
        check(rel_err <= WCOV_TOL and all_finite(U), f"weighted_covariance {label}: rel err {rel_err}")
        check(hermitian == 0.0 and repeat, f"weighted_covariance {label}: Hermitian {hermitian}, repeat {repeat}")
        return abs_err

    for label, phi in (("scalar (N,T)", phi_scalar), ("per-bin (N,I,T)", phi_bins)):
        wcov_abs = max(wcov_abs, hold_wcov(label, X, phi))
    edge_rng = np.random.default_rng(1)  # its own draws: the later phases' inputs stay as they were
    for M_, I_, T_, N_ in WCOV_EDGES:
        X_edge = torch.complex(*(torch.from_numpy(edge_rng.standard_normal((M_, I_, T_), dtype=np.float32))
                                 for _ in range(2))).to(device)
        for per_bin in (False, True):
            phi = torch.from_numpy(edge_rng.random((N_, I_, T_) if per_bin else (N_, T_), dtype=np.float32) + 0.1)
            hold_wcov("per-bin (N,I,T)" if per_bin else "scalar (N,T)", X_edge, phi.to(device))
    errors["weighted_covariance"] = wcov_abs

    # ---- 4. K1b against its exact twin (gjnp) ----------------------------------
    laps("4")
    def hold_ip1(label, W_in, U_in, silent, expected):
        """K1b within SWEEP_TOL of its exact twin on the live bins, silent bins frozen, two launches to the bit."""
        W_new, W_2 = K.ip1_sweep(W_in, U_in, eps=FAST_EPS), K.ip1_sweep(W_in, U_in, eps=FAST_EPS)
        W_ref = K.ip1_sweep_plain(W_in, U_in, eps=FAST_EPS, solve_impl="gjnp")
        torch.cuda.synchronize()
        variant = K.ip1_sweep_variant(W_in.shape[-1])
        live = [i for i in range(W_in.shape[0]) if i not in silent]
        frozen = all(torch.equal(W_new[i], W_in[i]) for i in silent)
        repeat = bool(torch.equal(W_new, W_2))
        abs_err = float((W_new[live] - W_ref[live]).abs().max())
        rel_err = abs_err / float(W_ref[live].abs().max())
        say("K1b ip1_sweep", case=repr(label), shape=tuple(W_in.shape), variant=variant,
            silent_bins=tuple(silent), frozen_unchanged=frozen, max_abs_err=abs_err, rel_err=rel_err, tol=SWEEP_TOL,
            two_launches_equal=repeat)
        check(frozen, f"ip1_sweep {label}: a row of a silent (U = 0) bin changed")
        check(rel_err <= SWEEP_TOL and all_finite(W_new), f"ip1_sweep {label}: rel err {rel_err}")
        check(repeat, f"ip1_sweep {label}: two launches differ")
        check(variant == expected, f"ip1_sweep {label}: ran the {variant} variant, expected {expected}")
        return abs_err

    U = K.weighted_covariance(X, phi_scalar)
    U[list(SILENT_BINS)] = 0
    noise = rng.standard_normal((2, I, M, M)).astype(np.float32)
    W0 = W_eye + 0.1 * torch.complex(torch.from_numpy(noise[0]), torch.from_numpy(noise[1])).to(device)
    sweep_abs = hold_ip1("main path", W0, U, SILENT_BINS, "warp")
    # the warp variant at an odd M (lanes of each group idle) and a part-full last block, and the block
    # variant; their own draws
    ip1_rng = np.random.default_rng(2)
    for edge_M, edge_I, expected in IP1_EDGES:
        X_edge = torch.complex(*(torch.from_numpy(ip1_rng.standard_normal((edge_M, edge_I, T), dtype=np.float32))
                                 for _ in range(2))).to(device)
        U_edge = K.weighted_covariance(X_edge, torch.ones((edge_M, T), device=device))
        U_edge[[0, edge_I // 2]] = 0
        W_edge = torch.eye(edge_M, dtype=X.dtype, device=device) + 0.1 * torch.complex(
            *(torch.from_numpy(ip1_rng.standard_normal((edge_I, edge_M, edge_M), dtype=np.float32)) for _ in range(2))
        ).to(device)
        hold_ip1(f"M = {edge_M}, I = {edge_I}", W_edge, U_edge, (0, edge_I // 2), expected)
    errors["ip1_sweep"] = sweep_abs

    # ---- 4b. K2 against its plain version ----------------------------------------
    laps("4b")
    iss1_abs = 0.0
    long_N, long_I, long_T = LONG_SHAPE
    Y_long = torch.complex(*(torch.from_numpy(rng.standard_normal((long_N, long_I, long_T), dtype=np.float32))
                             for _ in range(2))).to(device)
    cases = [
        ("scalar (N,T)", X, phi_scalar, "registers"),
        ("per-bin (N,I,T)", X, phi_bins, "registers"),
        ("long scalar (N,T)", Y_long, phi_scalar.new_tensor(rng.random((long_N, long_T), dtype=np.float32) + 0.1),
         "streamed"),
        ("long per-bin (N,I,T)", Y_long, phi_bins.new_tensor(rng.random(LONG_SHAPE, dtype=np.float32) + 0.1),
         "streamed"),
    ]
    # the register variant at its edges and the resident variant, with their own draws: at one frame each sum
    # is a single term, and the register variant rounds as the plain version, so the two must agree to the bit
    iss1_rng = np.random.default_rng(3)
    for N_, I_, T_, expected in ISS1_EDGES:
        Y_edge = torch.complex(*(torch.from_numpy(iss1_rng.standard_normal((N_, I_, T_), dtype=np.float32))
                                 for _ in range(2))).to(device)
        phi_edge = torch.from_numpy(iss1_rng.random((N_, I_, T_), dtype=np.float32) + 0.1).to(device)
        cases.append(("edge per-bin (N,I,T)", Y_edge, phi_edge, expected))
    for label, Y_in, phi, expected in cases:
        N_, I_, T_ = Y_in.shape
        silent = (0, I_ // 2)  # SILENT_BINS at the main-path shape
        Y_in = Y_in.clone()
        Y_in[:, list(silent)] = 0
        variant = K.iss1_sweep_variant(N_, T_, phi.dim() == 3)
        Y_new, Y_2 = K.iss1_sweep(Y_in, phi, eps=ILRMA_EPS), K.iss1_sweep(Y_in, phi, eps=ILRMA_EPS)
        Y_ref = K.iss1_sweep_plain(Y_in, phi, eps=ILRMA_EPS)
        torch.cuda.synchronize()
        zero = all(int(torch.count_nonzero(Y_new[:, i])) == 0 for i in silent)
        repeat = bool(torch.equal(Y_new, Y_2))
        abs_err = float((Y_new - Y_ref).abs().max())
        rel_err = abs_err / float(Y_ref.abs().max())
        say("K2 iss1_sweep", weights=repr(label), shape=(N_, I_, T_), variant=variant, silent_bins=silent,
            silent_zero=zero, max_abs_err=abs_err, rel_err=rel_err, tol=ISS1_TOL, two_launches_equal=repeat)
        check(zero, f"iss1_sweep {label}: a silent (Y = 0) bin came back non-zero")
        check(rel_err <= ISS1_TOL and all_finite(Y_new), f"iss1_sweep {label}: rel err {rel_err}")
        check(repeat, f"iss1_sweep {label}: two launches differ")
        check(variant == expected, f"iss1_sweep {label}: ran the {variant} variant, expected {expected}")
        check(T_ > 1 or abs_err == 0.0, f"iss1_sweep {label}: one frame, {abs_err} off the plain version")
        iss1_abs = max(iss1_abs, abs_err)
    errors["iss1_sweep"] = iss1_abs

    # ---- 4c. the prox family's input, scaled on the card -------------------------------
    laps("4c")
    # a user's host spectrogram over its spectral norm: the entry point moves
    # it to the card and reads each bin's norm through one K7 launch
    totals = {name: 0 for name in KERNELS}
    X_host = X.cpu().numpy()

    def spectral_scaling():
        return PDSIVA().normalize_by_spectral_norm(X_host)

    X_prox = drive("normalize_by_spectral_norm (host spectrogram)", spectral_scaling, ("jacobi_eigh",), totals,
                   least=1, exact=True)
    X_prox_plain = run_plain(spectral_scaling)
    bin_norm = float(torch.linalg.matrix_norm(X_prox.permute(1, 0, 2), ord=2).max())
    scaling_rel = float((X_prox - X_prox_plain).abs().max() / X_prox_plain.abs().max())
    # mu1 mu2 max_i ||X_i||^2 at mu1 = mu2 = 1, which PDS needs <= 1, on bench.py:413's scaling
    max_magnitude_condition = float(torch.linalg.matrix_norm((X / X.abs().max()).permute(1, 0, 2), ord=2).max()) ** 2
    say("path vs plain", path=repr("normalize_by_spectral_norm (host spectrogram)"), device=X_prox.device,
        max_bin_norm=bin_norm, rel_err=scaling_rel, tol=PROX_TOL,
        max_magnitude_scaling_step_condition=max_magnitude_condition)
    check(X_prox.is_cuda and tuple(X_prox.shape) == (M, I, T) and all_finite(X_prox), "spectral scaling output")
    check(abs(bin_norm - 1) <= PROX_TOL and scaling_rel <= PROX_TOL, f"spectral scaling: {bin_norm}, {scaling_rel}")

    # ---- 4d. K7 against its plain version -----------------------------------------
    laps("4d")
    # the eigh inputs of the second iteration of PDSIVA (the right Grams) and
    # ADMMIVA (the right and left Grams, stacked)
    Y_zero = torch.zeros_like(X_prox)
    F_zero = torch.zeros_like(W_eye)
    quad_inv = prox_steps.admm_quad_inv(X_prox)
    pds_inputs, admm_inputs = [], []
    with recording_jacobi(pds_inputs, keep=True):
        W_1, Y_1 = prox_steps.pds_iva_step(X_prox, W_eye, Y_zero)
        prox_steps.pds_iva_step(X_prox, W_1, Y_1)
    with recording_jacobi(admm_inputs, keep=True):
        admm_1 = prox_steps.admm_iva_step(X_prox, F_zero, Y_zero, F_zero, Y_zero, quad_inv=quad_inv)
        prox_steps.admm_iva_step(X_prox, *admm_1[1:], quad_inv=quad_inv)
    A_pds, A_admm = pds_inputs[1], admm_inputs[1]
    check(tuple(A_pds.shape) == (I, 2 * M, 2 * M) and tuple(A_admm.shape) == (2 * I, 2 * M, 2 * M),
          f"K7 inputs {tuple(A_pds.shape)}, {tuple(A_admm.shape)}")
    ipa_inputs = []
    with recording_jacobi(ipa_inputs, keep=True):
        auxiva_ipa_step(X)
    A_ipa = ipa_inputs[-1]  # the last source's embedded LQPQM pencil
    check(len(ipa_inputs) == M and tuple(A_ipa.shape) == (I, 2 * (M - 1), 2 * (M - 1)), f"IPA pencils {tuple(A_ipa.shape)}")
    eigh_cases = [("PDSIVA right Grams", A_pds), ("ADMMIVA stacked Grams", A_admm), ("IPA pencil", A_ipa)]
    for n in JACOBI_SIZES:
        A_rand = torch.from_numpy(rng.standard_normal((I, n, n), dtype=np.float32)).to(device)
        eigh_cases.append((f"random n={n}", (A_rand + A_rand.transpose(-1, -2)).contiguous()))
    eigh_abs = 0.0

    def hold_eigh(label, A, rows=None, accuracy=True):
        """K7 on all of ``A`` against the plain version on ``A[rows]`` (all rows by default): bit for bit, twice.

        With ``accuracy``, the eigenvalues, the reconstruction and V^T V are also held to EIGH_TOL. The
        batches of 4h are held to the plain version bit for bit only: on them 6 sweeps of float32 Jacobi
        reconstruct to ~1.3e-5 of max |lambda|, in the plain version as in the kernel.
        """
        nonlocal eigh_abs
        rows = slice(None) if rows is None else rows
        lamb, V = K.jacobi_eigh(A)
        lamb_2, V_2 = K.jacobi_eigh(A)
        lamb, V, lamb_2, V_2 = lamb[rows], V[rows], lamb_2[rows], V_2[rows]
        A = A[rows]
        lamb_ref, V_ref = K.jacobi_eigh_plain(A)
        torch.cuda.synchronize()
        lamb_err, recon_err, ortho_err = eigh_errors(A, lamb, V, lamb_ref)
        abs_err = max(float((lamb - lamb_ref).abs().max()), float((V - V_ref).abs().max()))
        bitwise = bool(torch.equal(lamb, lamb_ref)) and bool(torch.equal(V, V_ref))
        repeat = bool(torch.equal(lamb, lamb_2)) and bool(torch.equal(V, V_2))
        say("K7 jacobi_eigh", input=repr(label), shape=tuple(A.shape), max_abs_err=abs_err, equal_to_plain=bitwise,
            two_launches_equal=repeat, lamb_rel_err=lamb_err, recon_rel_err=recon_err, ortho_err=ortho_err, tol=EIGH_TOL)
        check(all_finite(lamb, V) and bool((torch.diff(lamb, dim=-1) >= 0).all()), f"jacobi_eigh {label}: order")
        check(not accuracy or max(lamb_err, recon_err, ortho_err) <= EIGH_TOL,
              f"jacobi_eigh {label}: errors {lamb_err}, {recon_err}, {ortho_err}")
        check(bitwise and repeat, f"jacobi_eigh {label}: not bit-identical to plain ({bitwise}) or to itself ({repeat})")
        eigh_abs = max(eigh_abs, abs_err)

    for label, A in eigh_cases:
        hold_eigh(label, A)
    lamb, V = K.jacobi_eigh(torch.zeros_like(A_pds))
    torch.cuda.synchronize()
    identity = bool(torch.equal(V, torch.eye(2 * M, device=device).expand_as(V))) and not bool(lamb.any())
    say("K7 jacobi_eigh", input=repr("all zero"), shape=tuple(A_pds.shape), identity=identity)
    check(identity, "jacobi_eigh of a zero batch is not (0, I)")
    # the log-det prox through the kernel and through the plain version: a
    # spectral function, blind to the eigh's order within a tied pair
    G_pds = W_1 - torch.einsum("nit,mit->inm", Y_1, X_prox.conj())
    for lift_null in (False, True):
        got = prox_steps.prox_neg_logdet(G_pds, lift_null=lift_null)
        with plain_versions():
            ref = prox_steps.prox_neg_logdet(G_pds, lift_null=lift_null)
        prox_rel = float((got - ref).abs().max() / ref.abs().max())
        say("K7 prox_neg_logdet", lift_null=lift_null, shape=tuple(G_pds.shape), rel_err=prox_rel, tol=PROX_TOL)
        check(prox_rel <= PROX_TOL and all_finite(got), f"prox_neg_logdet lift_null={lift_null}: rel err {prox_rel}")

    # ---- 4e. K6 against its plain version ------------------------------------------
    laps("4e")
    # random input; the T, U and G of a real sweep's rounds (recorded through
    # the plain versions); and a batch with two all-zero bins
    def random_complex(shape):
        planes = rng.standard_normal((2, *shape), dtype=np.float32)
        return torch.complex(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])).to(device)

    T_rand, U_rand, G_rand = random_complex((I, M, M)), random_complex((I, M, M, M)), random_complex((I, M, M))
    rounds = []
    with plain_versions(), recording_congruence(rounds):
        auxiva_ipa_step(X)
    check(len(rounds) == M and tuple(rounds[-1][1].shape) == (I, M, M, M), f"recorded {len(rounds)} congruence rounds")
    U_silent = U_rand.clone()
    U_silent[list(SILENT_BINS)] = 0
    congruence_cases = [("random", (T_rand, U_rand, G_rand), ()),
                        ("sweep, first round", rounds[0], ()), ("sweep, last round", rounds[-1], ()),
                        ("two zero bins", (rounds[-1][0], U_silent, G_rand), SILENT_BINS)]
    # the kernel's instances at other N, with their own draws: T near the identity, two zero bins
    ipa_rng = np.random.default_rng(4)
    for N_, S_, I_ in IPA_EDGES:
        T_e, G_e, U_e = (
            torch.complex(*(torch.from_numpy(ipa_rng.standard_normal(shape, dtype=np.float32)) for _ in range(2)))
            .to(device) for shape in ((I_, N_, N_), (I_, N_, N_), (I_, S_, N_, N_)))
        T_e = torch.eye(N_, dtype=X.dtype, device=device) + 0.1 * T_e
        U_e[[0, I_ // 2]] = 0
        congruence_cases.append((f"N = {N_}, S = {S_}, two zero bins", (T_e, U_e, G_e), (0, I_ // 2)))
    congruence_abs = 0.0
    for label, (T_in, U_in, G_in), zero_bins in congruence_cases:
        U_new, G_new = K.ipa_congruence(T_in, U_in, G_in)
        U_2, G_2 = K.ipa_congruence(T_in, U_in, G_in)
        U_ref, G_ref = K.ipa_congruence_plain(T_in, U_in, G_in)
        torch.cuda.synchronize()
        abs_err = max(float((U_new - U_ref).abs().max()), float((G_new - G_ref).abs().max()))
        rel_err = max(float((U_new - U_ref).abs().max() / U_ref.abs().max()),
                      float((G_new - G_ref).abs().max() / G_ref.abs().max()))
        silent_zero = all(int(torch.count_nonzero(U_new[i])) == 0 for i in zero_bins) if zero_bins else None
        repeatable = torch.equal(U_new, U_2) and torch.equal(G_new, G_2)
        say("K6 ipa_congruence", input=repr(label), shape=tuple(U_in.shape), max_abs_err=abs_err, rel_err=rel_err,
            tol=IPA_TOL, max_abs_T=float(T_in.abs().max()), silent_zero=silent_zero, two_launches_equal=repeatable,
            equal_to_plain=torch.equal(U_new, U_ref) and torch.equal(G_new, G_ref))
        check(all_finite(U_new, G_new) and rel_err <= IPA_TOL, f"ipa_congruence {label}: rel err {rel_err}")
        check(silent_zero is not False, f"ipa_congruence {label}: a zero bin of U came back non-zero")
        check(repeatable, f"ipa_congruence {label}: two launches differ")
        if U_in.shape[-1] == M:
            congruence_abs = max(congruence_abs, abs_err)
    errors["ipa_congruence"] = congruence_abs
    T_sweep, U_sweep, G_sweep = rounds[-1]

    # ---- 4f. K4 and K5 against their plain versions -----------------------------------
    laps("4f")
    # the dense-MNMF model after two fused iterations of fast_gauss_mnmf_dense
    # (I T = 160,882 systems of 8 x 8) with the mixture's instant covariances;
    # and an edge batch: two all-zero XX bins, one bin of tiny Lamb and, for K4,
    # one all-zero R bin, whose pivots all take the 1e-20 floor
    XX_main = instant_covariance(X, eps=MNMF_EPS)
    _, (T_mnmf, V_mnmf, H_mnmf) = fast_gauss_mnmf_dense(X, n_basis=N_BASIS, n_iter=2, rng=np.random.default_rng(0))
    Lamb_main = (T_mnmf @ V_mnmf).contiguous()

    def ridge_model(Lamb):
        return psd_project(torch.einsum("nit,nipq->itpq", Lamb.to(X.dtype), H_mnmf), MNMF_EPS, "ridge").contiguous()

    R_main = ridge_model(Lamb_main)
    check(tuple(XX_main.shape) == tuple(R_main.shape) == (I, T, M, M), f"dense-MNMF model {tuple(R_main.shape)}")
    tiny_bin, zero_R_bin = 64, SILENT_BINS[0]
    XX_edge = XX_main.clone()
    XX_edge[list(SILENT_BINS)] = 0
    Lamb_edge = Lamb_main.clone()
    Lamb_edge[:, tiny_bin] = 1e-30
    R_edge = ridge_model(Lamb_edge)
    R_edge[zero_R_bin] = 0
    regular = [i for i in range(I) if i not in SILENT_BINS and i != tiny_bin]
    floor_inverse = 1 / torch.tensor(1e-20, dtype=torch.float32)

    sandwich_abs = 0.0
    for label, R_in, C_in in (("model after 2 iterations", R_main, XX_main),
                              ("two zero XX bins, a tiny-Lamb bin, a zero R bin", R_edge, XX_edge)):
        R_inv, S = K.inv_sandwich(R_in, C_in)
        R_inv_2, S_2 = K.inv_sandwich(R_in, C_in)
        R_inv_ref, S_ref = K.inv_sandwich_plain(R_in, C_in)
        torch.cuda.synchronize()
        # the same elimination, rounded as gj_inverse_plain rounds it, and the products summed in torch.matmul's
        # order: bit for bit (PERF.md, section 6), as two launches must be
        equal = torch.equal(R_inv, R_inv_ref) and torch.equal(S, S_ref)
        repeatable = torch.equal(R_inv, R_inv_2) and torch.equal(S, S_2)
        edge = label.startswith("two")
        bins = regular if edge else list(range(I))
        errs = (relative_error(R_inv[bins], R_inv_ref[bins]), relative_error(S[bins], S_ref[bins]))
        fields = {}
        if edge:
            fields = dict(
                tiny_bin_rel_err=(relative_error(R_inv[tiny_bin], R_inv_ref[tiny_bin]), relative_error(S[tiny_bin], S_ref[tiny_bin])),
                zero_XX_bins_S_zero=not bool(S[list(SILENT_BINS)].any()),
                zero_R_bin_floor=bool(torch.equal(R_inv[zero_R_bin], R_inv_ref[zero_R_bin]))
                and bool(torch.equal(R_inv[zero_R_bin][0], floor_inverse * torch.eye(M, dtype=X.dtype, device=device))),
            )
        say("K4 inv_sandwich", input=repr(label), shape=tuple(R_in.shape), variant=K.inv_sandwich_variant(M),
            rel_err=errs, tol=INV_SANDWICH_TOL, max_abs_R_inv=float(R_inv_ref[bins].abs().max()),
            equal_to_plain=equal, two_launches_equal=repeatable, **fields)
        check(all_finite(R_inv, S), f"inv_sandwich {label}: non-finite output")
        check(max(errs) <= INV_SANDWICH_TOL, f"inv_sandwich {label}: rel err {errs}")
        check(all(v is True or max(v) <= INV_SANDWICH_TOL for v in fields.values()), f"inv_sandwich {label}: {fields}")
        check(equal, f"inv_sandwich {label}: not equal to the plain version")
        check(repeatable, f"inv_sandwich {label}: two launches differ")
        if not edge:
            sandwich_abs = max(float((R_inv - R_inv_ref).abs().max()), float((S - S_ref).abs().max()))
    # the columns variant at an odd m and the rows variant (the first design, 9 <= m <= 16), with their own draws:
    # Hermitian positive definite pairs, system 1 all zero (its pivots floored, R^-1 = 1e20 I, S = 0) and the C
    # of system 2 zero
    sandwich_rng = np.random.default_rng(5)
    for m_, B_, expected in SANDWICH_EDGES:
        planes = sandwich_rng.standard_normal((4, B_, m_, m_), dtype=np.float32)
        eye = torch.eye(m_, dtype=X.dtype, device=device)
        R_in, C_in = (torch.complex(torch.from_numpy(planes[k]), torch.from_numpy(planes[k + 1])).to(device)
                      for k in (0, 2))
        R_in, C_in = ((A @ A.mH / m_ + 0.1 * eye).contiguous() for A in (R_in, C_in))
        R_in[1], C_in[1], C_in[2] = 0, 0, 0
        variant = K.inv_sandwich_variant(m_)
        R_inv, S = K.inv_sandwich(R_in, C_in)
        R_inv_2, S_2 = K.inv_sandwich(R_in, C_in)
        R_inv_ref, S_ref = K.inv_sandwich_plain(R_in, C_in)
        torch.cuda.synchronize()
        equal = torch.equal(R_inv, R_inv_ref) and torch.equal(S, S_ref)
        repeatable = torch.equal(R_inv, R_inv_2) and torch.equal(S, S_2)
        floored = bool(torch.equal(R_inv[1], floor_inverse * eye)) and not bool(S[[1, 2]].any())
        say("K4 inv_sandwich", input=repr(f"m = {m_}: a zero system, a zero C"), shape=(B_, m_, m_), variant=variant,
            equal_to_plain=equal, two_launches_equal=repeatable, zero_R_floor_zero_S=floored)
        check(variant == expected, f"inv_sandwich m = {m_}: ran the {variant} variant, expected {expected}")
        check(all_finite(R_inv, S) and equal, f"inv_sandwich m = {m_}: not equal to the plain version")
        check(repeatable, f"inv_sandwich m = {m_}: two launches differ")
        check(floored, f"inv_sandwich m = {m_}: the zero system's floor or the zero sandwiches")
    errors["inv_sandwich"] = sandwich_abs

    traces_abs = 0.0
    for label, Lamb_in, XX_in in (("model after 2 iterations", Lamb_main, XX_main),
                                  ("two zero XX bins, a tiny-Lamb bin", Lamb_edge, XX_edge)):
        out = K.model_traces(Lamb_in, H_mnmf, XX_in, MNMF_EPS)
        out_2 = K.model_traces(Lamb_in, H_mnmf, XX_in, MNMF_EPS)
        ref = K.model_traces_plain(Lamb_in, H_mnmf, XX_in, MNMF_EPS)
        torch.cuda.synchronize()
        edge = label.startswith("two")
        bins = regular if edge else list(range(I))
        errs = [relative_error(o[:, bins], r[:, bins]) for o, r in zip(out, ref)]
        repeat = all(bool(torch.equal(a, b)) for a, b in zip(out, out_2))
        abs_err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        fields = {}
        if edge:
            fields = dict(
                tiny_bin_rel_err=[relative_error(o[:, tiny_bin], r[:, tiny_bin]) for o, r in zip(out, ref)],
                zero_XX_bins_t1_Q_zero=not (bool(out[0][:, list(SILENT_BINS)].any()) or bool(out[3][:, list(SILENT_BINS)].any())),
            )
        say("K5 model_traces", input=repr(label), shape=(M, I, T, M), max_abs_err=abs_err, rel_err_t1_t2_P_Q=errs,
            tol=MODEL_TRACES_TOL, two_launches_equal=repeat, **fields)
        check(all_finite(*out), f"model_traces {label}: non-finite output")
        check(repeat, f"model_traces {label}: two launches on the same inputs differ")
        check(max(errs) <= MODEL_TRACES_TOL, f"model_traces {label}: rel err {errs}")
        check(all(v is True or max(v) <= MODEL_TRACES_TOL for v in fields.values()), f"model_traces {label}: {fields}")
        if not edge:
            traces_abs = abs_err
    # the step's two output modes, the traces alone (basis and activation
    # updates) and the sums alone (spatial update): each against the plain
    # version's same outputs, and equal to the kernel's full form
    full = K.model_traces(Lamb_main, H_mnmf, XX_main, MNMF_EPS)
    for outputs, picked in (("traces", full[:2]), ("sums", full[2:])):
        got = K.model_traces(Lamb_main, H_mnmf, XX_main, MNMF_EPS, outputs=outputs)
        ref = K.model_traces_plain(Lamb_main, H_mnmf, XX_main, MNMF_EPS, outputs=outputs)
        torch.cuda.synchronize()
        errs = [relative_error(o, r) for o, r in zip(got, ref)]
        same = len(got) == 2 and all(bool(torch.equal(o, f)) for o, f in zip(got, picked))
        say("K5 model_traces", input=repr("model after 2 iterations"), outputs=outputs, rel_err=errs,
            tol=MODEL_TRACES_TOL, equal_to_full_form=same)
        check(all_finite(*got) and max(errs) <= MODEL_TRACES_TOL and same, f"model_traces outputs={outputs}: {errs}, {same}")
    errors["model_traces"] = traces_abs

    # ---- 4g. K3 against its plain version ----------------------------------------------
    laps("4g")
    # IPSDTA's projected model after two iterations of fast_gauss_ipsdta at the
    # timing shape, both parts: (N, T, B, J, J) = (8, 626, 63, 4, 4) and
    # (8, 626, 1, 5, 5); a batch of zero matrices, whose pivots all take the
    # 1e-20 floor; random positive definite systems at GJ_INVERSE_SIZES, and
    # at m = 4 and 5 in GJ_INVERSE_BATCHES. Every case must equal the plain
    # version to the bit, and stay within GJ_INVERSE_TOL of it
    ipsdta_shapes = ipsdta_steps.part_shapes(I, IPSDTA_BLOCKS)
    _, (T_ip, V_ip), _ = fast_gauss_ipsdta(X, n_basis=N_BASIS, n_blocks=IPSDTA_BLOCKS, n_iter=2,
                                           rng=np.random.default_rng(0))
    R_ipsdta = [psd_project(ipsdta_steps._model(Tp, V_ip), IPSDTA_EPS, "ridge").contiguous() for Tp in T_ip]
    check([tuple(R.shape) for R in R_ipsdta] == [(M, T, B_, J_, J_) for B_, J_ in ipsdta_shapes] == [
        (M, T, 63, 4, 4), (M, T, 1, 5, 5)], f"IPSDTA models {[tuple(R.shape) for R in R_ipsdta]}")
    gj_cases = [("IPSDTA model, main part", R_ipsdta[0]), ("IPSDTA model, remainder part", R_ipsdta[1])]
    sizes = [(1000, m) for m in GJ_INVERSE_SIZES] + [(B_, m) for m in (4, 5) for B_ in GJ_INVERSE_BATCHES]
    gj_rng = np.random.default_rng(2)  # the draws of the sizes added after 16, 17 and 32, apart from `rng`'s
    for B_, m in sizes:
        if B_ == 1000 and m in (16, 17, 32):
            A_rand = random_complex((B_, m, m))
        else:
            planes = gj_rng.standard_normal((2, B_, m, m), dtype=np.float32)
            A_rand = torch.complex(torch.from_numpy(planes[0]), torch.from_numpy(planes[1])).to(device)
        gj_cases.append((f"random positive definite m={m}", (A_rand @ A_rand.mH / m + torch.eye(m, device=device)).contiguous()))
    gj_abs = 0.0
    for label, R_in in gj_cases:
        R_inv = K.gj_inverse(R_in)
        R_inv_ref = K.gj_inverse_plain(R_in)
        torch.cuda.synchronize()
        abs_err = float((R_inv - R_inv_ref).abs().max())
        rel_err = abs_err / float(R_inv_ref.abs().max())
        bitwise = bool(torch.equal(R_inv, R_inv_ref))
        m = R_in.shape[-1]
        say("K3 gj_inverse", input=repr(label), shape=tuple(R_in.shape), max_abs_err=abs_err, rel_err=rel_err,
            tol=GJ_INVERSE_TOL, equal_to_plain=bitwise, max_abs_R_inv=float(R_inv_ref.abs().max()),
            instance=K.gj_inverse_geometry(R_in.numel() // (m * m), m)["instance"])
        check(all_finite(R_inv) and rel_err <= GJ_INVERSE_TOL, f"gj_inverse {label}: rel err {rel_err}")
        # every input here is finite: the kernel keeps the plain version's bits
        check(bitwise, f"gj_inverse {label}: not bit-identical to the plain version")
        gj_abs = max(gj_abs, abs_err)
    zero = torch.zeros((M * T, 4, 4), dtype=X.dtype, device=device)
    R_inv = K.gj_inverse(zero)
    floored = bool(torch.equal(R_inv, K.gj_inverse_plain(zero))) and bool(
        torch.equal(R_inv[0], floor_inverse * torch.eye(4, dtype=X.dtype, device=device)))
    say("K3 gj_inverse", input=repr("all zero"), shape=tuple(zero.shape), floored_equal_to_plain=floored)
    check(all_finite(R_inv) and floored, "gj_inverse of a zero batch is not (1 / 1e-20) I as in the plain version")
    errors["gj_inverse"] = gj_abs

    # ---- 4h. K7 at the batches of the other paths -----------------------------------------
    laps("4h")
    # dense GaussMNMF's eigenvalue floor of the new spatial covariances (a
    # step's second eigh: B = N I = 2,056 of 16 x 16), IPSDTA's geometric mean
    # of the main part (B = 63 x 64 = 4,032 of 8 x 8) and the eigh model's PSD
    # projection of R (B = I T = 160,882 of 16 x 16). At 160,882 the plain
    # version (tens of seconds whole) runs on the first and the last
    # EIGH_SLICE matrices alone: each matrix is independent.
    mnmf_eighs, ipsdta_eighs, model_eighs = [], [], []
    with recording_jacobi(mnmf_eighs, keep=True):
        gauss_mnmf_step(XX_main, T_mnmf, V_mnmf, H_mnmf, eps=MNMF_EPS)
    with recording_jacobi(ipsdta_eighs, keep=True):
        ipsdta_steps.ipsdta_vcd_step(X, W_eye, list(T_ip), V_ip, eps=IPSDTA_EPS)
    with recording_jacobi(model_eighs, keep=True):
        psd_project(R_main, MNMF_EPS, "eigh")
    A_floor = mnmf_eighs[1]
    A_ipsdta = next(A for A in ipsdta_eighs if A.shape[-1] == 8)
    A_model = model_eighs[0]
    check(tuple(A_floor.shape) == (M * I, 2 * M, 2 * M) and tuple(A_ipsdta.shape) == (4032, 8, 8)
          and tuple(A_model.shape) == (I * T, 2 * M, 2 * M),
          f"K7 inputs {tuple(A_floor.shape)}, {tuple(A_ipsdta.shape)}, {tuple(A_model.shape)}")
    hold_eigh("dense-MNMF eigenvalue floor", A_floor, accuracy=False)
    hold_eigh("IPSDTA geometric mean, main part", A_ipsdta, accuracy=False)
    n_model = A_model.shape[0]
    hold_eigh(f"eigh model's R, first {EIGH_SLICE}", A_model, slice(0, EIGH_SLICE), accuracy=False)
    hold_eigh(f"eigh model's R, last {EIGH_SLICE}", A_model, slice(n_model - EIGH_SLICE, n_model), accuracy=False)

    # ---- 4i. K1, K1b and K7 at the shapes of FastGaussMNMF and cACGMM -------------------------
    laps("4i")
    # FastGaussMNMF's diagonalizer update in its third iteration from fast_gauss_mnmf's draws (4 channels): K1
    # with per-channel weights (M, I, T) = (4, 257, 626) and K1b at M = 4, its warp variant; cACGMM's E-step and
    # M-step embedded pencils in its third EM iteration from fast_cacgmm's draws: K7 at (N I, 2M, 2M) = (2056, 16, 16)
    X4 = X[:FAST_MNMF_CHANNELS].contiguous()
    M4 = FAST_MNMF_CHANNELS
    _, (T_f, V_f, Q_f, D_f) = fast_gauss_mnmf(X4, n_basis=FAST_MNMF_BASIS, n_iter=2, rng=np.random.default_rng(0))
    diagonalizer_inputs = []
    with recording(fast_mnmf_steps, "covariance", lambda X_in, phi: diagonalizer_inputs.append(phi)), recording(
            fast_mnmf_steps, "ip1_update", lambda W_in, U_in, **kw: diagonalizer_inputs.append((W_in, U_in))):
        fast_mnmf_steps.fast_gauss_mnmf_step(X4, Q_f, T_f, V_f, D_f)
    phi_mnmf, (Q_in, U_in) = diagonalizer_inputs
    check(tuple(phi_mnmf.shape) == (M4, I, T) and tuple(U_in.shape) == (I, M4, M4, M4),
          f"FastGaussMNMF diagonalizer inputs {tuple(phi_mnmf.shape)}, {tuple(U_in.shape)}")
    phi_mnmf, Q_in, U_in = phi_mnmf.contiguous(), Q_in.contiguous(), U_in.contiguous()
    errors["weighted_covariance"] = max(errors["weighted_covariance"],
                                        hold_wcov("per-channel (M,I,T), FastGaussMNMF", X4, phi_mnmf))
    errors["ip1_sweep"] = max(errors["ip1_sweep"], hold_ip1("FastGaussMNMF diagonalizer", Q_in, U_in, (), "warp"))

    Z8 = X / torch.clamp(torch.linalg.vector_norm(X, dim=0), min=1e-10)
    cacgmm_state = cacgmm_start(np.random.default_rng(0), M, I, device)
    for _ in range(2):
        cacgmm_state = cacgmm_steps.step(Z8, *cacgmm_state)
    cacgmm_eighs = []
    with recording_jacobi(cacgmm_eighs, keep=True):
        cacgmm_steps.step(Z8, *cacgmm_state)
    A_estep, A_mstep = cacgmm_eighs
    check(tuple(A_estep.shape) == tuple(A_mstep.shape) == (M * I, 2 * M, 2 * M),
          f"cACGMM pencils {tuple(A_estep.shape)}, {tuple(A_mstep.shape)}")
    hold_eigh("cACGMM E-step pencil", A_estep, accuracy=False)
    hold_eigh("cACGMM M-step projection", A_mstep, accuracy=False)

    # ---- 4j. K1 at IP2's pair weights, K7 at FasterIVA's top eigenvector and polar inputs ----------------------
    laps("4j")
    # AuxIVA-IP2's first pair from W = I: N = 2 weights (2, T) over the main path's mixture, and per-bin pair
    # weights (2, I, T); FasterIVA's first step on the whitened mixture: K7 at (N I, 2M, 2M) = (2056, 16, 16)
    # and on the polar factor's Gram (257, 16, 16)
    phi_pair = fast_varphi(separate(X, W_eye[:, :2])).contiguous()
    phi_pair_bins = phi_bins[:2].contiguous()
    for label, phi in (("pair (2,T), AuxIVA-IP2", phi_pair), ("per-bin pair (2,I,T)", phi_pair_bins)):
        errors["weighted_covariance"] = max(errors["weighted_covariance"], hold_wcov(label, X, phi))
    Z_main = fixed_point_iva_steps.whiten_spectrogram(X)
    faster_eighs = []
    with recording_jacobi(faster_eighs, keep=True):
        fixed_point_iva_steps.faster_iva_step(Z_main, W_eye)
    A_top, A_polar = faster_eighs
    check(tuple(A_top.shape) == (M * I, 2 * M, 2 * M) and tuple(A_polar.shape) == (I, 2 * M, 2 * M),
          f"FasterIVA eigh inputs {tuple(A_top.shape)}, {tuple(A_polar.shape)}")
    hold_eigh("FasterIVA top eigenvectors", A_top, accuracy=False)
    hold_eigh("FastIVA/FasterIVA polar factor's Gram", A_polar, accuracy=False)
    errors["jacobi_eigh"] = eigh_abs

    # ---- 4k. K1 and K1b at FDICA's per-scalar weights ---------------------------------------------------------------
    laps("4k")
    # AuxFDICA-IP1's third iteration from W = I: K1 with the per-scalar Laplace weights (N, I, T) = (8, 257, 626),
    # which reach 1 / eps = 1e6 in near-silent cells; K1b on the covariances of its first iteration (by the third,
    # the float32 twin itself sits ~1e-4 from the exact elimination); AuxFDICA-IP2's first pair: K1 at two sources
    # with per-scalar weights (2, I, T)
    phi_first = fdica_steps.scalar_laplace_varphi(X, fdica_steps.AUX_EPS).contiguous()
    errors["ip1_sweep"] = max(errors["ip1_sweep"], hold_ip1("AuxFDICA-IP1, first iteration", W_eye,
                                                            K.weighted_covariance(X, phi_first).contiguous(), (), "warp"))
    W_fdica = W_eye
    for _ in range(2):
        W_fdica = fdica_steps.aux_laplace_fdica_ip1_step(X, W_fdica)
    phi_fdica = fdica_steps.scalar_laplace_varphi(separate(X, W_fdica), fdica_steps.AUX_EPS).contiguous()
    errors["weighted_covariance"] = max(errors["weighted_covariance"],
                                        hold_wcov("per-scalar (N,I,T), AuxFDICA-IP1", X, phi_fdica))
    phi_fdica_pair = fdica_steps.scalar_laplace_varphi(separate(X, W_eye[:, :2]), fdica_steps.AUX_EPS).contiguous()
    errors["weighted_covariance"] = max(errors["weighted_covariance"],
                                        hold_wcov("per-scalar pair (2,I,T), AuxFDICA-IP2", X, phi_fdica_pair))

    # ---- 5. main path: AuxIVA-IP1 -------------------------------------------------
    laps("5")

    def auxiva_ip1():
        iva = AuxLaplaceIVA(spatial_algorithm="IP")
        Y_class = iva(X, n_iter=N_ITER)
        Y_fast, W_fast = fast_auxiva(X, n_iter=N_ITER, algorithm="IP1")
        y_wave = separate_waveform(wave, AuxLaplaceIVA(spatial_algorithm="IP"), n_iter=N_ITER,
                                   n_fft=N_FFT, hop_length=HOP)
        return iva, Y_class, Y_fast, W_fast, y_wave

    iva, Y_class, Y_fast, W_fast, y_wave = drive(
        "AuxIVA-IP1", auxiva_ip1, ("weighted_covariance", "ip1_sweep"), totals
    )
    check(all_finite(Y_class, Y_fast, W_fast, y_wave), "non-finite main-path output")
    check(tuple(Y_class.shape) == tuple(Y_fast.shape) == (M, I, T), "separated spectrogram shape")
    check(tuple(y_wave.shape) == tuple(wave.shape), "separated waveform shape")

    # the same iterations through the plain versions, on the card
    plain_iva, Y_class_plain, Y_fast_plain, W_fast_plain, y_wave_plain = run_plain(auxiva_ip1)
    hold_class("AuxLaplaceIVA(IP)", iva, Y_class, plain_iva, Y_class_plain)
    hold("fast_auxiva(IP1)", Y_fast, Y_fast_plain,
         float(iva_laplace_loss(X, W_fast)), float(iva_laplace_loss(X, W_fast_plain)))
    sdr_wave = min_si_sdr(y_wave, y_wave_plain)
    say("path vs plain", path=repr("separate (waveform), AuxIVA-IP1"), min_si_sdr_db=sdr_wave)
    check(sdr_wave >= MIN_SI_SDR_DB, f"pipeline output vs plain: {sdr_wave:.2f} dB")

    # ---- 5b. the slice: GaussILRMA-IP1, GaussILRMA-ISS1, AuxIVA-ISS1 ----------------
    laps("5b")

    def gauss_ilrma(spatial):
        """The class and the fast path, each from the NMF factors of ``default_rng(0)``."""
        method = GaussILRMA(n_basis=N_BASIS, spatial_algorithm=spatial, rng=np.random.default_rng(0))
        Y_class = method(X, n_iter=N_ITER)
        fast = fast_gauss_ilrma(X, n_basis=N_BASIS, n_iter=N_ITER, rng=np.random.default_rng(0),
                                algorithm="IP1" if spatial == "IP" else spatial)
        return method, Y_class, fast

    def fast_ilrma_loss(fast):
        Y, (T_, V_), W = fast
        return float(ilrma_loss(X, T_, V_, W=W) if W is not None else ilrma_loss(X, T_, V_, Y=Y))

    for spatial, uses in (("IP", ("weighted_covariance", "ip1_sweep")), ("ISS1", ("iss1_sweep",))):
        label = f"GaussILRMA-{'IP1' if spatial == 'IP' else spatial}"
        method, Y_class, fast = drive(label, lambda: gauss_ilrma(spatial), uses, totals)
        plain_method, Y_class_plain, fast_plain = run_plain(lambda: gauss_ilrma(spatial))
        check(all_finite(Y_class, *fast[:1], *fast[1]), f"{label}: non-finite output")
        hold_class(f"{label} class", method, Y_class, plain_method, Y_class_plain)
        hold(f"{label} fast", fast[0], fast_plain[0], fast_ilrma_loss(fast), fast_ilrma_loss(fast_plain))
        if spatial == "IP":
            ilrma_ip1_loss = method.loss[-1]  # IP2's anchor (5k): the same model from the same start

    def ilrma_iss1_waveform():
        method = GaussILRMA(n_basis=N_BASIS, spatial_algorithm="ISS1", rng=np.random.default_rng(0))
        return separate_waveform(wave, method, n_iter=N_ITER, n_fft=N_FFT, hop_length=HOP)

    y_ilrma = drive("separate (waveform), GaussILRMA-ISS1", ilrma_iss1_waveform, ("iss1_sweep",), totals)
    y_ilrma_plain = run_plain(ilrma_iss1_waveform)
    sdr = min_si_sdr(y_ilrma, y_ilrma_plain)
    say("path vs plain", path=repr("separate (waveform), GaussILRMA-ISS1"), min_si_sdr_db=sdr)
    check(all_finite(y_ilrma) and tuple(y_ilrma.shape) == tuple(wave.shape), "ILRMA waveform output")
    check(sdr >= MIN_SI_SDR_DB, f"ILRMA pipeline output vs plain: {sdr:.2f} dB")

    def auxiva_iss1():
        method = AuxLaplaceIVA(spatial_algorithm="ISS1")
        return method, method(X, n_iter=N_ITER), fast_auxiva(X, n_iter=N_ITER, algorithm="ISS1")[0]

    method, Y_class, Y_fast = drive("AuxIVA-ISS1", auxiva_iss1, ("iss1_sweep",), totals)
    plain_method, Y_class_plain, Y_fast_plain = run_plain(auxiva_iss1)
    hold_class("AuxIVA-ISS1 class", method, Y_class, plain_method, Y_class_plain)
    hold("AuxIVA-ISS1 fast", Y_fast, Y_fast_plain,
         float(iva_laplace_loss(X, Y=Y_fast)), float(iva_laplace_loss(X, Y=Y_fast_plain)))

    for cls, params in ((TILRMA, {"dof": 100}), (GGDILRMA, {"beta": 1.5})):
        for spatial, uses in (("IP1", ("weighted_covariance", "ip1_sweep")), ("ISS1", ("iss1_sweep",))):
            label = f"{cls.__name__}-{spatial}"
            method = cls(n_basis=N_BASIS, spatial_algorithm=spatial, rng=np.random.default_rng(0), **params)
            Y = drive(label, lambda: method(X, n_iter=N_ITER_MODELS), uses, totals, least=N_ITER_MODELS)
            say("path", path=repr(label), loss_first=method.loss[0], loss_last=method.loss[-1])
            check(all_finite(Y), f"{label}: non-finite output")
            check(method.loss[-1] < method.loss[0], f"{label}: loss did not decrease")

    # ---- 5b'. the IPA slice: AuxIVA-IPA and GaussILRMA-IPA ------------------------------
    laps("5b'")
    # per iteration K1 once (the full stack), K7 and K6 once per source. Each
    # fast path runs twice: as a user calls it, and without scale restoration
    # (projection back changes the loss's scale), whose loss is compared; the
    # plain twin and the control run only the latter.
    #
    # The float32 sweep is not held to an SI-SDR against its plain twin: where
    # the one Newton trip leaves the secular root next to the pole, the step
    # divides by a difference of a few ulps, and one sweep turns a relative
    # 1e-7 in its input into an output that agrees to a few dB, while the
    # loss moves by 1e-4. So the control below runs the kernels on the input
    # times (1 + 1e-7 noise) and prints both SI-SDRs side by side; what is
    # gated is the loss: it falls, it ends within SENSITIVE_LOSS_TOL of the plain run's,
    # and no higher (by more than ANCHOR_TOL) than where ISS1 takes the
    # same model from the same start.
    ipa_uses = {"weighted_covariance": 2 * N_ITER, "jacobi_eigh": 2 * M * N_ITER, "ipa_congruence": 2 * M * N_ITER}
    noise = torch.from_numpy(np.random.default_rng(1).standard_normal((M, I, T)).astype(np.float32)).to(device)
    X_perturbed = X * (1 + IPA_PERTURBATION * noise)

    # one sweep through the kernels on the input and on the perturbed input,
    # beside the same for ISS1: how much one step amplifies one f32 ulp
    T_ilrma = torch.from_numpy(np.random.default_rng(0).random((M, I, N_BASIS), dtype=np.float32)).to(device)
    V_ilrma = torch.from_numpy(np.random.default_rng(2).random((M, N_BASIS, T), dtype=np.float32)).to(device)
    one_sweep = {
        "AuxIVA-ISS1": lambda Y: auxiva_iss1_step(Y),
        "AuxIVA-IPA": lambda Y: auxiva_ipa_step(Y),
        "AuxIVA-IPA, newton_iter=3": lambda Y: auxiva_ipa_step(Y, newton_iter=3),
        "GaussILRMA-ISS1": lambda Y: ilrma_iss_step(Y, T_ilrma, V_ilrma)[0],
        "GaussILRMA-IPA": lambda Y: ilrma_iss_step(Y, T_ilrma, V_ilrma, spatial="IPA")[0],
    }
    for label, sweep in one_sweep.items():
        Y_one, Y_one_perturbed = sweep(X), sweep(X_perturbed)
        say("sensitivity", step=repr(label), sweeps=1, input_perturbation=IPA_PERTURBATION,
            min_si_sdr_db_vs_perturbed_input=min_si_sdr(Y_one, Y_one_perturbed),
            rel_diff=float((Y_one - Y_one_perturbed).abs().max() / Y_one.abs().max()), max_abs_output=float(Y_one.abs().max()))
        check(all_finite(Y_one, Y_one_perturbed), f"{label}: non-finite sweep")

    def hold_ipa(label, restored, raw, raw_plain, run_perturbed, loss_of, loss_start, loss_iss1):
        """The fast path as a user calls it (``restored``) must be finite; ``raw``, without scale restoration, is
        held by ``hold_sensitive`` with ISS1 as its anchor."""
        check(all_finite(restored) and tuple(restored.shape) == (M, I, T), f"{label}: non-finite output")
        hold_sensitive(label, raw[0], raw_plain[0], lambda: (lambda out: (out[0], loss_of(out)))(run_perturbed()),
                       loss_of(raw), loss_of(raw_plain), loss_first=loss_start, anchor=("ISS1", loss_iss1))

    def auxiva_ipa(X_in=X, restored=True):
        """``(as a user calls it, or None; without scale restoration)``."""
        return (fast_auxiva(X_in, n_iter=N_ITER, algorithm="IPA") if restored else None,
                fast_auxiva(X_in, n_iter=N_ITER, algorithm="IPA", scale_restoration=False))

    def iva_loss_of(out):
        return float(iva_laplace_loss(X, Y=out[0]))

    restored, raw = drive("AuxIVA-IPA", auxiva_ipa, ipa_uses, totals)
    _, raw_plain = run_plain(lambda: auxiva_ipa(restored=False))
    iss1_raw = fast_auxiva(X, n_iter=N_ITER, algorithm="ISS1", scale_restoration=False)
    hold_ipa("AuxIVA-IPA fast", restored[0], raw, raw_plain, lambda: auxiva_ipa(X_perturbed, restored=False)[1],
             iva_loss_of, float(iva_laplace_loss(X, Y=X)), iva_loss_of(iss1_raw))

    def gauss_ilrma_ipa(X_in=X, restored=True, algorithm="IPA"):
        kw = dict(n_basis=N_BASIS, n_iter=N_ITER, algorithm=algorithm)
        return (fast_gauss_ilrma(X_in, rng=np.random.default_rng(0), **kw) if restored else None,
                fast_gauss_ilrma(X_in, rng=np.random.default_rng(0), scale_restoration=False, **kw))

    restored, raw = drive("GaussILRMA-IPA", gauss_ilrma_ipa, ipa_uses, totals)
    _, raw_plain = run_plain(lambda: gauss_ilrma_ipa(restored=False))
    draws = np.random.default_rng(0)  # the factors fast_gauss_ilrma starts from
    T_start = torch.from_numpy(draws.random((M, I, N_BASIS)).astype(np.float32)).to(device)
    V_start = torch.from_numpy(draws.random((M, N_BASIS, T)).astype(np.float32)).to(device)
    check(all_finite(*raw[1]) and raw[2] is None, "GaussILRMA-IPA: non-finite factors")
    ilrma_loss_start = float(ilrma_loss(X, T_start, V_start, Y=X))
    hold_ipa("GaussILRMA-IPA fast", restored[0], raw, raw_plain, lambda: gauss_ilrma_ipa(X_perturbed, restored=False)[1],
             fast_ilrma_loss, ilrma_loss_start,
             fast_ilrma_loss(gauss_ilrma_ipa(restored=False, algorithm="ISS1")[1]))

    # the classes. AuxLaplaceIVA floors at 1e-6 in complex64 ("dtype"), where the
    # secular mask drops terms that matter and the loss swings far above its
    # start for some twenty iterations before it converges: that one runs
    # N_ITER, and the 1e-10 floor of fast_auxiva ("f64") runs beside it
    for label, method, n_iter in (
        ("AuxLaplaceIVA(IPA, flooring_fn='f64')", AuxLaplaceIVA(spatial_algorithm="IPA", flooring_fn="f64"), N_ITER_IPA_CLASSES),
        ("AuxLaplaceIVA(IPA)", AuxLaplaceIVA(spatial_algorithm="IPA"), N_ITER),
        ("GaussILRMA(IPA)", GaussILRMA(n_basis=N_BASIS, spatial_algorithm="IPA", rng=np.random.default_rng(0)), N_ITER_IPA_CLASSES),
    ):
        uses = {"weighted_covariance": n_iter, "jacobi_eigh": M * n_iter, "ipa_congruence": M * n_iter}
        Y = drive(label, lambda: method(X, n_iter=n_iter), uses, totals)
        say("path", path=repr(label), iterations=n_iter, loss_first=method.loss[0],
            loss_after_10=method.loss[N_ITER_IPA_CLASSES], loss_max=max(method.loss), loss_last=method.loss[-1])
        check(all_finite(Y) and method.demix_filter is None, f"{label}: non-finite output")
        check(method.loss[-1] < method.loss[0], f"{label}: loss did not decrease")

    # ---- 5c. the prox family: PDSIVA, HVA, ADMMIVA, MaskingADMMHVA ---------------------
    laps("5c")
    batches = []

    def prox_path(label, run, n_calls, n_iter, batch):
        """``run()`` through ``drive``: K7 exactly once per iteration of each of its ``n_calls`` entry points, on ``batch`` matrices."""
        batches.clear()
        with recording_jacobi(batches):
            out = drive(label, run, ("jacobi_eigh",), totals, least=n_calls * n_iter, exact=True)
        check(set(batches) == {batch}, f"{label}: K7 batches {sorted(set(batches))}, expected {batch}")
        return out

    def class_and_fast(cls, fast, X_in):
        method = cls()
        return method, method(X_in, n_iter=N_ITER), fast(X_in, n_iter=N_ITER)

    for label, cls, fast, batch in (("PDSIVA", PDSIVA, fast_pds_iva, I), ("ADMMIVA", ADMMIVA, fast_admm_iva, 2 * I)):
        run = functools.partial(class_and_fast, cls, fast, X_prox)
        method, Y_class, (Y_fast, W_fast) = prox_path(label, run, 2, N_ITER, batch)
        plain_method, Y_class_plain, (Y_fast_plain, W_fast_plain) = run_plain(run)
        hold_trace(f"{label} class", Y_class, Y_class_plain, method.loss, plain_method.loss)
        hold(f"{label} fast", Y_fast, Y_fast_plain, float(prox_steps.prox_iva_loss(X_prox, W_fast)),
             float(prox_steps.prox_iva_loss(X_prox, W_fast_plain)))

    def hva():
        return HVA()(X_prox, n_iter=N_ITER), fast_hva(X_prox, n_iter=N_ITER)[0]

    hva_out = prox_path("HVA", hva, 2, N_ITER, I)
    hva_plain = run_plain(hva)
    hold_sdr("HVA class", hva_out[0], hva_plain[0])
    hold_sdr("HVA fast", hva_out[1], hva_plain[1])

    def hva_unscaled_overflow():
        """The first iteration of HVA's step on the unscaled spectrogram whose filters are not finite (None: none)."""
        W, Y = W_eye, Y_zero
        for it in range(1, N_ITER + 1):
            W, Y = prox_steps.hva_pds_step(X, W, Y)
            if not all_finite(W):
                return it
        return None

    overflow, overflow_plain = hva_unscaled_overflow(), run_plain(hva_unscaled_overflow)
    say("path", path=repr("HVA step, unscaled spectrogram"), first_non_finite_iteration=overflow,
        plain_first_non_finite_iteration=overflow_plain, max_abs_input=float(X.abs().max()))
    check(overflow == overflow_plain, "HVA unscaled: the kernel and the plain version leave f32 at other iterations")

    def masking_admm_hva():
        return MaskingADMMHVA()(X_prox, n_iter=N_ITER_MASKING_ADMM)

    Y_mah = prox_path("MaskingADMMHVA", masking_admm_hva, 1, N_ITER_MASKING_ADMM, 2 * I)
    hold_sdr("MaskingADMMHVA class", Y_mah, run_plain(masking_admm_hva))

    # ---- 5d. dense GaussMNMF: the fused route (K5, K7) and the eigh route (K4, K7) -------
    laps("5d")
    # per iteration K5 three times and K7 twice (the geometric mean and H's floor, B = N I);
    # each path beside its plain twin, and a control run of the kernels on the
    # input times (1 + 1e-7 noise), printed before the gates
    mnmf_uses = {"model_traces": 3 * N_ITER, "jacobi_eigh": 2 * N_ITER}

    def mnmf_class(X_in=X):
        method = GaussMNMF(n_basis=N_BASIS, rng=np.random.default_rng(0))
        return method, method(X_in, n_iter=N_ITER)

    batches.clear()
    with recording_jacobi(batches):
        method, Y_class = drive("GaussMNMF", mnmf_class, mnmf_uses, totals, exact=True)
    check(set(batches) == {M * I}, f"GaussMNMF: K7 batches {sorted(set(batches))}, expected {M * I}")
    plain_method, Y_class_plain = run_plain(mnmf_class)
    control_method, Y_class_control = mnmf_class(X_perturbed)
    say("sensitivity", path=repr("GaussMNMF class"), iterations=N_ITER, input_perturbation=IPA_PERTURBATION,
        min_si_sdr_db_vs_perturbed_input=min_si_sdr(Y_class, Y_class_control), loss=method.loss[-1],
        perturbed_input_loss=control_method.loss[-1])
    hold_class("GaussMNMF class", method, Y_class, plain_method, Y_class_plain)

    draws = np.random.default_rng(0)  # the factors fast_gauss_mnmf_dense starts from
    T_start, V_start = (torch.from_numpy(np.maximum(draws.random(shape), 1e-10).astype(np.float32)).to(device)
                        for shape in ((M, I, N_BASIS), (M, N_BASIS, T)))
    H_start = (torch.eye(M, dtype=X.dtype, device=device) / M).expand(M, I, M, M).contiguous()

    def mnmf_fast(X_in=X):
        return fast_gauss_mnmf_dense(X_in, n_basis=N_BASIS, n_iter=N_ITER, rng=np.random.default_rng(0))

    def mnmf_loss_of(factors, XX_in=XX_main, **kw):
        return float(gauss_mnmf_loss(XX_in, *factors, eps=MNMF_EPS, **kw))

    Y_fast, factors = drive("fast_gauss_mnmf_dense", mnmf_fast, mnmf_uses, totals, exact=True)
    Y_fast_plain, factors_plain = run_plain(mnmf_fast)
    Y_fast_control, factors_control = mnmf_fast(X_perturbed)
    mnmf_loss_start = mnmf_loss_of((T_start, V_start, H_start))
    say("sensitivity", path=repr("fast_gauss_mnmf_dense"), iterations=N_ITER, input_perturbation=IPA_PERTURBATION,
        min_si_sdr_db_vs_perturbed_input=min_si_sdr(Y_fast, Y_fast_control), loss=mnmf_loss_of(factors),
        perturbed_input_loss=mnmf_loss_of(factors_control))
    hold("fast_gauss_mnmf_dense", Y_fast, Y_fast_plain, mnmf_loss_of(factors), mnmf_loss_of(factors_plain),
         loss_first=mnmf_loss_start)
    check(mnmf_loss_of(factors) < mnmf_loss_start, "fast_gauss_mnmf_dense: loss did not fall")

    # the eigh model in float32: unfused, K4 three times per iteration; K7 on
    # the instant covariances and on each model R (B = I T = 160,882), on P,
    # HQH, the geometric mean and H (B = N I), and on the loss's model
    def mnmf_eigh():
        XX_e = instant_covariance(X, eps=MNMF_EPS, psd_impl="eigh")
        factors = (T_start, V_start, H_start)
        losses = [gauss_mnmf_loss(XX_e, *factors, eps=MNMF_EPS, psd_impl="eigh")]
        for _ in range(N_ITER_MNMF_EIGH):
            factors = gauss_mnmf_step(XX_e, *factors, eps=MNMF_EPS, psd_impl="eigh")
            losses.append(gauss_mnmf_loss(XX_e, *factors, eps=MNMF_EPS, psd_impl="eigh"))
        return wiener_separate(X, factors[0] @ factors[1], factors[2]), torch.stack(losses).tolist()

    eigh_uses = {"inv_sandwich": 3 * N_ITER_MNMF_EIGH, "jacobi_eigh": 1 + 7 * N_ITER_MNMF_EIGH + N_ITER_MNMF_EIGH + 1}
    batches.clear()
    with recording_jacobi(batches):
        Y_eigh, loss_eigh = drive("GaussMNMF step, eigh model", mnmf_eigh, eigh_uses, totals, exact=True)
    check(set(batches) == {I * T, M * I}, f"eigh model: K7 batches {sorted(set(batches))}, expected {I * T} and {M * I}")
    start = time.perf_counter()
    Y_eigh_plain, loss_eigh_plain = run_plain(mnmf_eigh)
    say("path", path=repr("GaussMNMF step, eigh model, plain versions"), iterations=N_ITER_MNMF_EIGH,
        seconds=f"{time.perf_counter() - start:.3f}")
    hold("GaussMNMF step, eigh model", Y_eigh, Y_eigh_plain, loss_eigh[-1], loss_eigh_plain[-1],
         loss_first=loss_eigh[0], first_divergent_iteration=first_divergence(loss_eigh, loss_eigh_plain, LOSS_TOL))
    check(loss_eigh[-1] < loss_eigh[0], f"eigh model: loss did not fall: {loss_eigh[0]} -> {loss_eigh[-1]}")

    # ---- 5e. IPSDTA: fast_gauss_ipsdta, fast_t_ipsdta, GaussIPSDTA, the hard tier ---------------
    laps("5e")
    # per iteration K3 three times per part (the model's inverse before the
    # basis, the activation and the spatial update) and K7 once per part
    # (Gauss: the geometric mean's 2J x 2J embedding) or twice (t: Q^1/2 and
    # M^-1/2). The fast paths run without scale restoration, whose filters
    # the loss reads; each is held against its plain twin (K3 and K7 plain).
    def ipsdta_start():
        T0, V0 = ipsdta_steps.random_psdtf(np.random.default_rng(0), M, N_BASIS, T, ipsdta_shapes, X.dtype, device,
                                           IPSDTA_EPS)
        T0, V0 = ipsdta_steps.normalize_psdtf(T0, V0)
        return W_eye, T0, V0

    def ipsdta_fast(dof):
        kw = dict(n_basis=N_BASIS, n_blocks=IPSDTA_BLOCKS, n_iter=N_ITER_IPSDTA, scale_restoration=False,
                  rng=np.random.default_rng(0))
        return fast_gauss_ipsdta(X, **kw) if dof is None else fast_t_ipsdta(X, dof=dof, **kw)

    def ipsdta_loss_of(out, dof):
        _, (T_parts, V_), W_ = out
        return float(ipsdta_steps.ipsdta_loss(X, W_, T_parts, V_, dof=dof, eps=IPSDTA_EPS))

    ipsdta_fast_out = {}
    for label, dof, k7_per_iter in (("fast_gauss_ipsdta", None, 2), ("fast_t_ipsdta", IPSDTA_DOF, 4)):
        uses = {"gj_inverse": 3 * len(ipsdta_shapes) * N_ITER_IPSDTA, "jacobi_eigh": k7_per_iter * N_ITER_IPSDTA}
        k3_sizes = []
        with recording(ipsdta_steps, "hermitian_inverse", size_of(k3_sizes)):
            out = drive(label, functools.partial(ipsdta_fast, dof), uses, totals, exact=True)
        check(sorted(set(k3_sizes)) == [4, 5], f"{label}: K3 sizes {sorted(set(k3_sizes))}")
        out_plain = run_plain(functools.partial(ipsdta_fast, dof))
        start = ipsdta_start()
        loss_start = float(ipsdta_steps.ipsdta_loss(X, start[0], list(start[1]), start[2], dof=dof, eps=IPSDTA_EPS))
        check(all_finite(out[0], out[2], out[1][1], *out[1][0]), f"{label}: non-finite output")
        hold(label, out[0], out_plain[0], ipsdta_loss_of(out, dof), ipsdta_loss_of(out_plain, dof),
             loss_first=loss_start, iterations=N_ITER_IPSDTA)
        check(ipsdta_loss_of(out, dof) < loss_start, f"{label}: loss did not fall")
        ipsdta_fast_out[label] = out

    def gauss_ipsdta_class():
        method = GaussIPSDTA(n_basis=N_BASIS, n_blocks=IPSDTA_BLOCKS, scale_restoration=False,
                             rng=np.random.default_rng(0))
        return method, method(X, n_iter=N_ITER_IPSDTA)

    method, Y_class = drive("GaussIPSDTA", gauss_ipsdta_class,
                            {"gj_inverse": 3 * len(ipsdta_shapes) * N_ITER_IPSDTA, "jacobi_eigh": 2 * N_ITER_IPSDTA},
                            totals, exact=True)
    Y_fast, (T_fast, V_fast), _ = ipsdta_fast_out["fast_gauss_ipsdta"]
    same = bool(torch.equal(Y_class, Y_fast)) and bool(torch.equal(method.activation, V_fast)) and all(
        torch.equal(a, b) for a, b in zip(method.basis, T_fast))
    say("path vs fast path", path=repr("GaussIPSDTA"), equal=same, loss_first=method.loss[0],
        loss_last=method.loss[-1], max_abs_diff=float((Y_class - Y_fast).abs().max()))
    check(same, "GaussIPSDTA differs from fast_gauss_ipsdta from the same draws")
    check(len(method.loss) == N_ITER_IPSDTA + 1 and method.loss[-1] < method.loss[0], "GaussIPSDTA: loss did not fall")

    # the hard tier: 4 channels, 257 bins in 15 blocks of 16 and one of 17, the
    # warm start and iterations of tests/test_hard_fidelity.py:352-400; K3 at
    # m = 16 and 17, K7 on the 32 x 32 embedding, torch.linalg.eigh on the 34 x 34
    images, _ = hard_speech_mixture()
    hard_mix = torch.from_numpy(images.sum(axis=0)).to(device)
    X_hard = stft(hard_mix, n_fft=HARD_N_FFT, hop_length=HARD_HOP, device=device).to(torch.complex64)
    hard_M, hard_I, hard_T = X_hard.shape
    draws = np.random.default_rng(HARD_SEED)
    hard_basis = tuple(draws.random((hard_M, HARD_BASIS, B_, J_))[..., None] * np.eye(J_)
                       for B_, J_ in ipsdta_steps.part_shapes(hard_I, HARD_BLOCKS))
    hard_activation = draws.random((hard_M, HARD_BASIS, hard_T))

    def hard_tier():
        method = GaussIPSDTA(n_basis=HARD_BASIS, n_blocks=HARD_BLOCKS, record_loss=False)
        return method(X_hard, n_iter=HARD_ITER, basis=hard_basis, activation=hard_activation)

    k3_sizes, eigh_sizes = [], []
    with recording(ipsdta_steps, "hermitian_inverse", size_of(k3_sizes)), recording(prox_steps, "symm_eigh", size_of(eigh_sizes)):
        Y_hard = drive("GaussIPSDTA, hard tier (complex64, J = 16 and 17)", hard_tier,
                       {"gj_inverse": 6 * HARD_ITER, "jacobi_eigh": HARD_ITER}, totals, exact=True)
    y_hard = istft(Y_hard.to(torch.complex128), n_fft=HARD_N_FFT, hop_length=HARD_HOP, length=images.shape[-1],
                   device=device)
    hard_db = best_permutation_si_sdr(y_hard.cpu().numpy(), images[:, 0])
    say("path", path=repr("GaussIPSDTA, hard tier"), shape=tuple(X_hard.shape), k3_sizes=sorted(set(k3_sizes)),
        eigh_sizes=sorted(set(eigh_sizes)), si_sdr_db=hard_db, pin_db=HARD_PIN_DB, tol_db=HARD_PIN_TOL_DB)
    check(all_finite(Y_hard), "hard tier: non-finite output")
    check(sorted(set(k3_sizes)) == [16, 17] and sorted(set(eigh_sizes)) == [32, 34],
          f"hard tier: K3 sizes {sorted(set(k3_sizes))}, eigh sizes {sorted(set(eigh_sizes))}")
    check(abs(hard_db - HARD_PIN_DB) <= HARD_PIN_TOL_DB, f"hard tier: {hard_db:.5f} dB against the pin {HARD_PIN_DB}")

    # ---- 5f. FastGaussMNMF (4 channels): K1 with per-channel weights and K1b, once each per iteration ----------
    laps("5f")
    def fast_mnmf_paths():
        method = FastGaussMNMF(n_basis=FAST_MNMF_BASIS, rng=np.random.default_rng(0))
        Y_class = method(X4, n_iter=N_ITER)
        return method, Y_class, fast_gauss_mnmf(X4, n_basis=FAST_MNMF_BASIS, n_iter=N_ITER, rng=np.random.default_rng(0))

    def fast_mnmf_loss_of(factors):
        T_, V_, Q_, D_ = factors
        return float(fast_mnmf_steps.fast_gauss_mnmf_loss(X4, Q_, T_, V_, D_))

    label = f"FastGaussMNMF ({M4} ch)"
    method, Y_class, (Y_fast, factors) = drive(label, fast_mnmf_paths, ("weighted_covariance", "ip1_sweep"), totals,
                                               least=2 * N_ITER, exact=True)
    plain_method, Y_class_plain, (Y_fast_plain, factors_plain) = run_plain(fast_mnmf_paths)
    same = bool(torch.equal(Y_class, Y_fast)) and all(
        torch.equal(a, b) for a, b in zip((method.basis, method.activation, method.diagonalizer, method.spatial), factors))
    say("path vs fast path", path=repr("FastGaussMNMF"), equal=same, max_abs_diff=float((Y_class - Y_fast).abs().max()))
    check(same, "FastGaussMNMF differs from fast_gauss_mnmf from the same draws")
    hold_class(f"{label} class", method, Y_class, plain_method, Y_class_plain)
    hold(f"fast_gauss_mnmf ({M4} ch)", Y_fast, Y_fast_plain, fast_mnmf_loss_of(factors), fast_mnmf_loss_of(factors_plain),
         loss_first=method.loss[0])

    # ---- 5g. cACGMM (8 channels): K7 on the E-step's and the M-step's pencils, twice per iteration --------------
    laps("5g")
    # the class (posterior-score alignment, a loss per iteration: three K7 launches an iteration and one for the
    # last posterior) and the fast path (amplitude-correlation alignment: two an iteration and one)
    def cacgmm_paths():
        method = CACGMM(rng=np.random.default_rng(0))
        Y_class = method(X, n_iter=N_ITER)
        return method, Y_class, fast_cacgmm(X, n_iter=N_ITER, rng=np.random.default_rng(0))

    cacgmm_uses = {"jacobi_eigh": (3 * N_ITER + 2) + (2 * N_ITER + 1)}
    batches.clear()
    with recording_jacobi(batches):
        method, Y_class, Y_fast = drive("cACGMM (8 ch)", cacgmm_paths, cacgmm_uses, totals, exact=True)
    check(set(batches) == {M * I}, f"cACGMM: K7 batches {sorted(set(batches))}, expected {M * I}")
    start = time.perf_counter()
    plain_method, Y_class_plain, Y_fast_plain = run_plain(cacgmm_paths)
    say("path", path=repr("cACGMM, plain versions"), seconds=f"{time.perf_counter() - start:.3f}")
    hold_class("CACGMM class", method, Y_class, plain_method, Y_class_plain)
    hold_sdr("fast_cacgmm", Y_fast, Y_fast_plain)
    check(tuple(Y_fast.shape) == (M, I, T), f"fast_cacgmm output {tuple(Y_fast.shape)}")

    def cacgmm_unaligned(**kw):
        gmm = CACGMM(rng=np.random.default_rng(0), permutation_alignment=False, **kw)
        return gmm, gmm(X, n_iter=N_ITER)

    gmm, Y_unaligned = cacgmm_unaligned()
    same = bool(torch.equal(Y_unaligned, fast_cacgmm(X, n_iter=N_ITER, permutation_alignment=False,
                                                     rng=np.random.default_rng(0))))
    say("path vs fast path", path=repr("CACGMM, unaligned"), equal=same, loss_last=gmm.loss[-1],
        aligned_class_loss_last=method.loss[-1])
    check(same, "CACGMM differs from fast_cacgmm from the same draws")
    # the masks with TF32 allowed, against full float32 (the path itself keeps it off)
    torch.backends.cuda.matmul.allow_tf32 = True
    gmm_tf32, _ = cacgmm_unaligned(record_loss=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32_rel_l2 = float(torch.linalg.vector_norm(gmm_tf32.posterior - gmm.posterior) / torch.linalg.vector_norm(gmm.posterior))
    say("precision", path=repr("cACGMM masks, 100 EM iterations"), tf32_vs_full_f32_rel_l2=tf32_rel_l2,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    for label, kw in (("CACGMM(impl='chol')", dict(impl="chol")),
                      ("CACGMM(covariance_impl='kernel')", dict(covariance_impl="kernel"))):
        uses = {"weighted_covariance": N_ITER, "jacobi_eigh": 3 * N_ITER + 2} if "kernel" in label else {}
        gmm_route, Y_route = drive(label, lambda: cacgmm_unaligned(**kw), uses, totals, exact=True)
        say("path", path=repr(label), loss_first=gmm_route.loss[0], loss_last=gmm_route.loss[-1],
            loss_rel_diff_to_eigh=abs(gmm_route.loss[-1] - gmm.loss[-1]) / abs(gmm.loss[-1]),
            min_si_sdr_db_vs_eigh=min_si_sdr(Y_route, Y_unaligned))
        check(all_finite(Y_route) and gmm_route.loss[-1] < gmm_route.loss[0], f"{label}: non-finite or no descent")

    # ---- 5h. the hard tier of FastGaussMNMF and cACGMM (4 channels, STFT 4096/1024) ----------------------------
    laps("5h")
    X_wide = stft(hard_mix, n_fft=HARD_TIER_N_FFT, hop_length=HARD_TIER_HOP, device=device)  # complex128
    wide_M, wide_I, wide_T = X_wide.shape

    def quality(Y):
        y = istft(Y.to(torch.complex128), n_fft=HARD_TIER_N_FFT, hop_length=HARD_TIER_HOP, length=images.shape[-1],
                  device=device)
        return best_permutation_si_sdr(y.cpu().numpy(), images[:, 0])

    Y_hard = drive("fast_cacgmm, hard tier", lambda: fast_cacgmm(X_wide, n_iter=HARD_CACGMM_ITER,
                                                                rng=np.random.default_rng(HARD_CACGMM_SEED)),
                   {"jacobi_eigh": 2 * HARD_CACGMM_ITER + 1}, totals, exact=True)
    hard_db = quality(Y_hard)
    say("path", path=repr("fast_cacgmm, hard tier"), shape=tuple(X_wide.shape), si_sdr_db=hard_db,
        pin_db=HARD_CACGMM_PIN_DB, tol_db=HARD_CACGMM_TOL_DB)
    check(all_finite(Y_hard) and abs(hard_db - HARD_CACGMM_PIN_DB) <= HARD_CACGMM_TOL_DB,
          f"fast_cacgmm hard tier: {hard_db:.5f} dB against the pin {HARD_CACGMM_PIN_DB}")

    draws = np.random.default_rng(HARD_FAST_MNMF_SEED)
    hard_draws = (draws.random((wide_M, wide_I, HARD_FAST_MNMF_BASIS)), draws.random((wide_M, HARD_FAST_MNMF_BASIS, wide_T)),
                  draws.random((wide_I, wide_M, wide_M)))
    Y_hard, f32_factors = drive("fast_gauss_mnmf, hard tier", lambda: fast_gauss_mnmf(
        X_wide, n_basis=HARD_FAST_MNMF_BASIS, n_iter=HARD_FAST_MNMF_ITER, rng=FixedRng(*hard_draws)),
        ("weighted_covariance", "ip1_sweep"), totals, least=HARD_FAST_MNMF_ITER, exact=True)
    f32_db = quality(Y_hard)
    # once more in complex128 (the class: the plain routes, the reference's floor 1e-10)
    f64 = FastGaussMNMF(n_basis=HARD_FAST_MNMF_BASIS, rng=FixedRng(*hard_draws), record_loss=False)
    Y_f64 = drive("FastGaussMNMF complex128, hard tier", lambda: f64(X_wide, n_iter=HARD_FAST_MNMF_ITER), {}, totals,
                  exact=True)
    f64_db = quality(Y_f64)
    T32, V32, Q32, D32 = (a.to(torch.complex128 if a.is_complex() else torch.float64) for a in f32_factors)
    T64, V64, Q64, D64 = f64.basis, f64.activation, f64.diagonalizer, f64.spatial
    # the gap carried by T and V: separate with the float32 run's T and V and the complex128 run's Q and D
    tv32_db = quality(fast_mnmf_steps.fast_mnmf_separate(X_wide, T32, V32, Q64, D64))
    qd32_db = quality(fast_mnmf_steps.fast_mnmf_separate(X_wide, T64, V64, Q32, D32))

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    say("path", path=repr("fast_gauss_mnmf, hard tier"), shape=tuple(X_wide.shape), si_sdr_db=f32_db,
        pin_db=HARD_FAST_MNMF_PIN_DB, tol_db=HARD_FAST_MNMF_TOL_DB, complex128_si_sdr_db=f64_db,
        float32_gap_db=f32_db - f64_db, f32_T_V_with_f64_Q_D_db=tv32_db, f64_T_V_with_f32_Q_D_db=qd32_db,
        share_of_gap_in_T_V=(tv32_db - f64_db) / (f32_db - f64_db) if f32_db != f64_db else None,
        T_rel_l2=rel_l2(T32, T64), V_rel_l2=rel_l2(V32, V64), Q_rel_l2=rel_l2(Q32, Q64), D_rel_l2=rel_l2(D32, D64))
    check(all_finite(Y_hard, Y_f64) and abs(f32_db - HARD_FAST_MNMF_PIN_DB) <= HARD_FAST_MNMF_TOL_DB,
          f"fast_gauss_mnmf hard tier: {f32_db:.5f} dB against the pin {HARD_FAST_MNMF_PIN_DB}")

    # ---- 5i. the routers on the card: complex128 classes, a float64 waveform, 18 channels --------------------
    laps("5i")
    X128 = stft(wave[:4, : 2 * 16000].to(torch.float64), n_fft=N_FFT, hop_length=HOP, device=device)
    for label, make in (
        ("AuxLaplaceIVA(IP1)", lambda device: AuxLaplaceIVA(spatial_algorithm="IP", device=device)),
        ("GaussILRMA(ISS1)", lambda device: GaussILRMA(n_basis=2, spatial_algorithm="ISS1",
                                                       rng=np.random.default_rng(0), device=device)),
        ("AuxLaplaceIVA(IPA)", lambda device: AuxLaplaceIVA(spatial_algorithm="IPA", device=device)),
    ):
        card_method = make(device)
        Y = drive(f"{label}, complex128", lambda: card_method(X128, n_iter=ROUTE_ITER), {}, totals, exact=True)
        host_method = make("cpu")
        host_method(X128.cpu(), n_iter=ROUTE_ITER)
        rel = abs(card_method.loss[-1] - host_method.loss[-1]) / abs(host_method.loss[-1])
        say("route", path=repr(f"{label}, complex128"), shape=tuple(X128.shape), route=repr("plain versions"),
            loss=card_method.loss[-1], cpu_loss=host_method.loss[-1], loss_rel_diff=rel, tol=ROUTE_LOSS_TOL)
        check(all_finite(Y) and Y.dtype == torch.complex128 and rel <= ROUTE_LOSS_TOL, f"{label} complex128: {rel}")
    wave64 = wave[:4, : 2 * 16000].cpu().numpy().astype(np.float64)
    y_route = drive("separate (float64 waveform), GaussILRMA-ISS1", lambda: separate_waveform(
        wave64, GaussILRMA(n_basis=2, spatial_algorithm="ISS1", rng=np.random.default_rng(0)), n_iter=ROUTE_ITER,
        n_fft=N_FFT, hop_length=HOP), {}, totals, exact=True)
    say("route", path=repr("separate (float64 waveform), GaussILRMA-ISS1"), dtype=y_route.dtype,
        route=repr("plain versions (complex128)"))
    check(all_finite(y_route) and y_route.dtype == torch.float64 and tuple(y_route.shape) == wave64.shape,
          "separate on a float64 waveform")
    wave18 = torch.from_numpy(make_mixture(seed=1, n_channels=18, duration_s=2.0)).to(device=device, dtype=torch.float32)
    X18 = stft(wave18, n_fft=N_FFT, hop_length=HOP, device=device)
    Y18, W18 = drive("fast_auxiva(IP1), 18 channels",
                     lambda: fast_auxiva(X18, n_iter=ROUTE_ITER, scale_restoration=False),
                     {"weighted_covariance": ROUTE_ITER}, totals, exact=True)
    loss_first = float(iva_laplace_loss(X18, torch.eye(18, dtype=X18.dtype, device=device).expand(X18.shape[1], -1, -1)))
    loss_last = float(iva_laplace_loss(X18, W18))
    say("route", path=repr("fast_auxiva(IP1), 18 channels"), shape=tuple(X18.shape),
        route=repr("K1 kernel; IP1 sweep plain (K1b takes M <= 17)"), k1b_takes=K.ip1_sweep_takes(18),
        loss_first=loss_first, loss_last=loss_last)
    check(all_finite(Y18, W18) and loss_last < loss_first, "fast_auxiva, 18 channels: non-finite or no descent")

    # ---- 5j. the waveform entry points against the spectrogram path between the transforms ------------------
    laps("5j")
    for label, entry, spectrogram_path, uses in (
        ("fast_auxiva_wave(IP1)", lambda: fast_auxiva_wave(wave, n_iter=N_ITER, n_fft=N_FFT, hop_length=HOP),
         lambda X_in: fast_auxiva(X_in, n_iter=N_ITER)[0], ("weighted_covariance", "ip1_sweep")),
        ("fast_gauss_ilrma_wave(IP1)", lambda: fast_gauss_ilrma_wave(wave, n_basis=N_BASIS, n_iter=N_ITER, n_fft=N_FFT,
                                                                     hop_length=HOP, rng=np.random.default_rng(0)),
         lambda X_in: fast_gauss_ilrma(X_in, n_basis=N_BASIS, n_iter=N_ITER, rng=np.random.default_rng(0))[0],
         ("weighted_covariance", "ip1_sweep")),
    ):
        y = drive(label, entry, uses, totals)
        y_ref = istft(spectrogram_path(stft(wave, n_fft=N_FFT, hop_length=HOP, device=device)), n_fft=N_FFT,
                      hop_length=HOP, length=wave.shape[-1], device=device)
        rel = relative_error(y, y_ref)
        say("path vs spectrogram path", path=repr(label), shape=tuple(y.shape), device=y.device, rel_err=rel, tol=WAVE_TOL)
        check(all_finite(y) and tuple(y.shape) == tuple(wave.shape) and y.is_cuda and rel <= WAVE_TOL,
              f"{label}: {rel} from the spectrogram path")

    # ---- 5k. IP2, ISS2, FastIVA, FasterIVA, gradient IVA, FastGaussMNMF-IP2, time-domain ICA ------------------
    laps("5k")
    # Each class runs with its fast path's floor and without scale restoration, and must equal the fast path to
    # the bit; each fast path that runs a kernel is held against its plain twin; those that run none are held to
    # their easy-tier pin and print their loss against their complex128 run on the card
    with open(os.path.join(REPO, "tests", "fidelity_pins.json")) as f:
        pins = json.load(f)
    easy_images, _ = sample_speech_mixture(n_sources=2, max_duration=2.0, conv=True, seed=0)
    easy_mix = easy_images.sum(axis=0)
    X_easy = stft(easy_mix, n_fft=EASY_N_FFT, hop_length=EASY_HOP, device=device)  # complex128
    X_c128 = X.to(torch.complex128)
    check(tuple(X_easy.shape) == (2, 129, 251), f"easy-tier STFT {tuple(X_easy.shape)}")

    def hold_pin(label, key, Y):
        y = istft(Y.to(torch.complex128), n_fft=EASY_N_FFT, hop_length=EASY_HOP, length=easy_mix.shape[-1], device=device)
        got = best_permutation_si_sdr(y.cpu().numpy(), easy_images[:, 0])
        say("pin", path=repr(label), shape=tuple(X_easy.shape), si_sdr_db=got, pin=repr(key), pin_db=pins[key],
            tol_db=EASY_PIN_TOL_DB)
        check(all_finite(Y) and abs(got - pins[key]) <= EASY_PIN_TOL_DB, f"{label}: {got:.5f} dB against {pins[key]}")

    def hold_equal(label, Y_class, Y_fast):
        same = bool(torch.equal(Y_class, Y_fast))
        say("path vs fast path", path=repr(label), equal=same, max_abs_diff=float((Y_class - Y_fast).abs().max()))
        check(same, f"{label}: the class differs from its fast path")

    def say_complex128(label, loss, loss_c128):
        say("path vs complex128", path=repr(label), loss=loss, complex128_loss=loss_c128,
            loss_rel_diff=abs(loss - loss_c128) / abs(loss_c128))

    def tf32_rel_l2(label, run, Y):
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            Y_tf32 = run()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        rel = float(torch.linalg.vector_norm(Y_tf32 - Y) / torch.linalg.vector_norm(Y))
        say("precision", path=repr(label), tf32_vs_full_f32_rel_l2=rel, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    def iva_loss_start():
        return float(iva_laplace_loss(X, W_eye))

    # AuxIVA-IP2 and AuxIVA-ISS2
    def auxiva_pairwise(algorithm, X_in=X):
        method = AuxLaplaceIVA(spatial_algorithm=algorithm, flooring_fn="f64", scale_restoration=False)
        return method, method(X_in, n_iter=N_ITER), fast_auxiva(X_in, n_iter=N_ITER, algorithm=algorithm,
                                                                 scale_restoration=False)

    method, Y_class, (Y_fast, W_fast) = drive("AuxIVA-IP2", lambda: auxiva_pairwise("IP2"),
                                              {"weighted_covariance": 2 * M * N_ITER}, totals, exact=True)
    hold_equal("AuxLaplaceIVA(IP2)", Y_class, Y_fast)
    Y_plain, W_plain = run_plain(lambda: fast_auxiva(X, n_iter=N_ITER, algorithm="IP2", scale_restoration=False))
    def auxiva_ip2_perturbed():
        Y_perturbed, W_perturbed = run_plain(lambda: fast_auxiva(X_perturbed, n_iter=N_ITER, algorithm="IP2",
                                                                 scale_restoration=False))
        return Y_perturbed, float(iva_laplace_loss(X, W_perturbed))

    hold_sensitive("fast_auxiva(IP2)", Y_fast, Y_plain, auxiva_ip2_perturbed, float(iva_laplace_loss(X, W_fast)),
                   float(iva_laplace_loss(X, W_plain)), loss_first=iva_loss_start())
    check(method.loss[-1] < method.loss[0], "AuxLaplaceIVA(IP2): loss did not decrease")
    tf32_rel_l2("fast_auxiva(IP2), 100 iterations",
                lambda: fast_auxiva(X, n_iter=N_ITER, algorithm="IP2", scale_restoration=False)[0], Y_fast)
    hold_pin("fast_auxiva(IP2), easy tier", "auxiva_IP2", fast_auxiva(X_easy, n_iter=EASY_ITER, algorithm="IP2")[0])

    method, Y_class, (Y_fast, _) = drive("AuxIVA-ISS2", lambda: auxiva_pairwise("ISS2"), {}, totals, exact=True)
    hold_equal("AuxLaplaceIVA(ISS2)", Y_class, Y_fast)
    check(all_finite(Y_fast) and method.loss[-1] < method.loss[0], "AuxLaplaceIVA(ISS2): non-finite or no descent")
    hold_pin("fast_auxiva(ISS2), easy tier", "auxiva_ISS2", fast_auxiva(X_easy, n_iter=EASY_ITER, algorithm="ISS2")[0])
    method_c128 = auxiva_pairwise("ISS2", X_c128)[0]
    say_complex128("AuxLaplaceIVA(ISS2)", method.loss[-1], method_c128.loss[-1])

    # GaussILRMA-IP2 and GaussILRMA-ISS2 (n_basis = 8): the class as a user calls it, the fast path without scale
    # restoration, whose loss (the model's own state) is compared
    def ilrma_pairwise(spatial, X_in=X):
        method = GaussILRMA(n_basis=N_BASIS, spatial_algorithm=spatial, rng=np.random.default_rng(0))
        Y_class = method(X_in, n_iter=N_ITER)
        return method, Y_class, fast_gauss_ilrma(X_in, n_basis=N_BASIS, n_iter=N_ITER, algorithm=spatial,
                                                 scale_restoration=False, rng=np.random.default_rng(0))

    for spatial, uses in (("IP2", {"weighted_covariance": 2 * N_ITER}), ("ISS2", {})):
        label = f"GaussILRMA-{spatial}"
        method, Y_class, fast = drive(label, lambda: ilrma_pairwise(spatial), uses, totals, exact=True)
        check(all_finite(Y_class, fast[0], *fast[1]), f"{label}: non-finite output")
        check(method.loss[-1] < method.loss[0], f"{label}: class loss did not decrease")
        if uses:
            plain_method, Y_class_plain, fast_plain = run_plain(lambda: ilrma_pairwise(spatial))
            control = functools.lru_cache(lambda: run_plain(lambda: ilrma_pairwise(spatial, X_perturbed)))
            anchor = ("GaussILRMA-IP1 class", ilrma_ip1_loss)
            hold_sensitive(f"{label} class", Y_class, Y_class_plain, lambda: (control()[1], control()[0].loss[-1]),
                           method.loss[-1], plain_method.loss[-1], loss_first=method.loss[0], anchor=anchor,
                           first_divergent_iteration=first_divergence(method.loss, plain_method.loss, LOSS_TOL))
            hold_sensitive(f"{label} fast", fast[0], fast_plain[0],
                           lambda: (control()[2][0], fast_ilrma_loss(control()[2])), fast_ilrma_loss(fast),
                           fast_ilrma_loss(fast_plain), loss_first=ilrma_loss_start, anchor=anchor)
        else:
            method_c128 = GaussILRMA(n_basis=N_BASIS, spatial_algorithm=spatial, rng=np.random.default_rng(0))
            method_c128(X_c128, n_iter=N_ITER)
            say_complex128(f"GaussILRMA({spatial})", method.loss[-1], method_c128.loss[-1])
        rng_pin = np.random.default_rng(11)  # tests/test_fast_fidelity.py:133-135
        draws = FixedRng(rng_pin.random((2, X_easy.shape[1], 2)), rng_pin.random((2, 2, X_easy.shape[2])))
        hold_pin(f"fast_gauss_ilrma({spatial}), easy tier", f"gauss_ilrma_{spatial}",
                 fast_gauss_ilrma(X_easy, n_basis=2, n_iter=EASY_ITER, algorithm=spatial, rng=draws)[0])

    # FastIVA and FasterIVA: per run K7 once for the whitening, then FastIVA K7 once a step (the polar factor)
    # and FasterIVA K1 once and K7 twice (the top eigenvectors, the polar factor)
    def laplace_contrast(y):
        return 2 * torch.linalg.vector_norm(y, dim=1)

    def laplace_d_contrast(y):
        return 2 * torch.ones_like(y)

    def fixed_point(variant):
        if variant == "FastIVA":
            method = FastIVA(contrast_fn=laplace_contrast, d_contrast_fn=laplace_d_contrast,
                             dd_contrast_fn=lambda y: torch.zeros_like(y), flooring_fn="f64", scale_restoration=False)
            fast = fast_fast_iva
        else:
            method = FasterIVA(contrast_fn=laplace_contrast, d_contrast_fn=laplace_d_contrast, flooring_fn="f64",
                               scale_restoration=False)
            fast = fast_faster_iva
        return method, method(X, n_iter=N_ITER), fast(X, n_iter=N_ITER, scale_restoration=False)

    def whitened_loss(Y):
        return float(laplace_contrast(Y).mean(dim=-1).sum())

    for variant, uses, fast in (
        ("FastIVA", {"jacobi_eigh": 2 * (N_ITER + 1)}, fast_fast_iva),
        ("FasterIVA", {"weighted_covariance": 2 * N_ITER, "jacobi_eigh": 2 * (2 * N_ITER + 1)}, fast_faster_iva),
    ):
        batches.clear()
        with recording_jacobi(batches):
            method, Y_class, Y_fast = drive(variant, functools.partial(fixed_point, variant), uses, totals, exact=True)
        expected = {I, M * I} if variant == "FasterIVA" else {I}
        check(set(batches) == expected, f"{variant}: K7 batches {sorted(set(batches))}, expected {sorted(expected)}")
        hold_equal(variant, Y_class, Y_fast)
        start = time.perf_counter()
        Y_plain = run_plain(lambda: fast(X, n_iter=N_ITER, scale_restoration=False))
        plain_seconds = f"{time.perf_counter() - start:.3f}"

        def fixed_point_perturbed():
            Y_perturbed = run_plain(lambda: fast(X_perturbed, n_iter=N_ITER, scale_restoration=False))
            return Y_perturbed, whitened_loss(Y_perturbed)

        hold_sensitive(f"{variant} fast", Y_fast, Y_plain, fixed_point_perturbed, whitened_loss(Y_fast),
                       whitened_loss(Y_plain), loss_first=whitened_loss(Z_main), plain_seconds=plain_seconds)
        if variant == "FasterIVA":
            tf32_rel_l2("fast_faster_iva, 100 iterations", lambda: fast(X, n_iter=N_ITER, scale_restoration=False),
                        Y_fast)
        key = "fixed_point_iva_fast" if variant == "FastIVA" else "fixed_point_iva_faster"
        hold_pin(f"{fast.__name__}, easy tier", key, fast(X_easy, n_iter=EASY_ITER))

    # GradIVA and NaturalGradIVA (Laplace, holonomic): no kernel
    for natural, cls in ((False, GradLaplaceIVA), (True, NaturalGradLaplaceIVA)):
        label = cls.__name__

        def grad_paths(X_in=X):
            method = cls(flooring_fn="f64", scale_restoration=False)
            return method, method(X_in, n_iter=N_ITER), fast_grad_iva(X_in, n_iter=N_ITER, natural=natural,
                                                                       scale_restoration=False)

        method, Y_class, (Y_fast, W_fast) = drive(label, grad_paths, {}, totals, exact=True)
        hold_equal(label, Y_class, Y_fast)
        check(all_finite(Y_fast) and method.loss[-1] < method.loss[0], f"{label}: non-finite or no descent")
        hold_pin(f"fast_grad_iva(natural={natural}), easy tier", f"grad_iva_natural={natural}",
                 fast_grad_iva(X_easy, n_iter=EASY_GRAD_ITER, natural=natural)[0])
        say_complex128(label, method.loss[-1], grad_paths(X_c128)[0].loss[-1])

    # FastGaussMNMF with the IP2 diagonalizer (4 channels): K1 once an iteration, M4 pair updates, no K1b
    def fast_mnmf_ip2():
        method = FastGaussMNMF(n_basis=FAST_MNMF_BASIS, diagonalizer_algorithm="IP2", rng=np.random.default_rng(0))
        Y_class = method(X4, n_iter=N_ITER)
        return method, Y_class, fast_gauss_mnmf(X4, n_basis=FAST_MNMF_BASIS, n_iter=N_ITER, diagonalizer_algorithm="IP2",
                                                rng=np.random.default_rng(0))

    label = f"FastGaussMNMF-IP2 ({M4} ch)"
    method, Y_class, (Y_fast, factors) = drive(label, fast_mnmf_ip2, {"weighted_covariance": 2 * N_ITER}, totals,
                                               exact=True)
    hold_equal(label, Y_class, Y_fast)

    def fast_mnmf_ip2_plain(X_in):
        return fast_gauss_mnmf(X_in, n_basis=FAST_MNMF_BASIS, n_iter=N_ITER, diagonalizer_algorithm="IP2",
                               rng=np.random.default_rng(0))

    def fast_mnmf_ip2_perturbed():
        Y_perturbed, factors_perturbed = run_plain(lambda: fast_mnmf_ip2_plain(X_perturbed[:M4].contiguous()))
        return Y_perturbed, fast_mnmf_loss_of(factors_perturbed)

    Y_plain, factors_plain = run_plain(lambda: fast_mnmf_ip2_plain(X4))
    hold_sensitive(f"fast_gauss_mnmf(IP2) ({M4} ch)", Y_fast, Y_plain, fast_mnmf_ip2_perturbed,
                   fast_mnmf_loss_of(factors), fast_mnmf_loss_of(factors_plain), loss_first=method.loss[0])
    check(method.loss[-1] < method.loss[0], f"{label}: class loss did not decrease")

    # time-domain ICA: NaturalGradLaplaceICA on bench.py:370's configuration, and its fixture in float64
    wave_ica = wave[:ICA_CHANNELS].contiguous()
    ica = NaturalGradLaplaceICA()
    y_ica = drive("NaturalGradLaplaceICA (2 ch)", lambda: ica(wave_ica, n_iter=N_ITER), {}, totals, exact=True)
    ica_f64 = NaturalGradLaplaceICA()
    ica_f64(wave_ica.double(), n_iter=N_ITER)
    check(all_finite(y_ica) and tuple(y_ica.shape) == tuple(wave_ica.shape) and ica.loss[-1] < ica.loss[0],
          "NaturalGradLaplaceICA: non-finite output or no descent")
    say_complex128("NaturalGradLaplaceICA (float32 against float64)", ica.loss[-1], ica_f64.loss[-1])
    fixtures = os.path.join(REPO, "tests", "regression", "fixtures")
    waveform = np.load(os.path.join(fixtures, "input_time.npz"))["waveform"]
    target = np.load(os.path.join(fixtures, "natural_grad_laplace_ica.npz"))["target"]
    y_fixture = NaturalGradLaplaceICA(step_size=0.05)(waveform, n_iter=20)
    fixture_err = float(np.abs(y_fixture.cpu().numpy() - target).max())
    say("fixture", path=repr("NaturalGradLaplaceICA, natural_grad_laplace_ica.npz (float64)"), max_abs_err=fixture_err,
        tol=ICA_FIXTURE_TOL, device=y_fixture.device)
    check(y_fixture.is_cuda and fixture_err <= ICA_FIXTURE_TOL, f"ICA fixture: {fixture_err}")

    # ---- 5l. FDICA: AuxLaplaceFDICA IP1 and IP2, the gradient classes, the hard tier ---------------------------------
    laps("5l")
    # Each class runs as a user calls it (aligned across bins, projected back; AuxFDICA at the fast path's float32
    # floor, the gradient classes at its 1e-10) and its last iterate must equal the fast path's to the bit; the fast
    # paths run as a user calls them and once unaligned and unscaled. That run is held against its plain twin after
    # N_ITER_FDICA_HOLD iterations (hold_sensitive); after 100 its loss gap to the plain twin is held to
    # FDICA_CONTROL_MULTIPLE times a one-ulp control's, and IP2 ends no higher than IP1 from the same start (ANCHOR_TOL). The easy tier's pins hold each fast path as
    # tests/test_fast_fidelity.py runs it
    raw = dict(permutation_alignment=False, scale_restoration=False)

    def fdica_loss(W_):
        return float(fdica_steps.fdica_laplace_loss(X, W_))

    fdica_loss_start = fdica_loss(W_eye)

    def hold_last_iterate(label, method, W_raw):
        same = bool(torch.equal(method._state["W"], W_raw))
        say("path vs fast path", path=repr(label), last_iterate_equal=same,
            max_abs_diff=float((method._state["W"] - W_raw).abs().max()))
        check(same, f"{label}: the class's last iterate differs from its fast path's")

    def aligners(label, Y_raw, W_raw, flooring_fn):
        """Alignment at 8 sources on the card: the fast path's (float64 amplitudes) timed alone, and the bins where the
        class's (the input's precision) takes another permutation."""
        torch.cuda.synchronize()
        start = time.perf_counter()
        Y_fast_aligned, _ = permutation_align(Y_raw.transpose(0, 1), W_raw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - start
        Y_class_aligned = correlation_based_permutation_solver(Y_raw.transpose(0, 1), flooring_fn=flooring_fn)
        differ = int((Y_fast_aligned != Y_class_aligned).flatten(1).any(dim=1).sum())
        say("alignment", path=repr(label), sources=Y_raw.shape[0], bins=Y_raw.shape[1], seconds=f"{seconds:.3f}",
            bins_the_two_aligners_permute_otherwise=differ)

    for algorithm, uses in (("IP1", {"weighted_covariance": 3 * N_ITER, "ip1_sweep": 3 * N_ITER}),
                            ("IP2", {"weighted_covariance": 3 * M * N_ITER})):
        label = f"AuxFDICA-{algorithm}"

        def aux_fdica(algorithm=algorithm):
            method = AuxLaplaceFDICA(spatial_algorithm=algorithm)
            Y_class = method(X, n_iter=N_ITER)
            return (method, Y_class, fast_aux_fdica(X, n_iter=N_ITER, algorithm=algorithm),
                    fast_aux_fdica(X, n_iter=N_ITER, algorithm=algorithm, **raw))

        method, Y_class, (Y_user, W_user), (Y_raw, W_raw) = drive(label, aux_fdica, uses, totals, exact=True)
        hold_last_iterate(f"AuxLaplaceFDICA({algorithm})", method, W_raw)
        check(all_finite(Y_class, Y_user, W_user) and tuple(Y_user.shape) == (M, I, T), f"{label}: non-finite output")
        check(method.loss[-1] < method.loss[0], f"{label}: class loss did not decrease")

        def fdica_raw(X_in, n_iter, algorithm=algorithm):
            return fast_aux_fdica(X_in, n_iter=n_iter, algorithm=algorithm, **raw)

        def fdica_perturbed(n_iter, algorithm=algorithm):
            Y_p, W_p = run_plain(lambda: fdica_raw(X_perturbed, n_iter))
            return Y_p, fdica_loss(W_p)

        Y_short, W_short = fdica_raw(X, N_ITER_FDICA_HOLD)
        Y_short_plain, W_short_plain = run_plain(lambda: fdica_raw(X, N_ITER_FDICA_HOLD))
        hold_sensitive(f"fast_aux_fdica({algorithm}), {N_ITER_FDICA_HOLD} iterations", Y_short, Y_short_plain,
                       lambda: fdica_perturbed(N_ITER_FDICA_HOLD), fdica_loss(W_short), fdica_loss(W_short_plain),
                       loss_first=fdica_loss_start)
        start = time.perf_counter()
        Y_plain, W_plain = run_plain(lambda: fdica_raw(X, N_ITER))
        plain_seconds = f"{time.perf_counter() - start:.3f}"
        Y_control, loss_control = fdica_perturbed(N_ITER)
        loss_raw, loss_plain = fdica_loss(W_raw), fdica_loss(W_plain)
        gap_raw, gap_control = abs(loss_raw - loss_plain) / abs(loss_plain), abs(loss_control - loss_plain) / abs(loss_plain)
        say("path vs plain", path=repr(f"fast_aux_fdica({algorithm}), {N_ITER} iterations"), loss=loss_raw,
            plain_loss=loss_plain, loss_rel_diff=gap_raw, min_si_sdr_db=min_si_sdr(Y_raw, Y_plain),
            perturbed_input_loss=loss_control, perturbed_input_loss_rel_diff=gap_control,
            perturbed_input_min_si_sdr_db=min_si_sdr(Y_control, Y_plain), input_perturbation=IPA_PERTURBATION,
            gate=repr(f"loss gap <= {FDICA_CONTROL_MULTIPLE} x the control's"), plain_seconds=plain_seconds)
        check(all_finite(Y_raw) and loss_raw < fdica_loss_start, f"{label}: non-finite or no descent")
        check(gap_raw <= FDICA_CONTROL_MULTIPLE * gap_control,
              f"{label}, {N_ITER} iterations: loss gap {gap_raw} to the plain twin against the control's {gap_control}")
        if algorithm == "IP1":
            fdica_ip1_loss = loss_raw
        else:
            say("path vs anchor", path=repr(label), loss=loss_raw, anchor=repr("AuxFDICA-IP1"), anchor_loss=fdica_ip1_loss,
                loss_rel_diff_to_anchor=(loss_raw - fdica_ip1_loss) / abs(fdica_ip1_loss), tol=ANCHOR_TOL)
            check(loss_raw <= fdica_ip1_loss + ANCHOR_TOL * abs(fdica_ip1_loss),
                  f"{label}: loss {loss_raw} above AuxFDICA-IP1's {fdica_ip1_loss}")
        aligners(label, Y_raw, W_raw, method.flooring_fn)
        tf32_rel_l2(f"fast_aux_fdica({algorithm}), 100 iterations",
                    lambda: fast_aux_fdica(X, n_iter=N_ITER, algorithm=algorithm, **raw)[0], Y_raw)
        hold_pin(f"fast_aux_fdica({algorithm}), easy tier", f"aux_fdica_{algorithm}",
                 fast_aux_fdica(X_easy, n_iter=EASY_ITER, algorithm=algorithm)[0])

    # GradLaplaceFDICA and NaturalGradLaplaceFDICA: no kernel. The non-holonomic step leaves the scale free, so its
    # loss need not fall (on this mixture the gradient one climbs); the holonomic runs' must
    for natural, cls in ((False, GradLaplaceFDICA), (True, NaturalGradLaplaceFDICA)):
        label = cls.__name__

        def grad_fdica(X_in=X, natural=natural, cls=cls):
            method = cls(flooring_fn="f64")
            Y_class = method(X_in, n_iter=N_ITER)
            return (method, Y_class, fast_grad_fdica(X_in, n_iter=N_ITER, natural=natural, **raw),
                    fast_grad_fdica(X_in, n_iter=N_ITER, natural=natural, is_holonomic=True, **raw))

        method, Y_class, (Y_raw, W_raw), (Y_hol, W_hol) = drive(label, grad_fdica, {}, totals, exact=True)
        hold_last_iterate(label, method, W_raw)
        say("path", path=repr(label), loss_first=method.loss[0], loss_last=method.loss[-1],
            holonomic_loss_last=fdica_loss(W_hol))
        check(all_finite(Y_class, Y_raw, Y_hol) and fdica_loss(W_hol) < fdica_loss_start,
              f"{label}: non-finite output, or the holonomic loss did not fall")
        tf32_rel_l2(f"fast_grad_fdica(natural={natural}), 100 iterations",
                    lambda: fast_grad_fdica(X, n_iter=N_ITER, natural=natural, **raw)[0], Y_raw)
        hold_pin(f"fast_grad_fdica(natural={natural}), easy tier", f"grad_fdica_natural={natural}",
                 fast_grad_fdica(X_easy, n_iter=EASY_GRAD_ITER, natural=natural)[0])
        method_c128 = cls(flooring_fn="f64", **raw)
        method_c128(X_c128, n_iter=N_ITER)
        say_complex128(label, method.loss[-1], method_c128.loss[-1])

    # the hard tier: 4 channels at STFT 4096/1024, IP1 aligned and projected back, 50 iterations
    Y_hard, _ = drive("fast_aux_fdica(IP1), hard tier", lambda: fast_aux_fdica(X_wide, n_iter=HARD_FDICA_ITER),
                      {"weighted_covariance": HARD_FDICA_ITER, "ip1_sweep": HARD_FDICA_ITER}, totals, exact=True)
    hard_db = quality(Y_hard)
    say("path", path=repr("fast_aux_fdica(IP1), hard tier"), shape=tuple(X_wide.shape), si_sdr_db=hard_db,
        pin_db=HARD_FDICA_PIN_DB, tol_db=HARD_FDICA_TOL_DB)
    check(all_finite(Y_hard) and abs(hard_db - HARD_FDICA_PIN_DB) <= HARD_FDICA_TOL_DB,
          f"fast_aux_fdica hard tier: {hard_db:.5f} dB against the pin {HARD_FDICA_PIN_DB}")

    # ---- 5m. the eigendecomposition-free routes, each against its eigh route from the same input ---------------------
    laps("5m")
    # IPA's secular root (secular_impl="solve", 12 trips): one sweep's pencils on the main mixture, against the true
    # root on K7's spectrum (bisected in float64); the eigh route's own Newton keeps the reference's normalization and
    # solves another equation (tests/ops/test_splitc_ipa.py:192-201), so its root is printed, not compared
    pencils = []
    with recording(ipa_steps, "lqpqm2", lambda H_, v_, z_, **kw: pencils.append((H_, v_, z_))):
        auxiva_ipa_step(X)
    H_p, v_p, z_p = (torch.cat(parts) for parts in zip(*pencils))
    check(len(pencils) == M and tuple(H_p.shape) == (M * I, M - 1, M - 1), f"IPA pencils {tuple(H_p.shape)}")
    root_solve, _ = eig_free.secular_root_solve(H_p, v_p, z_p, trips=12)
    phi, vsq, _ = ipa_steps._pencil_spectrum(H_p, v_p)
    phi, vsq, z64 = phi.double(), vsq.double(), z_p.double()
    lo, hi = phi[..., -1], torch.maximum(2 * phi[..., -1], z64 + 4 * torch.sum(phi * vsq, dim=-1))
    for _ in range(200):
        mid = (lo + hi) / 2
        f = mid * mid * torch.sum(phi * vsq / (mid[..., None] - phi) ** 2, dim=-1) - mid + z64
        lo, hi = torch.where(f > 0, mid, lo), torch.where(f > 0, hi, mid)
    live = (torch.linalg.vector_norm(v_p, dim=-1) >= FAST_EPS) & (phi[..., -1] > 0)
    rel = ((root_solve.double() - lo).abs() / lo)[live]
    say("free route", route=repr("IPA secular root, secular_impl='solve'"), pencils=tuple(H_p.shape), trips=12,
        live=int(live.sum()), worst_rel_err_vs_root_on_k7_spectrum=float(rel.max()), median_rel_err=float(rel.median()),
        tol=SECULAR_ROOT_TOL, root_over_phi_max_min=float((lo / phi[..., -1])[live].min()))
    check(bool(torch.isfinite(root_solve).all()) and float(rel.max()) <= SECULAR_ROOT_TOL,
          f"IPA secular root: {float(rel.max())} from the root on K7's spectrum")

    def ipa_chain(secular_impl):
        Y_ = X
        for _ in range(N_ITER_IPA_CLASSES):
            Y_ = auxiva_ipa_step(Y_, secular_impl=secular_impl)
        return Y_

    Y_solve = drive("AuxIVA-IPA, secular_impl='solve'", lambda: ipa_chain("solve"),
                    {"weighted_covariance": N_ITER_IPA_CLASSES, "ipa_congruence": M * N_ITER_IPA_CLASSES}, totals,
                    exact=True)
    Y_eigh = drive("AuxIVA-IPA, secular_impl='eigh'", lambda: ipa_chain("eigh"),
                   {"weighted_covariance": N_ITER_IPA_CLASSES, "ipa_congruence": M * N_ITER_IPA_CLASSES,
                    "jacobi_eigh": M * N_ITER_IPA_CLASSES}, totals, exact=True)
    loss_solve, loss_eigh = float(iva_laplace_loss(X, Y=Y_solve)), float(iva_laplace_loss(X, Y=Y_eigh))
    ipa_start = float(iva_laplace_loss(X, Y=X))
    say("free route", route=repr("AuxIVA-IPA, secular_impl='solve'"), iterations=N_ITER_IPA_CLASSES,
        loss_first=ipa_start, loss=loss_solve, eigh_route_loss=loss_eigh,
        loss_rel_diff=(loss_solve - loss_eigh) / abs(loss_eigh), tol=ANCHOR_TOL,
        min_si_sdr_db_vs_eigh_route=min_si_sdr(Y_solve, Y_eigh))
    check(all_finite(Y_solve) and loss_solve < ipa_start and abs(loss_solve - loss_eigh) <= ANCHOR_TOL * abs(loss_eigh),
          f"AuxIVA-IPA solve: loss {loss_solve} against the eigh route's {loss_eigh}")

    # the QDWH polar factor on FastIVA's input (its first step from W = I on the whitened mixture)
    polar_inputs = []
    with recording(fixed_point_iva_steps, "polar", lambda W_in, **kw: polar_inputs.append(W_in)):
        fixed_point_iva_steps.fast_iva_step(Z_main, W_eye)
    (A_polar_in,) = polar_inputs
    P_qdwh = fixed_point_iva_steps.polar(A_polar_in, impl="qdwh")
    P_eigh = fixed_point_iva_steps.polar(A_polar_in)
    P_c128 = fixed_point_iva_steps.polar(A_polar_in.to(torch.complex128)).to(torch.complex64)
    eye_M = torch.eye(M, device=device)
    unitary = float((P_qdwh.mH @ P_qdwh - eye_M).abs().max())
    rel = relative_error(P_qdwh, P_eigh)
    say("free route", route=repr("FastIVA polar, impl='qdwh'"), shape=tuple(A_polar_in.shape), unitary_err=unitary,
        unitary_tol=QDWH_UNITARY_TOL, rel_err_vs_eigh=rel, tol=QDWH_POLAR_TOL,
        eigh_unitary_err=float((P_eigh.mH @ P_eigh - eye_M).abs().max()),
        qdwh_rel_err_vs_complex128=relative_error(P_qdwh, P_c128), eigh_rel_err_vs_complex128=relative_error(P_eigh, P_c128),
        schedule_trips=len(eig_free.qdwh_schedule()))
    check(unitary <= QDWH_UNITARY_TOL and rel <= QDWH_POLAR_TOL, f"QDWH polar: unitary {unitary}, {rel} from eigh")

    # FasterIVA's top eigenvectors by shift-invert (its first step's per-source covariances)
    top_inputs = []
    with recording(fixed_point_iva_steps, "top_eigvec", lambda U_in, **kw: top_inputs.append(U_in)):
        fixed_point_iva_steps.faster_iva_step(Z_main, W_eye)
    (U_top,) = top_inputs
    lamb_top = prox_steps.herm_eigh_embed(U_top)[0][..., -1]

    def rayleigh_rel(v_):
        quotient = torch.sum(v_.conj() * (U_top @ v_[..., None])[..., 0], dim=-1).real
        return float(((quotient - lamb_top).abs() / lamb_top.abs().clamp(min=1e-30)).max())

    top_rel = rayleigh_rel(eig_free.top_eigvec_shift_invert(U_top))
    # the bisection's certificate, the least pivot of chol_piv (whose factor the inverse iteration then uses),
    # against torch.linalg.cholesky_ex: the shifts (1 + d) lamb_max where the two disagree, and each one's time
    E_top = prox_steps._symmetrised(prox_steps.block_embed(U_top))
    eye_2M = torch.eye(2 * M, device=device)

    def shifted(d):
        return (lamb_top * (1 + d))[..., None, None] * eye_2M - E_top

    disagree = {d: int((((torch.linalg.cholesky_ex(shifted(d))[1] == 0) != (eig_free.chol_piv(shifted(d))[1] > 0))).sum())
                for d in (1e-4, 1e-6, 1e-7, 0.0, -1e-7)}
    certificate_ms = {"cholesky_ex": median_ms(lambda: torch.linalg.cholesky_ex(shifted(0.5))[1] == 0, queued=False),
                      "chol_piv": median_ms(lambda: eig_free.chol_piv(shifted(0.5))[1] > 0, queued=False)}
    say("free route", route=repr("FasterIVA top eigenvectors, eig_impl='solve'"), shape=tuple(U_top.shape),
        rayleigh_rel_err_vs_k7=top_rel, tol=TOP_EIGVEC_TOL, certificate_disagreements_by_shift=repr(disagree),
        certificate_call_ms_cholesky_ex=certificate_ms["cholesky_ex"],
        certificate_call_ms_chol_piv=certificate_ms["chol_piv"], card=repr(card))
    check(top_rel <= TOP_EIGVEC_TOL, f"shift-invert top eigenvectors: {top_rel} from K7")

    # both fixed-point routes over 100 chained steps, with their launches (no K7: FasterIVA's shift-invert route takes
    # the QDWH polar), each held to its eigh route's loss within ANCHOR_TOL
    for label, step, uses in (
        ("FastIVA, polar_impl='qdwh'", lambda W_: fixed_point_iva_steps.fast_iva_step(Z_main, W_, polar_impl="qdwh"), {}),
        ("FasterIVA, eig_impl='solve'", lambda W_: fixed_point_iva_steps.faster_iva_step(Z_main, W_, eig_impl="solve"),
         {"weighted_covariance": N_ITER}),
    ):
        W_free = drive(label, lambda: chain(step, W_eye), uses, totals, exact=True)
        eigh_step = fixed_point_iva_steps.fast_iva_step if label.startswith("FastIVA") else fixed_point_iva_steps.faster_iva_step
        W_ref = chain(lambda W_: eigh_step(Z_main, W_), W_eye)
        Y_free, Y_ref = separate(Z_main, W_free), separate(Z_main, W_ref)
        loss_free, loss_ref = whitened_loss(Y_free), whitened_loss(Y_ref)
        singular = torch.linalg.svdvals(W_free) if all_finite(W_free) else torch.full((1,), float("nan"))
        say("free route", route=repr(label), iterations=N_ITER, loss=loss_free, eigh_route_loss=loss_ref,
            loss_rel_diff=(loss_free - loss_ref) / abs(loss_ref), tol=ANCHOR_TOL,
            min_si_sdr_db_vs_eigh_route=min_si_sdr(Y_free, Y_ref),
            singular_values_min_max=(float(singular.min()), float(singular.max())))
        check(all_finite(W_free) and abs(loss_free - loss_ref) <= ANCHOR_TOL * abs(loss_ref),
              f"{label}: loss {loss_free} against the eigh route's {loss_ref}")

    # ---- 5n. the (dp, bin) runners: fast_auxiva_batch and the other families at full width, then every runner ----
    laps("5n")
    parallel_start = time.perf_counter()
    # (a) two mixtures of the main configuration from two seeds, one process and no group
    wave_pair = torch.stack([wave, torch.from_numpy(make_mixture(seed=1)).to(device=device, dtype=torch.float32)])
    X_pair = torch.stack([X, stft(wave_pair[1], n_fft=N_FFT, hop_length=HOP, device=device)])
    Y_batch, W_batch = drive(
        "fast_auxiva_batch (B = 2)", lambda: fast_auxiva_batch(X_pair, n_iter=N_ITER),
        {"weighted_covariance": 2 * N_ITER, "ip1_sweep": N_ITER}, totals, exact=True,
    )
    check(all_finite(Y_batch, W_batch) and tuple(Y_batch.shape) == (2, M, I, T), "fast_auxiva_batch output")
    for b in range(2):
        Y_one, W_one = fast_auxiva(X_pair[b], n_iter=N_ITER, algorithm="IP1")
        loss_b, loss_one = float(iva_laplace_loss(X_pair[b], W_batch[b])), float(iva_laplace_loss(X_pair[b], W_one))
        rel, sdr = abs(loss_b - loss_one) / abs(loss_one), min_si_sdr(Y_batch[b], Y_one)
        say("parallel", path=repr(f"fast_auxiva_batch utterance {b} vs fast_auxiva"), loss=loss_b,
            fast_auxiva_loss=loss_one, loss_rel_diff=rel, min_si_sdr_db=sdr)
        check(rel <= LOSS_TOL and sdr >= MIN_SI_SDR_DB, f"fast_auxiva_batch utterance {b}: loss {rel}, {sdr:.2f} dB")

    def chained(X_in):
        W_in = torch.eye(M, dtype=X.dtype, device=device).expand(*X_in.shape[:-3], I, M, M).contiguous()

        def run():
            W_run = W_in
            for _ in range(N_PARALLEL_TIMED):
                W_run = auxiva_ip1_step(X_in, W_run)
            return W_run

        return run

    batch_ms = median_ms(chained(X_pair), queued=True, n_runs=10) / N_PARALLEL_TIMED
    single_ms = median_ms(chained(X), queued=True, n_runs=10) / N_PARALLEL_TIMED
    say("parallel", path=repr("AuxIVA-IP1 step, B = 2 against B = 1 (fast_auxiva)"), card=repr(card),
        device_us_per_iter_per_utterance=1e3 * batch_ms / 2, fast_auxiva_device_us_per_iter=1e3 * single_ms,
        chained_steps=N_PARALLEL_TIMED, runs=10, stat="median")

    # (b) the runners of the other families at world size 1 on the two mixtures, N_ITER_RUNNERS steps, each utterance
    # held against the single-utterance fast path (ICA: the class) on it: FastIVA and FasterIVA on each mixture
    # whitened, the prox family and HVA on each over its spectral norm, FastGaussMNMF on its first 4 channels with
    # fast_gauss_mnmf's draws from seed b, ICA on its first 2 channels; FasterIVA on its loss alone
    # (SENSITIVE_LOSS_TOL), the others on the loss (LOSS_TOL) and the worst SI-SDR
    start = time.perf_counter()
    one = make_layout(world_size=1, device=device)
    n_run = N_ITER_RUNNERS
    eye_pair = W_eye.expand(2, I, M, M).contiguous()
    filters_zero, spectra_zero = torch.zeros_like(eye_pair), torch.zeros_like(X_pair)
    Z_pair = torch.stack([fixed_point_iva_steps.whiten_spectrogram(x) for x in X_pair])
    X_prox_pair = torch.stack([PDSIVA().normalize_by_spectral_norm(x) for x in X_pair])
    quad_inv_pair = prox_steps.admm_quad_inv(X_prox_pair)
    X4_pair = X_pair[:, :FAST_MNMF_CHANNELS].contiguous()
    wave_ica_pair = wave_pair[:, :ICA_CHANNELS].contiguous()
    eye_ica = torch.eye(ICA_CHANNELS, device=device).expand(2, ICA_CHANNELS, ICA_CHANNELS).contiguous()

    def fast_mnmf_draws(seed):
        """fast_gauss_mnmf's T0, V0 and D0 from ``default_rng(seed)``, in its order."""
        draws, F = np.random.default_rng(seed), FAST_MNMF_CHANNELS
        T0 = draws.random((F, I, FAST_MNMF_BASIS))
        V0 = draws.random((F, FAST_MNMF_BASIS, T))
        D0 = np.maximum(draws.random((I, F, F)), 1e-10)
        return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (T0, V0, D0)]

    T0_pair, V0_pair, D0_pair = (torch.stack(z) for z in zip(*map(fast_mnmf_draws, range(2))))
    Q0_pair = torch.eye(FAST_MNMF_CHANNELS, dtype=X.dtype, device=device).expand(
        2, I, FAST_MNMF_CHANNELS, FAST_MNMF_CHANNELS).contiguous()
    fast_mnmf_carry = (Q0_pair, T0_pair, V0_pair, D0_pair)
    prox_carry = (eye_pair, spectra_zero)
    admm_carry = (eye_pair, filters_zero, spectra_zero, filters_zero, spectra_zero)

    def whitened_end(b, W_):
        Y_ = separate(Z_pair[b], W_)
        return Y_, whitened_loss(Y_)

    def prox_end(b, W_):
        return separate(X_prox_pair[b], W_), float(prox_steps.prox_iva_loss(X_prox_pair[b], W_))

    def fdica_end(b, W_):
        return separate(X_pair[b], W_), float(fdica_steps.fdica_laplace_loss(X_pair[b], W_))

    def ica_end(b, W_):
        y_ = W_ @ wave_ica_pair[b]
        return y_, float(torch.sum(torch.mean(torch.abs(y_), dim=1)) - torch.linalg.slogdet(W_)[1])

    def fast_mnmf_end(b, state):
        Q_, T_, V_, D_ = state
        return (fast_mnmf_steps.fast_mnmf_separate(X4_pair[b], T_, V_, Q_, D_),
                float(fast_mnmf_steps.fast_gauss_mnmf_loss(X4_pair[b], Q_, T_, V_, D_)))

    def fast_mnmf_one(b):
        Y_, (T_, V_, Q_, D_) = fast_gauss_mnmf(X4_pair[b], n_basis=FAST_MNMF_BASIS, n_iter=n_run,
                                               rng=np.random.default_rng(b))
        return Y_, float(fast_mnmf_steps.fast_gauss_mnmf_loss(X4_pair[b], Q_, T_, V_, D_))

    def ica_one(b):
        method = NaturalGradLaplaceICA()
        y_ = method(wave_ica_pair[b], n_iter=n_run)
        return y_, method.loss[-1]

    no_scale = dict(n_iter=n_run, scale_restoration=False)
    # name: (the runner's run at world size 1, an utterance's end (b, its output) -> (Y, loss), the fast path on
    # utterance b -> (Y, loss), the batched step with its state, the single-utterance step with its state)
    full_width = {
        "fast_iva": (
            lambda: make_batched_fast_iva_runner(one)(Z_pair, eye_pair, n_run), whitened_end,
            lambda b: (lambda Y_: (Y_, whitened_loss(Y_)))(fast_fast_iva(X_pair[b], **no_scale)),
            (lambda W_: fixed_point_iva_steps.fast_iva_step(Z_pair, W_), eye_pair),
            (lambda W_: fixed_point_iva_steps.fast_iva_step(Z_pair[0], W_), W_eye)),
        "faster_iva": (
            lambda: make_batched_faster_iva_runner(one)(Z_pair, eye_pair, n_run), whitened_end,
            lambda b: (lambda Y_: (Y_, whitened_loss(Y_)))(fast_faster_iva(X_pair[b], **no_scale)),
            (lambda W_: fixed_point_iva_steps.faster_iva_step(Z_pair, W_), eye_pair),
            (lambda W_: fixed_point_iva_steps.faster_iva_step(Z_pair[0], W_), W_eye)),
        "fdica_ip1": (
            lambda: make_batched_fdica_runner(one)(X_pair, eye_pair, n_run), fdica_end,
            lambda b: fdica_end(b, fast_aux_fdica(X_pair[b], permutation_alignment=False, **no_scale)[1]),
            (lambda W_: fdica_steps.aux_laplace_fdica_ip1_step(X_pair, W_), eye_pair),
            (lambda W_: fdica_steps.aux_laplace_fdica_ip1_step(X, W_), W_eye)),
        "fdica_ip2": (
            lambda: make_batched_fdica_runner(one, spatial_algorithm="IP2")(X_pair, eye_pair, n_run), fdica_end,
            lambda b: fdica_end(b, fast_aux_fdica(X_pair[b], algorithm="IP2", permutation_alignment=False,
                                                  **no_scale)[1]),
            (lambda W_: fdica_steps.aux_laplace_fdica_ip2_step(X_pair, W_), eye_pair),
            (lambda W_: fdica_steps.aux_laplace_fdica_ip2_step(X, W_), W_eye)),
        "grad_iva": (
            lambda: make_batched_grad_iva_runner(one)(X_pair, eye_pair, n_run),
            lambda b, W_: (separate(X_pair[b], W_), float(iva_laplace_loss(X_pair[b], W_))),
            lambda b: (lambda Y_, W_: (Y_, float(iva_laplace_loss(X_pair[b], W_))))(
                *fast_grad_iva(X_pair[b], **no_scale)),
            (lambda W_: grad_laplace_iva_step(X_pair, W_), eye_pair),
            (lambda W_: grad_laplace_iva_step(X, W_), W_eye)),
        "grad_fdica": (
            lambda: make_batched_grad_fdica_runner(one)(X_pair, eye_pair, n_run), fdica_end,
            lambda b: fdica_end(b, fast_grad_fdica(X_pair[b], is_holonomic=True, permutation_alignment=False,
                                                   **no_scale)[1]),
            (lambda W_: fdica_steps.grad_laplace_fdica_step(X_pair, W_), eye_pair),
            (lambda W_: fdica_steps.grad_laplace_fdica_step(X, W_), W_eye)),
        "fast_mnmf": (
            lambda: make_batched_fast_mnmf_runner(one)(X4_pair, fast_mnmf_carry, n_run), fast_mnmf_end, fast_mnmf_one,
            (lambda c: fast_mnmf_steps.fast_gauss_mnmf_step(X4_pair, *c), fast_mnmf_carry),
            (lambda c: fast_mnmf_steps.fast_gauss_mnmf_step(X4_pair[0], *c), tuple(a[0] for a in fast_mnmf_carry))),
        "pds_iva": (
            lambda: make_batched_pds_iva_runner(one)(X_prox_pair, prox_carry, n_run)[0], prox_end,
            lambda b: prox_end(b, fast_pds_iva(X_prox_pair[b], **no_scale)[1]),
            (lambda c: prox_steps.pds_iva_step(X_prox_pair, *c), prox_carry),
            (lambda c: prox_steps.pds_iva_step(X_prox_pair[0], *c), tuple(a[0] for a in prox_carry))),
        "admm_iva": (
            lambda: make_batched_admm_iva_runner(one)(X_prox_pair, admm_carry, n_run)[0], prox_end,
            lambda b: prox_end(b, fast_admm_iva(X_prox_pair[b], **no_scale)[1]),
            (lambda c: prox_steps.admm_iva_step(X_prox_pair, *c[1:], quad_inv=quad_inv_pair), admm_carry),
            (lambda c: prox_steps.admm_iva_step(X_prox_pair[0], *c[1:], quad_inv=quad_inv_pair[0]),
             tuple(a[0] for a in admm_carry))),
        "hva": (
            lambda: make_batched_hva_runner(one)(X_prox_pair, prox_carry, n_run)[0], prox_end,
            lambda b: prox_end(b, fast_hva(X_prox_pair[b], **no_scale)[1]),
            (lambda c: prox_steps.hva_pds_step(X_prox_pair, *c), prox_carry),
            (lambda c: prox_steps.hva_pds_step(X_prox_pair[0], *c), tuple(a[0] for a in prox_carry))),
        "ica": (
            lambda: make_batched_ica_runner(one)(wave_ica_pair, eye_ica, n_run), ica_end, ica_one,
            (lambda W_: grad_ica_step(wave_ica_pair, W_, torch.sign, natural=True), eye_ica),
            (lambda W_: grad_ica_step(wave_ica_pair[0], W_, torch.sign, natural=True), eye_ica[0])),
    }
    for name, (run_batch, end, fast_one, (step_batch, state_batch), (step_one, state_one)) in full_width.items():
        # launches per iteration at two utterances, as the dry run's case counts them; FDICA-IP2 launches K1 once
        # per utterance and pair, and the 8 sources here make 8 sequential pairs (the case's 3 sources, 3)
        per_iter = {"weighted_covariance": 2 * M} if name == "fdica_ip2" else PARALLEL_CASES[name].launches
        uses = {k: v * n_run for k, v in per_iter.items()}
        out = drive(f"{name} runner, world size 1, B = 2", run_batch, uses, totals, exact=True)
        for b in range(2):
            Y_b, loss_b = end(b, tuple(o[b] for o in out) if isinstance(out, tuple) else out[b])
            Y_one, loss_one = fast_one(b)
            rel, sdr = abs(loss_b - loss_one) / abs(loss_one), min_si_sdr(Y_b, Y_one)
            loss_only = name == "faster_iva"
            say("parallel", runner=repr(name), utterance=b, iterations=n_run, loss=loss_b, fast_path_loss=loss_one,
                loss_rel_diff=rel, min_si_sdr_db=sdr, bit_equal=bool(torch.equal(Y_b, Y_one)),
                gate=repr("loss" if loss_only else "loss and SI-SDR"))
            check(all_finite(Y_b) and rel <= (SENSITIVE_LOSS_TOL if loss_only else LOSS_TOL)
                  and (loss_only or sdr >= MIN_SI_SDR_DB), f"{name} runner utterance {b}: loss {rel}, {sdr:.2f} dB")
        # the kernels' summed durations a step (profile: no event seen reads "not measured")
        batch_kernels, _, batch_seen, batch_made, _, _ = profile(step_batch, state_batch, N_RUNNERS_TIMED)
        one_kernels, _, one_seen, one_made, _, _ = profile(step_one, state_one, N_RUNNERS_TIMED)
        say("parallel", runner=repr(name), card=repr(card),
            kernel_us_per_iter_per_utterance=sum(batch_kernels.values()) / 2 if batch_kernels else "not measured",
            fast_path_kernel_us_per_iter=sum(one_kernels.values()) if one_kernels else "not measured",
            timed=repr("the batched step against the fast path's, torch.profiler"),
            chained_steps=N_RUNNERS_TIMED, events_seen_made=(batch_seen, batch_made, one_seen, one_made))
    say("parallel", part=repr("full width, world size 1"), seconds=f"{time.perf_counter() - start:.1f}")

    # (c) HVA (its mask is a transform over the whole bin axis) and FastGaussMNMF (its power normalization a mean over
    # all bins) at that width over 2 gloo ranks sharing the card, against world size 1 in this process
    # (the dry run's comparison on these inputs: each rank holds its outputs on the relative measure, its
    # all-reduces at the pin and its kernel calls against the plain versions, and it raises on any miss)
    start = time.perf_counter()
    full_inputs = {
        "hva": (X_prox_pair.cpu().numpy(), tuple(a.cpu().numpy() for a in prox_carry)),
        "fast_mnmf": (X4_pair.cpu().numpy(), tuple(a.cpu().numpy() for a in fast_mnmf_carry)),
    }
    report = dryrun_multichip(2, device="cuda", names=tuple(full_inputs), backend="gloo",
                              kernel_tols=RANK_KERNEL_TOLS, inputs=full_inputs, n_iter=n_run, rel_tol=RUNNER_RANKS_TOL)
    for name, got in report["cases"].items():
        say("parallel", runner=repr(name), world=2, layout=tuple(report["shape"]), iterations=n_run,
            rel_err_vs_world_one=got["max_abs_err"], tol=got["tol"], bit_equal=got["max_abs_err"] == 0.0,
            all_reduces_per_iter=got["bin_sum_calls"] / n_run, pin=PARALLEL_CASES[name].pin,
            launches=repr({k: v for k, v in got["launches"].items() if v}), held_calls_and_rel_err=repr(got["held"]))
    say("parallel", part=repr("full width, 2 ranks"), seconds=f"{time.perf_counter() - start:.1f}")

    # (d) every runner over 2 and 4 gloo ranks sharing the card, layouts (1, 2) and (2, 2) (the
    # kernels are built: the ranks load them), and NCCL across cards where there are several; each rank holds
    # each against world size 1 and every kernel call of its run against the plain version; the dry run raises
    # on any miss
    runs = [("gloo", 2), ("gloo", 4)]
    if torch.cuda.device_count() > 1:
        runs.append(("nccl", min(4, torch.cuda.device_count())))
    rank_launches = {name: 0 for name in KERNELS}
    for backend, n_ranks in runs:
        start = time.perf_counter()
        report = dryrun_multichip(n_ranks, device="cuda", names=tuple(PARALLEL_CASES), backend=backend,
                                  kernel_tols=RANK_KERNEL_TOLS)
        for name, got in report["cases"].items():
            case = PARALLEL_CASES[name]
            after_loop = case.extra if report["shape"][1] > 1 else 0  # the waveform runner's bin gather
            say("parallel", runner=repr(name), backend=backend, world=n_ranks, layout=tuple(report["shape"]),
                measure=case.measure, max_err=got["max_abs_err"], tol=got["tol"],
                all_reduces_per_iter=(got["bin_sum_calls"] - after_loop) / parallel_dryrun.N_STEPS, pin=case.pin,
                all_reduces_after_loop=after_loop, launches=repr({k: v for k, v in got["launches"].items() if v}),
                held_calls_and_rel_err=repr(got["held"]))
            for k, v in got["launches"].items():
                rank_launches[k] += v
        say("parallel", backend=backend, world=n_ranks, seconds=f"{time.perf_counter() - start:.1f}")
    for name in ("weighted_covariance", "ip1_sweep", "iss1_sweep", "gj_inverse", "model_traces", "ipa_congruence",
                 "jacobi_eigh"):
        check(rank_launches[name] > 0, f"the sharded runners never launched {name}")
        totals[name] += rank_launches[name]
    say("parallel", ranks_launches=repr(rank_launches), seconds=f"{time.perf_counter() - parallel_start:.1f}")

    # ---- 5o. WAV in, separated WAVs out: the native codec, wavread/wavwrite and AuxIVA-IP1 at full width ----------
    laps("5o")
    start = time.perf_counter()
    check(native.available(), f"the native codec did not build: {native.build_error()}")
    say("wav", codec=repr(os.path.relpath(native.library_path(), REPO)), build_seconds=f"{time.perf_counter() - start:.3f}")
    mixture = make_mixture(seed=0)
    pcm = np.round(mixture / np.abs(mixture).max() * 32767).astype(np.int16).T  # (samples, channels), peak-normalized
    with tempfile.TemporaryDirectory() as wav_dir:
        mix_path = os.path.join(wav_dir, "mixture.wav")
        native.wav_write_i16(mix_path, pcm, 16000)
        wave_read, rate = wavread(mix_path, channels_first=True)
        wave_native, rate_native = native.wav_read(mix_path)
        info = native.wav_info(mix_path)
        check(info == (8, 16000, 16, pcm.shape[0]) and rate == rate_native == 16000, f"WAV header {info}, {rate}")
        same = bool(np.array_equal(wave_read.astype(np.float32), wave_native.T))
        say("wav", file=repr("mixture.wav"), info=info, bytes=os.path.getsize(mix_path), shape=wave_read.shape,
            readers_equal=same)
        check(same, "wavread and native.wav_read disagree on the mixture")
        wave_file = torch.from_numpy(wave_read.astype(np.float32))
        wave_mem = torch.from_numpy((pcm.T / 32768).astype(np.float32))  # the quantized mixture, never written

        def wav_run(wave_in):
            iva_wav = AuxLaplaceIVA(spatial_algorithm="IP")
            y = separate_waveform(wave_in, iva_wav, n_iter=N_ITER, n_fft=N_FFT, hop_length=HOP)
            return iva_wav, y

        iva_wav, y_file = drive("separate (WAV), AuxIVA-IP1", lambda: wav_run(wave_file),
                                {"weighted_covariance": N_ITER, "ip1_sweep": N_ITER}, totals, exact=True)
        iva_mem, y_mem = wav_run(wave_mem)
        plain_wav, y_plain = run_plain(lambda: wav_run(wave_file))
        torch.cuda.synchronize()
        bits = bool(torch.equal(y_file, y_mem)) and bool(torch.equal(iva_wav.output, iva_mem.output))
        say("wav", path=repr("separate (WAV), AuxIVA-IP1"), equals_in_memory_run=bits)
        check(bits, "the run on the WAV file differs from the run on the array in memory")
        check(all_finite(y_file) and tuple(y_file.shape) == tuple(wave_file.shape), "separated waveform")
        hold_class("separate (WAV), AuxIVA-IP1", iva_wav, iva_wav.output, plain_wav, plain_wav.output)
        sdr_out = []
        for n, source in enumerate(y_file.cpu().numpy().astype(np.float64)):
            scaled = source / np.abs(source).max() * 0.99  # below full scale: wavwrite maps 1.0 to 32768
            path = os.path.join(wav_dir, f"source{n}.wav")
            wavwrite(path, scaled, 16000)
            back, rate = wavread(path)
            check(rate == 16000 and back.shape == scaled.shape, f"source {n}: {rate}, {back.shape}")
            sdr_out.append(si_sdr_db(back, scaled))
        say("wav", sources_written=len(sdr_out), min_round_trip_si_sdr_db=min(sdr_out), tol=WAV_SI_SDR_DB)
        check(min(sdr_out) >= WAV_SI_SDR_DB, f"a source lost {min(sdr_out):.1f} dB through its WAV file")

    # ---- 5p. the update_by_* spatial updates at the main path's shapes ---------------------------------------------
    laps("5p")
    W_up = W_eye + 0.1 * torch.complex(*(torch.from_numpy(rng.standard_normal((I, M, M), dtype=np.float32))
                                        for _ in range(2))).to(device)
    U_up = K.weighted_covariance(X, phi_scalar)
    W_by = drive("update_by_ip1", lambda: update_by_ip1(W_up, U_up), {"ip1_sweep": 1}, totals, exact=True)
    W_router = ip1_update(W_up, U_up, eps=1e-10)
    W_exact = K.ip1_sweep_plain(W_up, U_up, eps=1e-10, solve_impl="gjnp")
    rel = relative_error(W_by, W_exact)
    say("update_by", update=repr("update_by_ip1"), shape=tuple(W_up.shape), equals_ip1_update=bool(torch.equal(W_by, W_router)),
        rel_err=rel, tol=SWEEP_TOL)
    check(torch.equal(W_by, W_router) and rel <= SWEEP_TOL, f"update_by_ip1: rel err {rel} against the exact twin")
    weight = phi_scalar[:, None, :]  # (N, 1, T), as the JAX classes broadcast it
    Y_by = drive("update_by_iss1", lambda: update_by_iss1(X, weight), {"iss1_sweep": 1}, totals, exact=True)
    rel = relative_error(Y_by, K.iss1_sweep_plain(X, phi_scalar, eps=1e-10))
    say("update_by", update=repr("update_by_iss1"), shape=tuple(X.shape), rel_err=rel, tol=ISS1_TOL)
    check(all_finite(Y_by) and rel <= ISS1_TOL, f"update_by_iss1: rel err {rel}")
    congruence, eighs = [], []
    with recording(ipa_steps, "congruence_round", lambda *args: congruence.append(tuple(a.clone() for a in args))), \
            recording(prox_steps, "symm_eigh", lambda S: eighs.append(S.reshape(-1, *S.shape[-2:]).clone())):
        Y_ipa = drive("update_by_ipa", lambda: update_by_ipa(X, weight),
                      {"weighted_covariance": 1, "jacobi_eigh": M, "ipa_congruence": M}, totals, exact=True)
    Y_ipa_plain = run_plain(lambda: update_by_ipa(X, weight))
    cong_err = max(relative_error(K.ipa_congruence(*args)[0], K.ipa_congruence_plain(*args)[0]) for args in congruence)
    eigh_equal = all(all(map(torch.equal, K.jacobi_eigh(A), K.jacobi_eigh_plain(A))) for A in eighs)
    loss_ipa, loss_ipa_plain = float(iva_laplace_loss(X, Y=Y_ipa)), float(iva_laplace_loss(X, Y=Y_ipa_plain))
    loss_rel = abs(loss_ipa - loss_ipa_plain) / abs(loss_ipa_plain)
    say("update_by", update=repr("update_by_ipa"), rounds=len(congruence), congruence_rel_err=cong_err, tol=IPA_TOL,
        eighs=len(eighs), eigh_bits_equal=eigh_equal, loss=loss_ipa, plain_loss=loss_ipa_plain, loss_rel_diff=loss_rel,
        loss_tol=SENSITIVE_LOSS_TOL)
    check(all_finite(Y_ipa) and cong_err <= IPA_TOL and eigh_equal and loss_rel <= SENSITIVE_LOSS_TOL,
          f"update_by_ipa: K6 {cong_err}, K7 bits {eigh_equal}, loss {loss_rel}")
    # no kernel: on the card against the CPU, in complex128 (and in complex64 on the card: finite, nothing launched)
    W128, U128, X128_up = W_up.to(torch.complex128), U_up.to(torch.complex128), X.to(torch.complex128)
    w128 = phi_scalar.to(torch.float64)[:, None, :].expand(M, I, T)
    # VCD on the first part of IPSDTA's blocks (63 of 4 bins), the model's inverse the weights times the identity
    X_part = ipsdta_steps.split_bins(X128_up, 1, ipsdta_steps.part_shapes(I, IPSDTA_BLOCKS))[0]  # (M, 63, 4, T)
    n_blocks, n_neighbors = X_part.shape[1:3]
    R_inv = (phi_scalar.to(torch.float64)[:, :, None, None, None]
             * torch.eye(n_neighbors, dtype=torch.complex128, device=device)).expand(M, T, n_blocks, -1, -1)
    RXX = ipsdta_steps.vcd_covariance(R_inv, X_part)
    W_vcd = ipsdta_steps.split_bins(W128, 0, ipsdta_steps.part_shapes(I, IPSDTA_BLOCKS))[0]
    for label, update, args in (
        ("update_by_ip2", update_by_ip2, (W128, U128)),
        ("update_by_iss2", update_by_iss2, (X128_up, w128)),
        ("update_by_block_decomposition_vcd", update_by_block_decomposition_vcd, (W_vcd, RXX)),
    ):
        out = drive(label, lambda: update(*args), {}, totals, exact=True)
        out_cpu = update(*(a.cpu() for a in args))
        rel = relative_error(out.cpu(), out_cpu)
        out64 = drive(f"{label}, complex64", lambda: update(*(a.to(torch.complex64 if a.is_complex() else torch.float32)
                                                              for a in args)), {}, totals, exact=True)
        say("update_by", update=repr(label), shape=tuple(args[0].shape), card_vs_cpu_rel_err=rel, tol=ROUTE_LOSS_TOL,
            complex64_finite=all_finite(out64))
        check(all_finite(out, out64) and rel <= ROUTE_LOSS_TOL, f"{label}: {rel} from the CPU")

    # ---- 5q. a flooring_fn that is not max(., eps): the plain routes, with the callable ---------------------------------
    laps("5q")

    def shifted(v):
        return v + 1e-10

    flooring_classes = {
        "AuxLaplaceIVA(IP1)": lambda d: AuxLaplaceIVA(spatial_algorithm="IP1", flooring_fn=shifted, device=d),
        "AuxLaplaceIVA(IPA)": lambda d: AuxLaplaceIVA(spatial_algorithm="IPA", flooring_fn=shifted, device=d),
        "AuxGaussIVA(ISS1)": lambda d: AuxGaussIVA(spatial_algorithm="ISS1", flooring_fn=shifted, device=d),
        "GaussILRMA(ISS1)": lambda d: GaussILRMA(n_basis=2, spatial_algorithm="ISS1", flooring_fn=shifted,
                                                 rng=np.random.default_rng(0), device=d),
        "TILRMA(IP2)": lambda d: TILRMA(n_basis=2, dof=1000, spatial_algorithm="IP2", flooring_fn=shifted,
                                        rng=np.random.default_rng(0), device=d),
        "AuxLaplaceFDICA(IP1)": lambda d: AuxLaplaceFDICA(spatial_algorithm="IP1", flooring_fn=shifted, device=d),
        "GaussMNMF": lambda d: GaussMNMF(n_basis=2, flooring_fn=shifted, rng=np.random.default_rng(0), device=d),
        "FastGaussMNMF(IP1)": lambda d: FastGaussMNMF(n_basis=2, flooring_fn=shifted, rng=np.random.default_rng(0),
                                                      device=d),
        "TIPSDTA": lambda d: TIPSDTA(n_basis=2, n_blocks=IPSDTA_BLOCKS, dof=IPSDTA_DOF, flooring_fn=shifted,
                                     rng=np.random.default_rng(0), device=d),
        "CACGMM": lambda d: CACGMM(flooring_fn=shifted, rng=np.random.default_rng(0), device=d),
    }

    def on_host(make):
        host_method = make("cpu")
        host_method(X128.cpu(), n_iter=ROUTE_ITER)
        return host_method

    # the CPU twins run on a thread of their own while the card runs the classes
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_runs = {label: pool.submit(on_host, make) for label, make in flooring_classes.items()}
        card_runs = {}
        for label, make in flooring_classes.items():
            card_method = make(device)
            Y = drive(f"{label}, flooring_fn=v + 1e-10, complex128", lambda: card_method(X128, n_iter=ROUTE_ITER),
                      {}, totals, exact=True)
            card_runs[label] = (card_method, Y)
    for label, (card_method, Y) in card_runs.items():
        host_method = host_runs[label].result()
        rel = abs(card_method.loss[-1] - host_method.loss[-1]) / abs(host_method.loss[-1])
        say("flooring", path=repr(label), shape=tuple(X128.shape), loss=card_method.loss[-1],
            cpu_loss=host_method.loss[-1], loss_rel_diff=rel, tol=ROUTE_LOSS_TOL)
        check(all_finite(Y) and Y.dtype == torch.complex128 and rel <= ROUTE_LOSS_TOL, f"{label} with a callable: {rel}")
    iva_shift = AuxLaplaceIVA(spatial_algorithm="IP", flooring_fn=lambda v: v + 1e-6)
    Y_shift = drive("AuxLaplaceIVA(IP1), flooring_fn=v + 1e-6, complex64",
                    lambda: iva_shift(X, n_iter=N_ITER_FLOORING), {"weighted_covariance": N_ITER_FLOORING}, totals,
                    exact=True)
    say("route", path=repr("AuxLaplaceIVA(IP1), flooring_fn=v + 1e-6"), ip1_update="plain",
        loss_first=iva_shift.loss[0], loss_last=iva_shift.loss[-1])
    check(all_finite(Y_shift) and iva_shift.loss[-1] < iva_shift.loss[0], "AuxLaplaceIVA with a callable floor")
    iva_default = AuxLaplaceIVA(spatial_algorithm="IP")
    drive("AuxLaplaceIVA(IP1), default floor", lambda: iva_default(X, n_iter=2),
          {"weighted_covariance": 2, "ip1_sweep": 2}, totals, exact=True)
    say("route", path=repr("AuxLaplaceIVA(IP1), default floor"), ip1_update="kernel")

    # ---- 5r. checkpoint / resume at full width: k iterations, a file, k more in a fresh instance, against 2k --------
    laps("5r")
    # (label, constructor, k, the launches of both halves together, the file's keywords besides the loss)
    checkpoint_cases = (
        ("AuxLaplaceIVA(IP)", lambda: AuxLaplaceIVA(spatial_algorithm="IP"), 50,
         {"weighted_covariance": 100, "ip1_sweep": 100}, {"demix_filter"}),
        ("AuxLaplaceIVA(ISS1), scale_restoration=False",
         lambda: AuxLaplaceIVA(spatial_algorithm="ISS1", scale_restoration=False), 50, {"iss1_sweep": 100}, {"output"}),
        ("GaussILRMA(IP), n_basis=8", lambda: GaussILRMA(n_basis=N_BASIS, spatial_algorithm="IP",
                                                         rng=np.random.default_rng(0)), 50,
         {"weighted_covariance": 100, "ip1_sweep": 100}, {"demix_filter", "basis", "activation"}),
        # K7 twice an EM step and once a loss, once for the start's loss and once for each call's posterior
        ("CACGMM, 8 sources", lambda: CACGMM(rng=np.random.default_rng(0)), 25, {"jacobi_eigh": 3 * 50 + 3},
         {"mixing", "covariance"}),
        # K3 three times a part, K7 once a part, each iteration; the basis is a tuple of two parts
        ("GaussIPSDTA, n_basis=8, 64 blocks", lambda: GaussIPSDTA(n_basis=N_BASIS, n_blocks=IPSDTA_BLOCKS,
                                                                  rng=np.random.default_rng(0)), 10,
         {"gj_inverse": 6 * 20, "jacobi_eigh": 2 * 20}, {"demix_filter", "basis.0", "basis.1", "activation"}),
    )
    with tempfile.TemporaryDirectory() as checkpoint_dir:
        for label, make, k, uses, keys in checkpoint_cases:
            start = time.perf_counter()
            path = os.path.join(checkpoint_dir, "state.npz")

            def halves():
                half = make()
                half(X, n_iter=k)
                save_checkpoint(path, half)
                cont = make()
                return cont, resume(cont, X, path, n_iter=k)

            cont, Y_cont = drive(f"checkpoint, {label}", halves, uses, totals, exact=True)
            full = make()
            Y_full = full(X, n_iter=2 * k)
            with np.load(path) as data:
                file_keys = {key: data[key].dtype.name for key in sorted(data)}
            same = bool(torch.equal(Y_cont, Y_full)) and cont.loss == full.loss
            say("checkpoint", path=repr(label), shape=tuple(X.shape), k=k, keys=file_keys, bytes=os.path.getsize(path),
                output_and_loss_equal=same, loss_last=full.loss[-1], seconds=f"{time.perf_counter() - start:.3f}")
            check(set(file_keys) == keys | {"loss"}, f"checkpoint, {label}: the file holds {sorted(file_keys)}")
            check(all_finite(Y_full) and len(cont.loss) == 2 * k + 1, f"checkpoint, {label}: output or loss history")
            check(same, f"checkpoint, {label}: the resumed run differs from the uninterrupted one")

    # ---- 5s. the profiling helpers on the main path: a trace, a timing and one call's measured cost ---------------
    laps("5s")
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with tempfile.TemporaryDirectory() as trace_dir:

            def traced():
                with profiling.trace(trace_dir):
                    torch.cuda._sleep(1000)  # a spin kernel first: a session most often drops its first event
                    return fast_auxiva(X, n_iter=N_ITER_TRACE, algorithm="IP1")

            drive("profiling.trace, fast_auxiva(IP1)", traced,
                  {"weighted_covariance": N_ITER_TRACE, "ip1_sweep": N_ITER_TRACE}, totals, exact=True)
            files = [os.path.join(trace_dir, name) for name in os.listdir(trace_dir) if name.endswith(".pt.trace.json")]
            check(len(files) == 1, f"profiling.trace wrote {os.listdir(trace_dir)}")
            with open(files[0]) as f:
                text = f.read()
        named = {name: text.count(f"{name}_kernel") for name in ("weighted_covariance", "ip1_sweep")}
        say("profiling", helper=repr("trace"), attempt=attempt, bytes=len(text), kernel_name_mentions=named)
        if all(named.values()):
            break
    check(text and all(named.values()), f"the trace names {named} after {attempt} sessions")
    seconds, _ = drive("profiling.timed, fast_auxiva(IP1)",
                       lambda: profiling.timed(fast_auxiva, X, n_iter=N_ITER_TRACE, algorithm="IP1"),
                       {"weighted_covariance": 6 * N_ITER_TRACE, "ip1_sweep": 6 * N_ITER_TRACE}, totals, exact=True)
    say("profiling", helper=repr("timed"), card=repr(card), steps=N_ITER_TRACE, seconds_per_call=seconds,
        ms_per_step=seconds * 1e3 / N_ITER_TRACE)
    check(seconds > 0, f"profiling.timed gave {seconds} s")
    stats = drive("profiling.compiled_stats, fast_auxiva(IP1)",
                  lambda: profiling.compiled_stats(fast_auxiva, X, n_iter=1, algorithm="IP1"),
                  {"weighted_covariance": 1, "ip1_sweep": 1}, totals, exact=True)
    say("profiling", helper=repr("compiled_stats"), card=repr(card), steps=1, **stats)
    check(stats["peak_bytes"] and stats["peak_bytes"] > 0 and stats["flops"] is None,
          f"compiled_stats on one step: {stats}")

    # ---- 6. times --------------------------------------------------------------
    laps("6")
    U_main = K.weighted_covariance(X, phi_scalar)
    phi_c, phi_bins_c, X_conj = phi_scalar.to(X.dtype), phi_bins.to(X.dtype), X.conj().resolve_conj()
    timed = {
        "weighted_covariance": (
            "scalar (N,T)",
            lambda: K.weighted_covariance(X, phi_scalar),
            lambda: K.weighted_covariance_plain(X, phi_scalar),
            lambda: torch.einsum("nt,pit,qit->inpq", phi_c, X, X_conj),
            wcov_bound(M, I, T, M, per_bin=False),
        ),
        "weighted_covariance per-bin": (
            "per-bin (N,I,T)",
            lambda: K.weighted_covariance(X, phi_bins),
            lambda: K.weighted_covariance_plain(X, phi_bins),
            lambda: torch.einsum("nit,pit,qit->inpq", phi_bins_c, X, X_conj),
            wcov_bound(M, I, T, M, per_bin=True),
        ),
        "ip1_sweep": (
            "(I,N,M)",
            lambda: K.ip1_sweep(W_eye, U_main),
            lambda: K.ip1_sweep_plain(W_eye, U_main, solve_impl="lu"),
            None,
            ip1_bound(I, M, M),
        ),
        "iss1_sweep scalar": (
            "scalar (N,T)",
            lambda: K.iss1_sweep(X, phi_scalar, eps=ILRMA_EPS),
            lambda: K.iss1_sweep_plain(X, phi_scalar, eps=ILRMA_EPS),
            None,
            iss1_bound(M, I, T, per_bin=False),
        ),
        "iss1_sweep": (
            "per-bin (N,I,T)",
            lambda: K.iss1_sweep(X, phi_bins, eps=ILRMA_EPS),
            lambda: K.iss1_sweep_plain(X, phi_bins, eps=ILRMA_EPS),
            None,
            iss1_bound(M, I, T, per_bin=True),
        ),
        "jacobi_eigh": (
            "PDS right Grams (257,16,16)",
            lambda: K.jacobi_eigh(A_pds),
            lambda: K.jacobi_eigh_plain(A_pds),
            lambda: torch.linalg.eigh(A_pds),
            jacobi_bound(*A_pds.shape[:2]),
        ),
        "jacobi_eigh ADMM": (
            "ADMM stacked Grams (514,16,16)",
            lambda: K.jacobi_eigh(A_admm),
            lambda: K.jacobi_eigh_plain(A_admm),
            lambda: torch.linalg.eigh(A_admm),
            jacobi_bound(*A_admm.shape[:2]),
        ),
        "jacobi_eigh IPA": (
            "IPA pencil (257,14,14)",
            lambda: K.jacobi_eigh(A_ipa),
            lambda: K.jacobi_eigh_plain(A_ipa),
            lambda: torch.linalg.eigh(A_ipa),
            jacobi_bound(*A_ipa.shape[:2]),
        ),
        "jacobi_eigh MNMF floor": (
            "dense-MNMF eigenvalue floor (2056,16,16)",
            lambda: K.jacobi_eigh(A_floor),
            lambda: K.jacobi_eigh_plain(A_floor),
            lambda: eigh_in_batches(A_floor),
            jacobi_bound(*A_floor.shape[:2]),
        ),
        "jacobi_eigh IPSDTA": (
            "IPSDTA geometric mean, main part (4032,8,8)",
            lambda: K.jacobi_eigh(A_ipsdta),
            lambda: K.jacobi_eigh_plain(A_ipsdta),
            lambda: eigh_in_batches(A_ipsdta),
            jacobi_bound(*A_ipsdta.shape[:2]),
        ),
        "jacobi_eigh eigh model": (
            # no plain time: the plain Jacobi takes tens of seconds here
            "the eigh model's R (160882,16,16)",
            lambda: K.jacobi_eigh(A_model),
            None,
            lambda: eigh_in_batches(A_model),
            jacobi_bound(*A_model.shape[:2]),
        ),
        "inv_sandwich": (
            "dense-MNMF model after 2 iterations (160882,8,8)",
            lambda: K.inv_sandwich(R_main, XX_main),
            lambda: K.inv_sandwich_plain(R_main, XX_main),
            lambda: library_inv_sandwich(R_main, XX_main),
            inv_sandwich_bound(I * T, M),
        ),
        "model_traces": (
            "dense-MNMF model after 2 iterations (8,257,626,8)",
            lambda: K.model_traces(Lamb_main, H_mnmf, XX_main, MNMF_EPS),
            lambda: K.model_traces_plain(Lamb_main, H_mnmf, XX_main, MNMF_EPS),
            lambda: library_model_traces(Lamb_main, H_mnmf, XX_main, MNMF_EPS),
            model_traces_bound(M, I, T, M),
        ),
        "gj_inverse": (
            "IPSDTA model, main part (8,626,63,4,4)",
            lambda: K.gj_inverse(R_ipsdta[0]),
            lambda: K.gj_inverse_plain(R_ipsdta[0]),
            lambda: torch.linalg.inv_ex(R_ipsdta[0]),
            gj_inverse_bound(R_ipsdta[0].numel() // 16, 4),
        ),
        "weighted_covariance FastGaussMNMF": (
            "per-channel (M,I,T), FastGaussMNMF (4,257,626)",
            lambda: K.weighted_covariance(X4, phi_mnmf),
            lambda: K.weighted_covariance_plain(X4, phi_mnmf),
            lambda: torch.einsum("nit,pit,qit->inpq", phi_mnmf.to(X4.dtype), X4, X4.conj().resolve_conj()),
            wcov_bound(M4, I, T, M4, per_bin=True),
        ),
        "ip1_sweep FastGaussMNMF": (
            "FastGaussMNMF diagonalizer (257,4,4)",
            lambda: K.ip1_sweep(Q_in, U_in),
            lambda: K.ip1_sweep_plain(Q_in, U_in, solve_impl="lu"),
            None,
            ip1_bound(I, M4, M4),
        ),
        "jacobi_eigh cACGMM": (
            "cACGMM E-step pencil (2056,16,16)",
            lambda: K.jacobi_eigh(A_estep),
            lambda: K.jacobi_eigh_plain(A_estep),
            lambda: eigh_in_batches(A_estep),
            jacobi_bound(*A_estep.shape[:2]),
        ),
        "weighted_covariance pair": (
            "pair (2,T), AuxIVA-IP2 (8,257,626)",
            lambda: K.weighted_covariance(X, phi_pair),
            lambda: K.weighted_covariance_plain(X, phi_pair),
            lambda: torch.einsum("nt,pit,qit->inpq", phi_pair.to(X.dtype), X, X_conj),
            wcov_bound(M, I, T, 2, per_bin=False),
        ),
        "weighted_covariance pair per-bin": (
            "per-bin pair (2,I,T) (8,257,626)",
            lambda: K.weighted_covariance(X, phi_pair_bins),
            lambda: K.weighted_covariance_plain(X, phi_pair_bins),
            lambda: torch.einsum("nit,pit,qit->inpq", phi_pair_bins.to(X.dtype), X, X_conj),
            wcov_bound(M, I, T, 2, per_bin=True),
        ),
        "jacobi_eigh FasterIVA": (
            "FasterIVA top eigenvectors (2056,16,16)",
            lambda: K.jacobi_eigh(A_top),
            lambda: K.jacobi_eigh_plain(A_top),
            lambda: eigh_in_batches(A_top),
            jacobi_bound(*A_top.shape[:2]),
        ),
        "jacobi_eigh polar": (
            "FastIVA polar factor's Gram (257,16,16)",
            lambda: K.jacobi_eigh(A_polar),
            lambda: K.jacobi_eigh_plain(A_polar),
            lambda: eigh_in_batches(A_polar),
            jacobi_bound(*A_polar.shape[:2]),
        ),
        "ipa_congruence": (
            "a sweep's last round (257,8,8,8)",
            lambda: K.ipa_congruence(T_sweep, U_sweep, G_sweep),
            lambda: K.ipa_congruence_plain(T_sweep, U_sweep, G_sweep),
            # the same three products as torch.matmul calls
            lambda: (torch.matmul(torch.matmul(T_sweep[:, None], U_sweep), T_sweep.mH[:, None]),
                     torch.matmul(T_sweep, G_sweep)),
            congruence_bound(I, M, M),
        ),
    }
    timings = {}
    for key, (weights, kernel_fn, plain_fn, library_fn, (bound, bound_by)) in timed.items():
        profiler_us, events_seen, events_made = profiled_us(kernel_fn, key.split()[0])
        ms = median_ms(kernel_fn, queued=True)
        plain_ms = median_ms(plain_fn, queued=True) if plain_fn is not None else None
        call_ms = median_ms(kernel_fn, queued=False)
        plain_call_ms = median_ms(plain_fn, queued=False) if plain_fn is not None else None
        library_ms = median_ms(library_fn, queued=True) if library_fn is not None else None
        timings[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library_ms}
        say("time", kernel=repr(key), weights=repr(weights), card=repr(card), device_ms=ms,
            plain_device_ms=plain_ms, call_ms=call_ms, plain_call_ms=plain_call_ms, library_device_ms=library_ms,
            bound_ms=bound, bound_by=bound_by, bound_share=bound / ms, runs=N_TIMED, stat="median",
            profiler_us_per_launch=profiler_us, profiler_events=f"{events_seen}/{events_made}")
    # K5 as the step calls it: twice the traces alone, once the sums alone
    mode_ms = {outputs: median_ms(lambda: K.model_traces(Lamb_main, H_mnmf, XX_main, MNMF_EPS, outputs=outputs),
                                  queued=True) for outputs in ("traces", "sums")}
    say("time", kernel="model_traces by output", card=repr(card), traces_device_ms=mode_ms["traces"],
        sums_device_ms=mode_ms["sums"], step_device_ms=2 * mode_ms["traces"] + mode_ms["sums"],
        step_full_form_device_ms=3 * timings["model_traces"]["ms"], runs=N_TIMED, stat="median")
    gjnp_ms = median_ms(lambda: K.ip1_sweep_plain(W_eye, U_main, solve_impl="gjnp"), queued=True)
    say("time", kernel="ip1_sweep", card=repr(card), plain_gjnp_device_ms=gjnp_ms, runs=N_TIMED, stat="median")
    B_rem = R_ipsdta[1].numel() // 25
    rem_ms = median_ms(lambda: K.gj_inverse(R_ipsdta[1]), queued=True)
    rem_lib_ms = median_ms(lambda: torch.linalg.inv_ex(R_ipsdta[1]), queued=True)
    stage_bound = gj_inverse_bound(R_ipsdta[0].numel() // 16, 4)[0] + gj_inverse_bound(B_rem, 5)[0]
    say("time", kernel="gj_inverse remainder part", shape=tuple(R_ipsdta[1].shape), card=repr(card), device_ms=rem_ms,
        library_device_ms=rem_lib_ms, bound_ms=gj_inverse_bound(B_rem, 5)[0],
        stage_device_ms=timings["gj_inverse"]["ms"] + rem_ms, stage_bound_ms=stage_bound, runs=N_TIMED, stat="median")
    Y_long_phi = cases[3][2]
    long_ms = median_ms(lambda: K.iss1_sweep(Y_long, Y_long_phi, eps=ILRMA_EPS), queued=True)
    long_us, events_seen, events_made = profiled_us(lambda: K.iss1_sweep(Y_long, Y_long_phi, eps=ILRMA_EPS), "iss1_sweep")
    say("time", kernel="iss1_sweep streamed", shape=LONG_SHAPE, card=repr(card), device_ms=long_ms,
        bound_ms=iss1_bound(*LONG_SHAPE, per_bin=True)[0], runs=N_TIMED, stat="median",
        profiler_us_per_launch=long_us, profiler_events=f"{events_seen}/{events_made}")

    # iterations per second of each path's fast-path step: plain, kernels, kernels, plain
    laps("6 rates")
    def fast_mnmf_start():
        """``(Q, T, V, D)``: ``fast_gauss_mnmf``'s start from ``default_rng(0)`` on the 4 channels."""
        draws = np.random.default_rng(0)
        T_, V_ = draws.random((M4, I, FAST_MNMF_BASIS)), draws.random((M4, FAST_MNMF_BASIS, T))
        D_ = np.maximum(draws.random((I, M4, M4)), 1e-10)
        return (torch.eye(M4, dtype=X.dtype, device=device).expand(I, -1, -1).contiguous(),
                *(torch.from_numpy(a.astype(np.float32)).to(device) for a in (T_, V_, D_)))

    T0 = torch.from_numpy(rng.random((M, I, N_BASIS), dtype=np.float32)).to(device)
    V0 = torch.from_numpy(rng.random((M, N_BASIS, T), dtype=np.float32)).to(device)
    steps = {
        "AuxIVA-IP1": (lambda s: (auxiva_ip1_step(X, s[0]),), (W_eye,)),
        "GaussILRMA-IP1": (lambda s: ilrma_ip_step(X, *s), (W_eye, T0, V0)),
        "GaussILRMA-ISS1": (lambda s: ilrma_iss_step(*s), (X, T0, V0)),
        "AuxIVA-ISS1": (lambda s: (auxiva_iss1_step(s[0]),), (X,)),
        "AuxIVA-IPA": (lambda s: (auxiva_ipa_step(s[0]),), (X,)),
        "GaussILRMA-IPA": (lambda s: ilrma_iss_step(*s, spatial="IPA"), (X, T0, V0)),
        "PDSIVA": (lambda s: prox_steps.pds_iva_step(X_prox, *s), (W_eye, Y_zero)),
        "HVA": (lambda s: prox_steps.hva_pds_step(X_prox, *s), (W_eye, Y_zero)),
        # the state is (W, V, Vt, Y, Yt); the step reads all but W
        "ADMMIVA": (lambda s: prox_steps.admm_iva_step(X_prox, *s[1:], quad_inv=quad_inv),
                    (F_zero, F_zero, Y_zero, F_zero, Y_zero)),
        "GaussMNMF-dense": (lambda s: gauss_mnmf_step(XX_main, *s, eps=MNMF_EPS), (T_start, V_start, H_start)),
        "GaussMNMF-dense eigh": (lambda s: gauss_mnmf_step(XX_eigh, *s, eps=MNMF_EPS, psd_impl="eigh"),
                                 (T_start, V_start, H_start)),
        "GaussIPSDTA": (lambda s: ipsdta_steps.ipsdta_vcd_step(X, *s, eps=IPSDTA_EPS), ipsdta_start()),
        "TIPSDTA": (lambda s: ipsdta_steps.ipsdta_vcd_step(X, *s, dof=IPSDTA_DOF, eps=IPSDTA_EPS), ipsdta_start()),
        "FastGaussMNMF 4ch": (lambda s: fast_mnmf_steps.fast_gauss_mnmf_step(X4, *s), fast_mnmf_start()),
        "cACGMM": (lambda s: cacgmm_steps.step(Z8, *s), cacgmm_start(np.random.default_rng(0), M, I, device)),
        "cACGMM chol": (lambda s: cacgmm_steps.step(Z8, *s, impl="chol"),
                        cacgmm_start(np.random.default_rng(0), M, I, device)),
        "cACGMM K1 covariance": (lambda s: cacgmm_steps.step(Z8, *s, covariance_impl="kernel"),
                                 cacgmm_start(np.random.default_rng(0), M, I, device)),
        "AuxIVA-IP2": (lambda s: (auxiva_ip2_step(X, s[0]),), (W_eye,)),
        "AuxIVA-ISS2": (lambda s: (auxiva_iss2_step(s[0]),), (X,)),
        "GaussILRMA-IP2": (lambda s: ilrma_ip_step(X, *s, spatial="IP2"), (W_eye, T0, V0)),
        "GaussILRMA-ISS2": (lambda s: ilrma_iss_step(*s, spatial="ISS2"), (X, T0, V0)),
        "FastIVA": (lambda s: (fixed_point_iva_steps.fast_iva_step(Z_main, s[0]),), (W_eye,)),
        "FasterIVA": (lambda s: (fixed_point_iva_steps.faster_iva_step(Z_main, s[0]),), (W_eye,)),
        "GradIVA": (lambda s: (grad_laplace_iva_step(X, s[0]),), (W_eye,)),
        "NaturalGradIVA": (lambda s: (grad_laplace_iva_step(X, s[0], natural=True),), (W_eye,)),
        "FastGaussMNMF-IP2 4ch": (lambda s: fast_mnmf_steps.fast_gauss_mnmf_step(X4, *s, diagonalizer="IP2"),
                                  fast_mnmf_start()),
        "NaturalGradLaplaceICA 2ch": (lambda s: (ica_step({"X": wave_ica, "W": s[0]})["W"],),
                                      (torch.eye(ICA_CHANNELS, device=device),)),
        "AuxFDICA-IP1": (lambda s: (fdica_steps.aux_laplace_fdica_ip1_step(X, s[0]),), (W_eye,)),
        "AuxFDICA-IP2": (lambda s: (fdica_steps.aux_laplace_fdica_ip2_step(X, s[0]),), (W_eye,)),
        "GradFDICA": (lambda s: (fdica_steps.grad_laplace_fdica_step(X, s[0], is_holonomic=False),), (W_eye,)),
        "NaturalGradFDICA": (lambda s: (fdica_steps.grad_laplace_fdica_step(X, s[0], is_holonomic=False, natural=True),),
                             (W_eye,)),
        "AuxIVA-IPA solve": (lambda s: (auxiva_ipa_step(s[0], secular_impl="solve"),), (X,)),
        "FastIVA qdwh": (lambda s: (fixed_point_iva_steps.fast_iva_step(Z_main, s[0], polar_impl="qdwh"),), (W_eye,)),
        "FasterIVA solve": (lambda s: (fixed_point_iva_steps.faster_iva_step(Z_main, s[0], eig_impl="solve"),),
                            (W_eye,)),
    }
    ica_step = ica.make_step()
    XX_eigh = instant_covariance(X, eps=MNMF_EPS, psd_impl="eigh")
    # (kernel, plain) chained steps where the default N_ITER of each would take too long
    n_steps = {
        "AuxIVA-IPA": (N_ITER_IPA_RATE, N_ITER_IPA_PLAIN_RATE),
        "GaussILRMA-IPA": (N_ITER_IPA_RATE, N_ITER_IPA_PLAIN_RATE),
        **{label: (n, n) for label, n in N_ITER_FREE_RATE.items()},
        "PDSIVA": (N_ITER, N_ITER_PROX_PLAIN_RATE),
        "HVA": (N_ITER, N_ITER_PROX_PLAIN_RATE),
        "ADMMIVA": (N_ITER, N_ITER_PROX_PLAIN_RATE),
        "GaussMNMF-dense": (N_ITER, N_ITER_MNMF_PLAIN_RATE),
        "GaussMNMF-dense eigh": (N_ITER_MNMF_EIGH_RATE, N_ITER_MNMF_EIGH_RATE),
        "GaussIPSDTA": (N_ITER_IPSDTA, N_ITER_IPSDTA_PLAIN_RATE),
        "TIPSDTA": (N_ITER_IPSDTA, N_ITER_IPSDTA_PLAIN_RATE),
        "cACGMM": (N_ITER, N_ITER_CACGMM_PLAIN_RATE),
        "cACGMM K1 covariance": (N_ITER, N_ITER_CACGMM_PLAIN_RATE),
        "FastIVA": (N_ITER, N_ITER_FIXED_POINT_PLAIN_RATE),
        "FasterIVA": (N_ITER, N_ITER_FIXED_POINT_PLAIN_RATE),
        **{label: (N_ITER_PAIRWISE_RATE, N_ITER_PAIRWISE_RATE) for label in (
            "AuxIVA-IP2", "AuxIVA-ISS2", "GaussILRMA-IP2", "GaussILRMA-ISS2", "FastGaussMNMF-IP2 4ch", "AuxFDICA-IP2")},
    }
    rates = {}
    for label, (step, state) in steps.items():
        n_kernel, n_plain = n_steps.get(label, (N_ITER, N_ITER))
        with plain_versions():
            plain_a = iterations_per_s(step, state, n_plain)
        kernel_a, kernel_b = iterations_per_s(step, state, n_kernel), iterations_per_s(step, state, n_kernel)
        with plain_versions():
            plain_b = iterations_per_s(step, state, n_plain)
        rates[label] = statistics.mean((kernel_a, kernel_b))
        say("time", path=repr(f"{label}{'' if label.endswith('ch') else ' 8ch'} 10s, {n_kernel} chained fast-path steps"),
            card=repr(card),
            kernels_iters_per_s=(kernel_a, kernel_b), plain_iters_per_s=(plain_a, plain_b), plain_steps=n_plain)

    # the VCD sweeps of one IPSDTA iteration alone (PyTorch operations, no
    laps("6 profiles")
    # kernel of the port): their device time, read as a share of the step's
    sweep_inputs = []
    with recording(ipsdta_steps, "vcd_sweep", lambda W_p, RXX_p, **kwargs: sweep_inputs.append((W_p, RXX_p))):
        steps["GaussIPSDTA"][0](steps["GaussIPSDTA"][1])
    check(len(sweep_inputs) == len(ipsdta_shapes), f"recorded {len(sweep_inputs)} VCD sweeps")

    def sweeps_only(s):
        for W_p, RXX_p in sweep_inputs:
            ipsdta_steps.vcd_sweep(W_p, RXX_p, eps=IPSDTA_EPS)
        return s

    sweep_per_kernel, sweep_ops, sweep_seen, sweep_made, _, _ = profile(sweeps_only, None, 10)
    sweep_us = sum(sweep_per_kernel.values())

    # where the device time of one iteration goes (torch.profiler)
    for label, (step, state) in steps.items():
        start = time.perf_counter()
        n_profiled = min(N_ITER_PROFILE, n_steps.get(label, (N_ITER,))[0])
        per_kernel, ops_per_iter, seen, made, sessions, uneven = profile(step, state, n_profiled)
        profile_seconds = f"{time.perf_counter() - start:.1f}"
        device_us = sum(per_kernel.values())
        if not device_us:
            # the rate above already timed these steps with CUDA events, idle gaps included
            say("profile", path=repr(label), card=repr(card), sessions=sessions,
                device_us_per_iter="not measured: every profiler session came back without a device event",
                cuda_event_us_per_iter=1e6 / rates[label])
            continue
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        # the share of each hand-written kernel (their names end in _kernel, as in csrc/*.cu)
        shares = {name: sum(us for kernel, us in per_kernel.items() if f"{name}_kernel" in kernel) / device_us
                  for name in KERNELS}
        extra = {}
        if label in ("GaussIPSDTA", "TIPSDTA") and sweep_us:
            extra = dict(vcd_sweep_us_per_iter=sweep_us, vcd_sweep_ops_per_iter=sweep_ops,
                         vcd_sweep_share=sweep_us / device_us, vcd_sweep_events=f"{sweep_seen}/{sweep_made}")
        # the same without rounding up the names whose events do not divide by the steps: the least it can be
        seen_us = device_us - sum(per_kernel[name] - us for name, (_, _, us) in uneven.items())
        say("profile", path=repr(label), card=repr(card), sessions=sessions, seconds=profile_seconds,
            profiler_events=f"{seen}/{made}",
            device_us_per_iter=device_us, device_us_seen_per_iter=seen_us, uneven_names=len(uneven),
            uneven=repr([(name[:40], f"{events}/{steps}") for name, (events, steps, _) in
                         sorted(uneven.items(), key=lambda kv: -kv[1][2])[:4]]),
            device_ops_per_iter=ops_per_iter, device_busy_share=device_us * 1e-6 * rates[label],
            kernel_shares=repr({name: round(share, 4) for name, share in shares.items() if share}),
            top=repr([(name[:48], round(us, 3)) for name, us in top]), **extra)

    laps("done")
    say("done", card=repr(card), seconds=f"{time.perf_counter() - started:.1f}")
    summary = [
        {
            "name": name,
            "route": "cuda",
            "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": totals[name],
            "max_abs_err": errors[name],
            **timings[name],
        }
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
