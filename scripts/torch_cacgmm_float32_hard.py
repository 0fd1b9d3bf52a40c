#!/usr/bin/env python3
"""How far float32 cACGMM lands from complex128 on the hard scenario, by the form of the E-step's quadratic form.

The hard tier of tests/test_hard_fidelity.py:252-283: the 4-source, 10 s
reverberant mixture (``hard_speech_mixture``), STFT 4096/1024, 50 EM
iterations of ``ssspy_tpu_torch.ops.cacgmm_steps`` from ``fast_cacgmm``'s
draws of ``default_rng(3)``, the posterior masks on channel 0 aligned by
``permutation_align``, scored by the best-permutation SI-SDR against the
source images. It runs the E-step's ``z^H B^-1 z`` two ways:

- ``eigen-sum``: the port's form, ``sum_k (p_k^T e)^2 / lamb_k`` over the
  embedded eigenpairs;
- ``inverse``: the JAX step's form (ssspy_tpu/ops/splitc.py:2518-2549), the
  floored inverse extracted from the embedding, then the quadratic form;

each in float32 with the unit-norm observations rounded from complex64
and from complex128 (one ulp apart), beside complex128, and the port's
form once more with the M-step's numerator on the weighted covariance
(``covariance_impl="kernel"``, K1 on the card). For the inverse
form it also counts the quadratic forms that come out at or below ``eps``
(and are floored there) in the E-steps of the run, and the largest
condition number of the floored ``B``. Prints one line per run and the
card's name and power limit where it runs on one.

    python3 scripts/torch_cacgmm_float32_hard.py --device cuda
"""

import argparse
import itertools
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssspy_tpu_torch.algorithm import permutation_align
from ssspy_tpu_torch.ops import cacgmm_steps
from ssspy_tpu_torch.ops.prox_steps import _extract, herm_eigh_embed
from ssspy_tpu_torch.transform import istft, stft
from ssspy_tpu_torch.utils.dataset import hard_speech_mixture

N_FFT, HOP, N_ITER, SEED = 4096, 1024, 50, 3
PIN_DB = -1.088889  # tests/fidelity_pins.json, hard_cacgmm


FLOORED = {"forms": 0, "most_in_one_step": 0, "condition": 0.0}


def inverse_form_estep(Z, alpha, B, eps=1e-10, impl="eigh"):
    """The JAX step's E-step: the floored inverse from the embedded eigh, then ``Re z^H B^-1 z``."""
    lamb2, P2 = herm_eigh_embed(B)
    lamb2 = torch.clamp(lamb2, min=eps)
    B_inv = _extract((P2 * (1 / lamb2)[..., None, :]) @ P2.transpose(-1, -2), B.shape[-1])
    Zb = Z.transpose(0, 1)
    ZBZ = (Zb.conj() * (B_inv @ Zb)).sum(dim=-2).real
    floored = int((ZBZ <= eps).sum())
    FLOORED["forms"] += floored
    FLOORED["most_in_one_step"] = max(FLOORED["most_in_one_step"], floored)
    FLOORED["condition"] = max(FLOORED["condition"], float((lamb2[..., -1] / lamb2[..., 0]).max()))
    ZBZ = torch.clamp(ZBZ, min=eps)
    log_gamma = (torch.log(alpha) - torch.log(lamb2).sum(dim=-1) / 2)[:, :, None] - Z.shape[0] * torch.log(ZBZ)
    return log_gamma, ZBZ


def separate(X, dtype, z_dtype, covariance_impl="einsum"):
    """``fast_cacgmm``'s EM in ``dtype`` with the observations normalized in ``z_dtype``, then its masks, aligned."""
    rng = np.random.default_rng(SEED)
    M, I, _ = X.shape
    Xz = X.to(z_dtype)
    Z = (Xz / torch.clamp(torch.linalg.vector_norm(Xz, dim=0), min=1e-10)).to(dtype)
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    alpha, B_diag = rng.random((M, I)), rng.random((M, I, M))
    alpha = torch.from_numpy(alpha / alpha.sum(axis=0)).to(device=X.device, dtype=real)
    B = torch.from_numpy((B_diag / B_diag.sum(axis=-1, keepdims=True))[..., None] * np.eye(M)).to(X.device, dtype)
    for _ in range(N_ITER):
        alpha, B = cacgmm_steps.step(Z, alpha, B, covariance_impl=covariance_impl)
    Y = cacgmm_steps.posterior(Z, alpha, B).to(dtype) * X[0].to(dtype)
    return permutation_align(Y.transpose(0, 1)).transpose(0, 1)


def quality(Y, images, length):
    y = istft(Y.to(torch.complex128), n_fft=N_FFT, hop_length=HOP, length=length, device=Y.device).cpu().numpy()
    refs = images[:, 0]

    def si_sdr(est, ref):
        ref = np.sum(est * ref) / np.sum(ref**2) * ref
        return 10 * np.log10(np.sum(ref**2) / np.sum((est - ref) ** 2))

    n = refs.shape[0]
    return max(np.mean([si_sdr(y[p[s]], refs[s]) for s in range(n)]) for p in itertools.permutations(range(n)))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda")
    device = torch.device(parser.parse_args().device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip()
        print(f"card: {card}", flush=True)
    images, _ = hard_speech_mixture()
    X = stft(images.sum(axis=0), n_fft=N_FFT, hop_length=HOP, device=device)  # complex128
    print(f"complex128: {quality(separate(X, torch.complex128, torch.complex128), images, images.shape[-1]):.6f} dB "
          f"(pin {PIN_DB})", flush=True)
    port_estep = cacgmm_steps.estep
    for form, estep in (("eigen-sum", port_estep), ("inverse", inverse_form_estep)):
        cacgmm_steps.estep = estep
        for z_dtype in (torch.complex64, torch.complex128):
            FLOORED.update(forms=0, most_in_one_step=0, condition=0.0)
            db = quality(separate(X, torch.complex64, z_dtype), images, images.shape[-1])
            extra = f", quadratic forms floored: {FLOORED}" if form == "inverse" else ""
            print(f"float32, {form} form, observations normalized in {z_dtype}: {db:.6f} dB{extra}", flush=True)
    cacgmm_steps.estep = port_estep
    db = quality(separate(X, torch.complex64, torch.complex64, covariance_impl="kernel"), images, images.shape[-1])
    print(f"float32, eigen-sum form, covariance_impl='kernel': {db:.6f} dB", flush=True)


if __name__ == "__main__":
    main()
