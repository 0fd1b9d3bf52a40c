#!/usr/bin/env python3
"""Dense GaussMNMF in float32 with and without a floor on H, against complex128.

Runs ``fast_gauss_mnmf_dense``'s iteration (``ops.mnmf_steps.gauss_mnmf_step``)
on the 8-channel synthetic mixture (STFT 512/256) or, with ``--mixture
hard``, on the hard scenario of tests/test_hard_fidelity.py:352-400 (4
formant pseudo-speech sources in rooms of RT60 0.35 s, 4 channels, the same
STFT), ``n_basis = 8``, from the fast path's draws of ``default_rng(0)``: once in complex128 (the reference
route) and once in complex64 for each way of keeping the new spatial
covariances definite that is given (in place of
``ops.mnmf_steps.spatial_projection``): an eigenvalue floor at each
``--eig-floor`` times the top eigenvalue (the step's own route at
``F32_SPATIAL_REL``), a ridge ``(eps + rel tr(H) / M) I`` at each
``--ridge``, and a Cholesky form ``L L^H`` whose pivots are floored at each
``--chol-floor`` times the largest diagonal entry. A value of 0 leaves only
the step's absolute ``eps``. Prints, per run, the iteration at which the state first turns
non-finite (or the iteration count), the loss every 10 iterations, and the
worst per-source SI-SDR of the Wiener output against the complex128 run.
Imports nothing of JAX.

    python3 scripts/torch_mnmf_float32_floor.py --duration 10 --device cuda --eig-floor 0 1e-6
    python3 scripts/torch_mnmf_float32_floor.py --duration 10 --device cuda --ridge 1e-5 --eig-floor 1e-5 1e-6 1e-7 --chol-floor 1e-6
    python3 scripts/torch_mnmf_float32_floor.py --mixture hard --device cuda --eig-floor 0 1e-7 1e-6 1e-5 --ridge 1e-5

On the card the complex128 run's eighs go through
``special.psd.spectral``, which hands cuSOLVER at most ``CUDA_EIGH_BATCH``
matrices per call.
"""

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ssspy_tpu_torch.ops import mnmf_steps
from ssspy_tpu_torch.ops.prox_steps import _extract, block_embed
from ssspy_tpu_torch.special.psd import hermitize
from ssspy_tpu_torch.transform import stft
from ssspy_tpu_torch.utils.dataset import HOP, N_FFT, hard_speech_mixture, make_mixture

N_BASIS = 8


def chol_form(G, eps, floor):
    """``L L^H + eps I`` from the real embedding of ``hermitize(G)``, each Cholesky pivot floored at ``floor`` times the largest diagonal entry."""
    E = block_embed(hermitize(G))
    E = (E + E.transpose(-1, -2)) / 2
    n = E.shape[-1]
    least = floor * E.diagonal(dim1=-2, dim2=-1).amax(dim=-1, keepdim=True)
    rows = torch.arange(n, device=E.device)
    cols = []
    for j in range(n):
        c = E[..., :, j]
        if j:
            L = torch.stack(cols, dim=-1)
            c = c - (L @ L[..., j, :, None])[..., 0]
        d = torch.sqrt(torch.maximum(c[..., j : j + 1], least))
        cols.append(torch.where(rows >= j, c / d, torch.zeros_like(c)))
    L = torch.stack(cols, dim=-1)
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    return _extract(L @ L.transpose(-1, -2), G.shape[-1]) + eps * eye


def relative_ridge(G, eps, rel):
    """``hermitize(G) + (eps + rel tr(G) / M) I``: the relative ridge the eigenvalue floor replaced, at ``rel = 1e-5``."""
    scale = eps + rel * G.diagonal(dim1=-2, dim2=-1).real.mean(dim=-1)
    return hermitize(G) + scale[..., None, None] * torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)


def projection(route, value):
    """The new spatial covariances' projection for one variant: ``("eigh" | "ridge" | "chol", value)``."""
    if route == "chol":
        return lambda G, eps, psd_impl: chol_form(G, eps, value)
    if route == "ridge":
        return lambda G, eps, psd_impl: relative_ridge(G, eps, value)
    return lambda G, eps, psd_impl: mnmf_steps.psd_project(G, eps, "eigh", rel=value)


def iterate(X, variant, n_iter):
    """``(Y or None, losses every 10 iterations, iterations done, seconds)``; ``variant=None``: the step as it is."""
    step_projection = mnmf_steps.spatial_projection
    if variant is not None:
        mnmf_steps.spatial_projection = projection(*variant)
    try:
        return _iterate(X, n_iter)
    finally:
        mnmf_steps.spatial_projection = step_projection


def _iterate(X, n_iter):
    M, I, T = X.shape
    rng = np.random.default_rng(0)
    real = X.real.dtype
    Tb, Vb = (
        torch.from_numpy(np.maximum(rng.random(shape), 1e-10)).to(X.device, real)
        for shape in ((M, I, N_BASIS), (M, N_BASIS, T))
    )
    H = (torch.eye(M, dtype=X.dtype, device=X.device) / M).expand(M, I, M, M).contiguous()
    XX = mnmf_steps.instant_covariance(X)
    losses, start = [], time.perf_counter()
    for it in range(1, n_iter + 1):
        Tb, Vb, H = mnmf_steps.gauss_mnmf_step(XX, Tb, Vb, H)
        if not bool(torch.isfinite(Tb).all()):
            return None, losses, it, time.perf_counter() - start
        if it % 10 == 0:
            losses.append(round(float(mnmf_steps.gauss_mnmf_loss(XX, Tb, Vb, H)), 3))
    return mnmf_steps.wiener_separate(X, Tb @ Vb, H), losses, n_iter, time.perf_counter() - start


def min_si_sdr(est, ref):
    est, ref = (a.to(torch.complex128).cpu().numpy() for a in (est, ref))
    worst = np.inf
    for e, r in zip(est, ref):
        e, r = e.ravel(), r.ravel()
        alpha = np.vdot(r, e) / np.vdot(r, r)
        worst = min(worst, 10 * np.log10(np.abs(np.vdot(alpha * r, alpha * r)) / np.abs(np.vdot(e - alpha * r, e - alpha * r))))
    return float(worst)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mixture", choices=("synthetic", "hard"), default="synthetic",
                        help="the 8-channel synthetic mixture, or the 4-channel hard scenario (10 s)")
    parser.add_argument("--duration", type=float, default=10.0, help="seconds of the 16 kHz synthetic mixture")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--iterations", type=int, default=100)
    parser.add_argument("--eig-floor", type=float, nargs="*", default=[0.0, mnmf_steps.F32_SPATIAL_REL])
    parser.add_argument("--ridge", type=float, nargs="*", default=[])
    parser.add_argument("--chol-floor", type=float, nargs="*", default=[])
    args = parser.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip()
        print(f"card: {card}", flush=True)
    if args.mixture == "hard":
        wave = torch.from_numpy(hard_speech_mixture()[0].sum(axis=0)).to(device)
    else:
        wave = torch.from_numpy(make_mixture(seed=0, duration_s=args.duration)).to(device)
    X = stft(wave, n_fft=N_FFT, hop_length=HOP, device=device)
    print(f"mixture {args.mixture}: X {tuple(X.shape)} on {device}", flush=True)
    Y_ref, losses, done, seconds = iterate(X, None, args.iterations)
    print(f"complex128: iterations={done} losses={losses} seconds={seconds:.2f}", flush=True)
    variants = ([("eigh", v) for v in args.eig_floor] + [("ridge", v) for v in args.ridge]
                + [("chol", v) for v in args.chol_floor])
    names = {"ridge": "ridge", "eigh": "eig_floor", "chol": "chol_floor"}
    for route, value in variants:
        Y, losses, done, seconds = iterate(X.to(torch.complex64), (route, value), args.iterations)
        sdr = None if Y is None or Y_ref is None else min_si_sdr(Y, Y_ref)
        print(f"complex64 {names[route]}={value}: iterations={done} finite={Y is not None} losses={losses} "
              f"min_si_sdr_db_vs_complex128={sdr} seconds={seconds:.2f}", flush=True)


if __name__ == "__main__":
    main()
