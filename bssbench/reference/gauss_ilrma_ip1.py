"""Plain GaussILRMA with IP1 and MM updates (Kitamura et al., 2016; tky823/ssspy ``GaussILRMA(spatial_algorithm="IP1")``), waveform to waveform.

The source model of source ``n`` is the NMF ``r_nit = sum_k t_nik v_nkt``,
domain ``p = 2``. From identity demixing filters and the basis ``T`` and
activation ``V`` that ``numpy.random.default_rng(draw_seed)`` draws (``T``
first, then ``V``, each ``rng.random(...)`` cast to float32, at ``(N, I, K)``
and ``(N, K, T)``), each iteration:

1. the MM basis update ``t <- max(t * sqrt(sum_t v |y|^2 / r^2 / sum_t v / r), eps)``,
   then the activation's, each with ``r = max(T V, eps)`` of the factors
   before it;
2. the weights ``phi_nit = 1 / max(T V, eps)`` and the weighted covariances;
3. one IP1 sweep;
4. power normalization: ``psi_n = max(sqrt(mean_it |y_nit|^2), eps)``, row
   ``n`` of ``W`` divided by ``psi_n`` and ``T_n`` by ``psi_n^2``.

After the last, projection back onto ``reference_id`` and the iSTFT.
"""

import numpy as np
import torch

from .common import (Precision, demix_flops, ip1_iteration_flops, ip1_sweep, project_back, spectrogram, transform_flops,
                     waveforms_of, weighted_covariance)


def draws(draw_seed: int, n_sources: int, n_bins: int, n_basis: int, n_frames: int):
    """The start of the NMF factors: ``(T0 (N, I, K), V0 (N, K, T))``, float32 ``numpy`` arrays."""
    rng = np.random.default_rng(draw_seed)
    T0 = rng.random((n_sources, n_bins, n_basis)).astype(np.float32)
    V0 = rng.random((n_sources, n_basis, n_frames)).astype(np.float32)
    return T0, V0


def separate(waveforms, config: dict, draw_seed: int, device, precision: str = "float64") -> torch.Tensor:
    """The separated waveforms of one recording ``(M, S)``: ``(N, S)`` on the CPU."""
    x = torch.as_tensor(waveforms)
    if x.dim() != 2:
        raise ValueError("the GaussILRMA reference takes one recording (M, S) a call")
    p = Precision(precision)
    eps = config["eps"]
    X = spectrogram(p, x, config, device)  # (I, M, T)
    n_bins, n_channels, n_frames = X.shape
    T0, V0 = draws(draw_seed, n_channels, n_bins, config["n_basis"], n_frames)
    T = torch.from_numpy(T0).to(device=X.device, dtype=p.real)
    V = torch.from_numpy(V0).to(device=X.device, dtype=p.real)
    W = torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(n_bins, -1, -1).clone()

    def model(T, V):
        return torch.clamp(p.matmul(T, V), min=eps)

    for _ in range(config["n_iter"]):
        Y = p.matmul(W, X)  # (I, N, T)
        Y2 = (Y.real.square() + Y.imag.square()).transpose(0, 1)  # (N, I, T)
        R = model(T, V)
        num, den = p.matmul(Y2 / R.square(), V.transpose(-2, -1)), p.matmul(1 / R, V.transpose(-2, -1))
        T = torch.clamp(torch.sqrt(num / den) * T, min=eps)
        R = model(T, V)
        num, den = p.matmul(T.transpose(-2, -1), Y2 / R.square()), p.matmul(T.transpose(-2, -1), 1 / R)
        V = torch.clamp(torch.sqrt(num / den) * V, min=eps)
        phi = 1 / model(T, V)  # (N, I, T)
        W = ip1_sweep(p, W, weighted_covariance(p, X, phi), eps)
        Y = p.matmul(W, X)
        psi = torch.clamp(torch.sqrt((Y.real.square() + Y.imag.square()).mean(dim=(0, 2))), min=eps)  # (N,)
        W = W / psi[:, None]
        T = T / psi[:, None, None].square()
    W = project_back(W, config["reference_id"])
    return waveforms_of(p.matmul(W, X), config, x.shape[-1]).cpu()


def call_flops(s: dict) -> float:
    """The operations one call of ``s["B"]`` recordings needs (``metrics/step_mfu.py``): per recording the
    transforms; each iteration the IP1 iteration's, the NMF products (``T V`` three times and the basis's and
    activation's numerators and denominators, ``14 N I K T``), and the power normalization's second demixing
    product and sums; the last demixing product. ``s``: ``Cell.shapes()``."""
    N, I, T = s["N"], s["I"], s["T"]
    per_iter = ip1_iteration_flops(s) + 14 * N * I * s["K"] * T + demix_flops(s) + 4 * N * I * T
    return s["B"] * (transform_flops(s) + s["n_iter"] * per_iter + demix_flops(s))
