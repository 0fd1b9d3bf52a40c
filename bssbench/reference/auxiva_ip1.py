"""Plain AuxLaplaceIVA with IP1 (Ono, 2011; tky823/ssspy ``AuxLaplaceIVA(spatial_algorithm="IP1")``), waveform to waveform.

From identity demixing filters, each iteration takes the Laplace weight
``phi_nt = 1 / max(||y_n(., t)||, eps)`` (the norm over the bins), the
weighted covariances ``U_in = mean_t phi_nt x_it x_it^H`` and one IP1 sweep;
after the last, projection back onto ``reference_id`` and the iSTFT.
"""

import torch

from .common import (Precision, demix_flops, ip1_iteration_flops, ip1_sweep, project_back, spectrogram, transform_flops,
                     waveforms_of, weighted_covariance)


def separate(waveforms, config: dict, draw_seed: int, device, precision: str = "float64", block: int = 4) -> torch.Tensor:
    """The separated waveforms of ``waveforms`` (``(M, S)`` or ``(B, M, S)``): ``(N, S)`` or ``(B, N, S)`` on the CPU.

    Utterances of a batch run ``block`` at a time. ``draw_seed`` is unused:
    IVA draws nothing.
    """
    x = torch.as_tensor(waveforms)
    if x.dim() == 2:
        return separate(x[None], config, draw_seed, device, precision, block)[0]
    return torch.cat([_separate(x[b:b + block], config, device, Precision(precision)) for b in range(0, x.shape[0], block)])


def _separate(x: torch.Tensor, config: dict, device, p: Precision) -> torch.Tensor:
    eps = config["eps"]
    X = spectrogram(p, x, config, device)  # (B, I, M, T)
    n_channels = X.shape[-2]
    W = torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(X.shape[:-2] + (n_channels, n_channels)).clone()
    for _ in range(config["n_iter"]):
        Y = p.matmul(W, X)  # (B, I, N, T)
        phi = 1.0 / torch.clamp(torch.sqrt((Y.real.square() + Y.imag.square()).sum(dim=-3)), min=eps)  # (B, N, T)
        W = ip1_sweep(p, W, weighted_covariance(p, X, phi), eps)
    W = project_back(W, config["reference_id"])
    return waveforms_of(p.matmul(W, X), config, x.shape[-1]).cpu()


def call_flops(s: dict) -> float:
    """The operations one call of ``s["B"]`` recordings needs (``metrics/step_mfu.py``): per recording the
    transforms, ``n_iter`` IP1 iterations and the last demixing product. ``s``: ``Cell.shapes()``."""
    return s["B"] * (transform_flops(s) + s["n_iter"] * ip1_iteration_flops(s) + demix_flops(s))
