"""Minimal-distortion-principle rescaling (parity: ssspy/algorithm/minimal_distortion_principle.py:6-43).

Counterpart of :func:`ssspy_tpu.algorithm.minimal_distortion_principle`.
"""

from typing import Optional

import torch

__all__ = ["minimal_distortion_principle"]


def minimal_distortion_principle(
    estimated: torch.Tensor,
    reference: torch.Tensor,
    reference_id: Optional[int] = 0,
) -> torch.Tensor:
    """MDP rescaling ``z = <Y, X_ref> / |Y|^2`` applied per (source, bin).

    ``estimated``: separated spectrograms ``(n_sources, n_bins, n_frames)``;
    ``reference``: mixture ``(n_channels, n_bins, n_frames)``.
    """
    Y = estimated
    X_conj = reference.conj()

    if reference_id is None:
        num = torch.sum(Y * X_conj[:, None, :, :], dim=-1, keepdim=True)
    else:
        num = torch.sum(Y * X_conj[reference_id], dim=-1, keepdim=True)

    denom = torch.sum(Y.real**2 + Y.imag**2, dim=-1, keepdim=True)
    Z = num / denom
    return Z.conj() * Y
