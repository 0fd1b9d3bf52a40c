"""Principal component analysis rotation (parity: ssspy/transform/pca.py:4-96).

Counterpart of :mod:`ssspy_tpu.transform.pca`: one batched core for every
layout. The channel axis moves last, each slice's covariance over its
samples (or frames) is one einsum, and its eigh rotates the channels.
"""

import torch

from ..special.psd import eigh_in_batches
from ..utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["pca"]


def _channel_axis(input: torch.Tensor) -> int:
    """Which axis holds the channels, by the reference's layout rules."""
    if input.dim() == 2:
        if input.is_complex():
            raise ValueError("expected a real-valued array, got a complex one.")
        return 0
    if input.dim() == 3:
        return 0 if input.is_complex() else 1
    if input.dim() == 4:
        if not input.is_complex():
            raise ValueError("expected a complex-valued array, got a real one.")
        return 1
    raise ValueError(f"The dimension of input is expected 2, 3, or 4, but given {input.dim()}.")


def _on_device(input, device) -> torch.Tensor:
    """``input`` as a tensor on ``device`` (checked: the card unless the caller asks for the CPU)."""
    return torch.as_tensor(input, device=resolve_device(device))


def _covariance_eigh(X: torch.Tensor):
    """Eigh of the sample covariance of ``(*, n_samples, M)`` data: ``(lamb ascending, V)``."""
    cov = torch.einsum("...tm,...tn->...mn", X, X.conj()) / X.shape[-2]
    return eigh_in_batches(cov)


def pca(input, ascend: bool = True, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Rotate the channels onto their principal components.

    Layouts as in the reference: 2D real ``(M, T)``, 3D complex
    ``(M, I, T)``, 3D real ``(B, M, T)``, 4D complex ``(B, M, I, T)``.
    ``ascend=True`` puts the dominant component in the first channel. The
    eigenvectors' signs (phases) are the eigensolver's. ``device``: the
    card by default, ``"cpu"`` on the CPU.
    """
    input = _on_device(input, device)
    ch_axis = _channel_axis(input)
    X = torch.movedim(input, ch_axis, -1)  # (*, n_samples or frames, M)
    _, V = _covariance_eigh(X)
    if ascend:
        V = V.flip(-1)
    return torch.movedim(X @ V.conj(), -1, ch_axis)
