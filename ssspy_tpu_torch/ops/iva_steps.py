"""The AuxIVA-IP1 iteration and its loss on native complex tensors.

Counterparts of the split-complex functions in ``ssspy_tpu/ops/splitc.py``;
the port carries complex tensors, so the ``[real, imag]`` planes and the
``_sc`` suffix are gone.
"""

import torch

from .kernels import ip1_sweep, weighted_covariance

__all__ = ["separate", "auxiva_ip1_step", "clogabsdet", "iva_laplace_loss"]


def separate(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Per-bin demixing ``y_i = W_i x_i``: ``(I,N,M) x (M,I,T) -> (N,I,T)``.

    Counterpart of ``splitc._csep`` (splitc.py:242-253).
    """
    return torch.einsum("inm,mit->nit", W, X)


def auxiva_ip1_step(X: torch.Tensor, W: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """One AuxIVA-IP1 iteration; returns the new demixing filters.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``.
    Laplace weight ``phi = 1 / max(||y_n||, eps)`` with the norm over bins,
    the weighted covariance, then the IP1 sweep. Counterpart of
    ``splitc.auxiva_ip1_step_sc`` (splitc.py:256-278).
    """
    Y = separate(X, W)
    varphi = 1.0 / torch.clamp(torch.linalg.vector_norm(Y, dim=1), min=eps)  # (N, T)
    U = weighted_covariance(X, varphi)
    return ip1_sweep(W, U, eps=eps)


def clogabsdet(W: torch.Tensor) -> torch.Tensor:
    """``log|det W|`` of batched complex square matrices ``(..., N, N) -> (...)``.

    Counterpart of ``splitc.clogabsdet_sc`` (splitc.py:4148-4167). That
    one squares W into its Gram matrix (about 1e-3 relative in f32) because
    the TPU path has no complex LU; here the LU of ``slogdet`` runs on W
    itself.
    """
    return torch.linalg.slogdet(W)[1]


def iva_laplace_loss(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """AuxLaplaceIVA negative log-likelihood of the demixing filters ``W``.

    ``sum_n mean_t 2 ||y_n(., t)|| - 2 sum_i log|det W_i|``, a 0-dim tensor
    on the input's device. Counterpart of ``splitc.iva_laplace_loss_sc``
    with ``Ws`` (splitc.py:4190-4207).
    """
    G = 2 * torch.linalg.vector_norm(separate(X, W), dim=1)  # (N, T)
    return G.mean(dim=-1).sum() - 2 * clogabsdet(W).sum()
