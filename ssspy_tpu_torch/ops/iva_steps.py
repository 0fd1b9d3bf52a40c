"""The AuxIVA-IP1, AuxIVA-ISS1 and AuxIVA-IPA iterations and their loss on native complex tensors.

Counterparts of the split-complex functions in ``ssspy_tpu/ops/splitc.py``;
the port carries complex tensors, so the ``[real, imag]`` planes and the
``_sc`` suffix are gone. The kernels are looked up on
:mod:`ssspy_tpu_torch.ops.kernels` at each call.

Three of them are reached only through a router of this module, which
chooses by dtype and shape before any launch, on every device alike:
:func:`covariance` (K1), :func:`ip1_update` (K1b) and :func:`iss1_update`
(K2). complex64 within the kernel's sizes goes to the kernel wrapper (the
kernel on the card, its plain version on the CPU); complex128, and any
size the kernel does not take, goes to the plain version on the same
device. No kernel failure is caught: a wrapper still refuses what its
kernel does not take, and only the routers decide.
"""

from typing import Optional

import torch

from . import kernels

__all__ = [
    "covariance",
    "ip1_update",
    "iss1_update",
    "separate",
    "auxiva_ip1_step",
    "auxiva_iss1_step",
    "auxiva_ipa_step",
    "clogabsdet",
    "ls_demix",
    "iva_laplace_loss",
]


def separate(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Per-bin demixing ``y_i = W_i x_i``: ``(I,N,M) x (M,I,T) -> (N,I,T)``.

    Counterpart of ``splitc._csep`` (splitc.py:242-253). The einsum is a
    product batched over bins, whose ``(N, I, T)`` view is permuted; the
    copy makes it contiguous, as the ISS1 kernel takes it.
    """
    return torch.einsum("inm,mit->nit", W, X).contiguous()


def covariance(X: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """``U[i,n] = mean_t varphi[n,(i),t] x_it x_it^H``, ``(I, N, M, M)``, routed by dtype and shape.

    K1 (:func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance`) for
    complex64 ``X`` with float32 weights within
    :func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance_takes` (``N M
    (M + 1) / 2 <= 8,192``); the einsum
    (:func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance_plain`)
    otherwise, as the JAX package falls back by shape
    (pallas_kernels.py:167-177).
    """
    if (
        X.dtype == torch.complex64
        and varphi.dtype == torch.float32
        and kernels.weighted_covariance_takes(X.shape[0], varphi.shape[0])
    ):
        return kernels.weighted_covariance(X.contiguous(), varphi.contiguous())
    return kernels.weighted_covariance_plain(X, varphi)


def ip1_update(W: torch.Tensor, U: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """The sequential IP1 sweep of ``W (I, N, M)`` over ``U (I, N, M, M)``, routed by dtype and shape.

    K1b (:func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep`) for complex64 with
    ``N = M <= 17`` (:func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep_takes`);
    :func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep_plain` with its ``"lu"``
    solve (``solve_ex``) otherwise, the route the CPU classes meet the
    fixtures with.
    """
    n_sources, n_channels = W.shape[-2:]
    if (
        W.dtype == U.dtype == torch.complex64
        and n_sources == n_channels
        and kernels.ip1_sweep_takes(n_channels)
    ):
        return kernels.ip1_sweep(W.contiguous(), U.contiguous(), eps=eps)
    return kernels.ip1_sweep_plain(W, U, eps=eps)


def iss1_update(Y: torch.Tensor, varphi: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """The sequential ISS1 sweep of ``Y (N, I, T)`` with weights ``(N, T)`` or ``(N, I, T)``, routed by dtype and shape.

    K2 (:func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep`) for complex64 ``Y``
    with float32 weights and ``N <= 16``
    (:func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep_takes`);
    :func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep_plain` otherwise.
    """
    if (
        Y.dtype == torch.complex64
        and varphi.dtype == torch.float32
        and kernels.iss1_sweep_takes(Y.shape[0])
    ):
        return kernels.iss1_sweep(Y.contiguous(), varphi.contiguous(), eps=eps)
    return kernels.iss1_sweep_plain(Y, varphi, eps=eps)


def _laplace_varphi(Y: torch.Tensor, eps: float) -> torch.Tensor:
    """Laplace weight ``1 / max(||y_n(., t)||, eps)`` with the norm over bins: ``(N, T)``."""
    return 1.0 / torch.clamp(torch.linalg.vector_norm(Y, dim=1), min=eps)


def auxiva_ip1_step(X: torch.Tensor, W: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """One AuxIVA-IP1 iteration; returns the new demixing filters.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``.
    Laplace weight ``phi = 1 / max(||y_n||, eps)`` with the norm over bins,
    the weighted covariance, then the IP1 sweep. Counterpart of
    ``splitc.auxiva_ip1_step_sc`` (splitc.py:256-278).
    """
    return ip1_update(W, covariance(X, _laplace_varphi(separate(X, W), eps)), eps=eps)


def auxiva_iss1_step(Y: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """One AuxIVA-ISS1 iteration on the separated spectrograms ``(N, I, T)``.

    ISS carries no demixing matrix: the Laplace weight ``(N, T)``, then the
    ISS1 sweep. Counterpart of ``splitc.auxiva_iss1_step_sc``
    (splitc.py:401-411).
    """
    return iss1_update(Y, _laplace_varphi(Y, eps), eps=eps)


def auxiva_ipa_step(
    Y: torch.Tensor, eps: float = 1e-10, lqpqm_normalization: bool = True, newton_iter: int = 1
) -> torch.Tensor:
    """One AuxIVA-IPA iteration on the separated spectrograms ``(N, I, T)``.

    Demix-free, as ISS: the Laplace weight ``(N, T)``, then the IPA sweep
    (:func:`ssspy_tpu_torch.ops.ipa_steps.ipa_sweep`: the congruence sweep
    in complex64, the reference's data flow in complex128). Counterpart of
    ``splitc.auxiva_ipa_step_sc`` (splitc.py:2235-2264).
    """
    from .ipa_steps import ipa_sweep  # ipa_steps imports prox_steps, which imports this module

    return ipa_sweep(
        Y, _laplace_varphi(Y, eps), eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter
    )


def clogabsdet(W: torch.Tensor) -> torch.Tensor:
    """``log|det W|`` of batched complex square matrices ``(..., N, N) -> (...)``.

    Counterpart of ``splitc.clogabsdet_sc`` (splitc.py:4148-4167). That
    one squares W into its Gram matrix (about 1e-3 relative in f32) because
    the TPU path has no complex LU; here the LU of ``slogdet`` runs on W
    itself.
    """
    return torch.linalg.slogdet(W)[1]


def ls_demix(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Least-squares demixing filter ``W = Y X^H (X X^H)^{-1}`` per bin: ``(I, N, M)``.

    Recovers the implicit demixing matrix of a demix-free (ISS) state.
    Counterpart of ``splitc.ls_demix_sc`` (splitc.py:4170-4187); the
    inverse is ``inv_ex``, so a singular bin gives non-finite values
    instead of an exception.
    """
    Xb = X.transpose(0, 1)  # (I, M, T)
    XH = Xb.transpose(-2, -1).conj()
    return Y.transpose(0, 1) @ XH @ torch.linalg.inv_ex(Xb @ XH)[0]


def iva_laplace_loss(
    X: torch.Tensor, W: Optional[torch.Tensor] = None, Y: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """AuxLaplaceIVA negative log-likelihood, a 0-dim tensor on the input's device.

    ``sum_n mean_t 2 ||y_n(., t)|| - 2 sum_i log|det W_i|``. Pass ``W`` for
    the demix-filter state (IP) or ``Y`` for the demix-free state (ISS),
    whose ``W`` is recovered by :func:`ls_demix`. Counterpart of
    ``splitc.iva_laplace_loss_sc`` (splitc.py:4190-4207).
    """
    if W is not None:
        Y = separate(X, W)
    else:
        W = ls_demix(Y, X)
    G = 2 * torch.linalg.vector_norm(Y, dim=1)  # (N, T)
    return G.mean(dim=-1).sum() - 2 * clogabsdet(W).sum()
