"""FastGaussMNMF (jointly diagonalized spatial model) on native complex tensors: the iteration, its loss and the Wiener filter.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``fast_gauss_mnmf_step_sc``
(:2389-2475) and ``fast_gauss_mnmf_loss_sc`` (:4334-4351), and of the
Wiener filter of ``ssspy_tpu/fast.py:752-767`` (parity:
ssspy/bss/mnmf.py:1076-1675). Each source's spatial covariance is
``R_n = Q^-1 diag(Lamb_n d_n) Q^-H`` with one diagonalizer ``Q (I, M, M)``
per bin, NMF powers ``Lamb_n = T_n V_n`` and diagonal loadings
``D (I, N, M)``. Apart from the projection ``QX`` (one complex ``Q @ X``
per bin) and the diagonalizer's IP1 sweep or IP2 pair updates, the
iteration is real arithmetic on the powers ``|QX|^2``.

The diagonalizer update is the per-channel weighted covariance with
weights ``1 / (Lamb D)`` of shape ``(M, I, T)`` and the IP1 sweep, through
the routers :func:`~ssspy_tpu_torch.ops.iva_steps.covariance` (K1) and
:func:`~ssspy_tpu_torch.ops.iva_steps.ip1_update` (K1b): the kernels in
complex64, their plain versions in complex128 and past the kernels' sizes.
The IP2 diagonalizer takes the same covariances (K1 once) and runs
:func:`~ssspy_tpu_torch.ops.iva_steps.ip2_update`'s pair updates over a
``pair_selector`` (M sequential pairs by default) instead of K1b.

The step with the IP1 diagonalizer also takes a batch of utterances on a
leading axis (``X (B, M, I, T)``, ``Q (B, I, M, M)``, ``T (B, N, I, K)``,
``V (B, N, K, T)``, ``D (B, I, N, M)``) and ``bin_sum``, as the
multi-device runners of :mod:`ssspy_tpu_torch.parallel` call it: K1 once
per utterance, K1b folded into the bins, and two calls of the hook for all
utterances, the activation update's numerator and denominator and the
power normalization's sum over the bins.

A ``flooring_fn`` that is not ``max(., eps)`` replaces ``max(., eps)``
where the JAX complex class floors with its callable
(ssspy_tpu/bss/mnmf.py:699-746): the basis and activation updates, the
diagonalizer's IP1 sweep or IP2 pairs (the plain sweep, as
:func:`~ssspy_tpu_torch.ops.iva_steps.ip1_update` routes a callable) and
the power normalization; the model's floor ``max(Lamb D, eps)``, which that
class does not take, stays.
"""

from typing import Callable, Optional, Tuple

import torch

from ..special.flooring import floor
from ..special.psd import to_psd
from .iva_steps import clogabsdet, covariance, ip1_update, ip2_update

__all__ = ["DIAGONALIZERS", "fast_gauss_mnmf_step", "fast_gauss_mnmf_loss", "fast_mnmf_separate"]

DIAGONALIZERS = ("IP", "IP1", "IP2")


def check_diagonalizer(diagonalizer: str) -> None:
    """Raise for an unknown diagonalizer update."""
    if diagonalizer not in DIAGONALIZERS:
        raise ValueError(f"unsupported option: {diagonalizer}.")


def _powers(Xb: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """``|QX|^2`` as ``(..., I, T, M)``, ``Xb`` the mixture as ``(..., I, M, T)``."""
    QX = Q @ Xb
    return (QX.real**2 + QX.imag**2).transpose(-2, -1)


def _model(T, V, D, eps):
    """``(Lamb (N, I, T), LambD (I, T, M))``: the NMF powers and ``sum_n Lamb_n d_n``, each floored at ``eps``."""
    Lamb = torch.clamp(T @ V, min=eps)
    return Lamb, torch.clamp(torch.einsum("...nit,...inm->...itm", Lamb, D), min=eps)


def _mm_terms(QX2, LambD, Db):
    """``(sum_m d QX2 / LambD^2, sum_m d / LambD)``, each ``(N, I, T)``: the numerator and denominator of the NMF MM updates."""
    return (torch.einsum("...nim,...itm->...nit", Db, QX2 / LambD**2),
            torch.einsum("...nim,...itm->...nit", Db, 1 / LambD))


def fast_gauss_mnmf_step(
    X: torch.Tensor,
    Q: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    D: torch.Tensor,
    eps: float = 1e-6,
    normalization: bool = True,
    diagonalizer: str = "IP1",
    pair_selector=None,
    bin_sum=None,
    flooring_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One FastGaussMNMF iteration; returns ``(Q, T, V, D)``.

    ``X``: mixture ``(M, I, T)``; ``Q``: diagonalizer ``(I, M, M)``; ``T``:
    basis ``(N, I, K)``; ``V``: activation ``(N, K, T)``; ``D``: loadings
    ``(I, N, M)``, real. The basis, then the activation MM update
    (``max(., eps)``, the denominator floored at 1e-30 so that a silent bin
    gives no 0/0), the diagonalizer's IP1 sweep (``"IP"``, ``"IP1"``) or IP2
    pair updates over ``pair_selector``'s pairs (``"IP2"``) on the
    per-channel weighted covariances ``mean_t x x^H / max(Lamb D, eps)``,
    the loadings' MM update and, with ``normalization``, the power
    normalization of ``Q`` and ``D`` by ``psi_m = max(sqrt(mean |QX_m|^2), eps)``.
    Batched (IP1) and ``bin_sum`` as the module describes; with ``bin_sum``
    the mean is over the bins of the whole group, padded ones included, as
    the JAX runner takes it (parallel/__init__.py:732-736). ``flooring_fn``
    as the module describes.
    """
    check_diagonalizer(diagonalizer)
    if diagonalizer == "IP2" and X.dim() != 3:
        raise ValueError("the IP2 diagonalizer takes one utterance")
    Xb = X.transpose(-3, -2)  # (I, M, T)
    Db = D.transpose(-3, -2)  # (N, I, M)

    QX2 = _powers(Xb, Q)
    _, LambD = _model(T, V, D, eps)
    num, denom = _mm_terms(QX2, LambD, Db)
    T = floor(T * torch.sqrt(torch.einsum("...nkt,...nit->...nik", V, num) / torch.clamp(
        torch.einsum("...nkt,...nit->...nik", V, denom), min=1e-30)), eps, flooring_fn)

    _, LambD = _model(T, V, D, eps)
    num, denom = _mm_terms(QX2, LambD, Db)
    num, denom = torch.einsum("...nik,...nit->...nkt", T, num), torch.einsum("...nik,...nit->...nkt", T, denom)
    if bin_sum is not None:
        num, denom = bin_sum(num, denom)
    V = floor(V * torch.sqrt(num / torch.clamp(denom, min=1e-30)), eps, flooring_fn)

    Lamb = torch.clamp(T @ V, min=eps)
    varphi = 1 / torch.clamp(torch.einsum("...nit,...inm->...mit", Lamb, D), min=eps)  # (M, I, T)
    U = covariance(X, varphi)
    if diagonalizer == "IP2":
        Q = ip2_update(Q, U, eps=eps, pair_selector=pair_selector, flooring_fn=flooring_fn)
    else:
        Q = ip1_update(Q, U, eps=eps, flooring_fn=flooring_fn)

    QX2 = _powers(Xb, Q)
    Lamb, LambD = _model(T, V, D, eps)
    Lambb = Lamb.transpose(-3, -2)  # (I, N, T)
    num = torch.einsum("...int,...itm->...inm", Lambb, QX2 / LambD**2)
    denom = torch.einsum("...int,...itm->...inm", Lambb, 1 / LambD)
    D = torch.sqrt(num / denom) * D

    if normalization:
        QX2 = _powers(Xb, Q)
        if bin_sum is None:
            mean = torch.mean(QX2, dim=(-3, -2))  # (M,)
        else:
            (total,) = bin_sum(QX2.sum(dim=(-3, -2)))
            mean = total / (QX2.shape[-3] * bin_sum.shards * QX2.shape[-2])
        psi = floor(torch.sqrt(mean), eps, flooring_fn)
        Q = Q / psi[..., None, :, None]
        D = D / (psi**2)[..., None, None, :]
    return Q, T, V, D


def fast_gauss_mnmf_loss(X, Q, T, V, D, eps: float = 1e-6) -> torch.Tensor:
    """FastGaussMNMF negative log-likelihood, a 0-dim tensor on the input's device.

    ``sum_i [mean_t sum_m (|QX|^2 / LambD + log LambD) - 2 log|det Q_i|]``
    with ``LambD`` floored at ``eps``.
    """
    _, LambD = _model(T, V, D, eps)
    value = torch.sum(_powers(X.transpose(0, 1), Q) / LambD + torch.log(LambD), dim=-1)  # (I, T)
    return torch.sum(torch.mean(value, dim=-1) - 2 * clogabsdet(Q))


def fast_mnmf_separate(
    X, T, V, Q, D, reference_id: int = 0, eps: float = 1e-10, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """The multichannel Wiener filter in the diagonalized space, at ``reference_id``: ``(N, I, T)``.

    ``Q^-1`` by ``inv_ex``; ``R_n = Q^-1 diag(Lamb_n d_n) Q^-H`` with
    ``Lamb`` floored at ``eps``; ``W_n = R^-1 R_n`` by ``solve_ex``; the
    reference row of ``W_n^H`` applied to ``X``. On the input's device.
    ``flooring_fn`` (not ``max(., eps)``) first projects ``R`` with it, as
    the JAX complex class does (``to_psd``, ssspy_tpu/bss/mnmf.py:682).
    """
    Lamb = torch.clamp(T @ V, min=eps)  # (N, I, T)
    Q_inv = torch.linalg.inv_ex(Q)[0]  # (I, M, M)
    LambD = torch.einsum("nit,nim->nitm", Lamb, D.transpose(0, 1)).to(X.dtype)
    R_n = torch.einsum("ipm,nitm,iqm->nitpq", Q_inv, LambD, Q_inv.conj())
    R = R_n.sum(dim=0)
    if flooring_fn is not None:
        R = to_psd(R, flooring_fn)
    W = torch.linalg.solve_ex(R[None], R_n)[0]
    W_ref = W.transpose(-2, -1).conj()[..., reference_id, :]  # (N, I, T, M)
    return torch.einsum("nitm,mit->nit", W_ref, X)
