"""cACGMM (EM over unit-norm observation vectors) on native complex tensors: the E-step, the posterior, the EM step and the loss.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``_cacgmm_estep_sc``,
``cacgmm_posterior_sc``, ``cacgmm_step_sc`` and ``cacgmm_loss_sc``
(:2481-2662; parity: ssspy/bss/cacgmm.py:603-705). ``Z``: unit-normalized
observations ``(M, I, T)``; ``alpha``: mixing weights ``(N, I)``, real;
``B``: Hermitian covariances ``(N, I, M, M)``. ``N`` may exceed ``M``.

Two routes for the E-step's inverse and log-determinant (``impl``):

- ``"eigh"`` (the default on every device): one eigh of the real
  ``2M x 2M`` embedding of each ``B`` through
  :func:`~ssspy_tpu_torch.ops.prox_steps.herm_eigh_embed` serves the
  log-determinant and the quadratic form with the eigenvalues floored at
  ``eps``, and the M-step's PSD projection is the same embedded eigh: the
  Jacobi kernel K7 in complex64 up to 16 channels (``B = N I`` matrices of
  ``2M x 2M``), and ``torch.linalg.eigh`` in batches in complex128 and
  above that (:func:`~ssspy_tpu_torch.ops.prox_steps.symm_eigh`). One
  departure from the JAX step: the quadratic form is the sum of squared
  projections ``sum_k (p_k^T e)^2 / lamb_k`` of ``e = [Re z; Im z]`` over
  the embedded eigenpairs, where the JAX step forms the floored inverse and then
  ``z^H B^-1 z``. The two are equal in exact arithmetic, but once some
  eigenvalues of ``B`` sit at the ``eps`` floor (conditions of 1e10) the
  inverse's products cancel, and in float32 some forms come out at or
  below zero, are floored at ``eps`` and hand their frame's posterior to
  one source; the sum has only non-negative terms. On the hard scenario of
  tests/test_hard_fidelity.py (4 sources, 50 iterations) the inverse's form
  lands anywhere from -0.88 to -1.12 dB as one ulp of the input moves, and
  the sum within 0.001 dB of complex128's -1.0889
  (scripts/torch_cacgmm_float32_hard.py; PERF.md, section 6).
- ``"chol"`` (the JAX package's TPU default): the log-determinant from the
  unrolled Cholesky of the embedding
  (:func:`~ssspy_tpu_torch.linalg.eig_free.chol_piv`), its diagonal
  clamped at 1e-20 before the log, the inverse by ``inv_ex``; the M-step
  hermitizes and adds the relative ridge ``(eps + rel mean diag B) I``
  (``rel`` 1e-6 in float32, 1e-12 in float64), which keeps ``B`` positive
  definite for the next Cholesky.

The M-step numerator (``covariance_impl``) is ``"einsum"`` by default, the
sum over frames divided by the posterior sum, in the JAX step's order; or
``"kernel"``: the weighted covariance with per-bin weights ``G = gamma /
z^H B^-1 z`` through :func:`~ssspy_tpu_torch.ops.iva_steps.covariance` (K1
in complex64), a mean over frames divided by ``alpha``. Both float32
guards of the JAX step are kept: ``z^H B^-1 z`` and the posterior sum are
floored at ``eps`` (a dead component's posterior underflows to exactly 0
in float32). Every contraction runs in full precision (the card's TF32 is
left off; reduced precision derails the EM, splitc.py:2536-2542).

A ``flooring_fn`` that is not ``max(., eps)`` replaces ``max(., eps)``
where the JAX complex class floors with its callable: the quadratic form
``flooring_fn(max(z^H B^-1 z, 0))`` (ssspy_tpu/bss/cacgmm.py:222) and the
M-step's projection (``to_psd``, :350), which then takes the eigenvalue
floor under either ``impl``. The other floors at ``eps`` stay.
"""

from typing import Callable, Optional, Tuple

import torch

from ..linalg.eig_free import chol_piv
from ..special.flooring import floor
from ..special.psd import hermitize
from .iva_steps import covariance
from .prox_steps import _extract, _symmetrised, block_embed, herm_eigh_embed

__all__ = ["IMPLS", "COVARIANCE_IMPLS", "estep", "posterior", "step", "loss"]

IMPLS = ("eigh", "chol")
COVARIANCE_IMPLS = ("einsum", "kernel")


def _check(impl: str, covariance_impl: str = "einsum") -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if covariance_impl not in COVARIANCE_IMPLS:
        raise ValueError(f"unknown covariance_impl {covariance_impl!r}; expected one of {COVARIANCE_IMPLS}")


def estep(
    Z: torch.Tensor,
    alpha: torch.Tensor,
    B: torch.Tensor,
    eps: float = 1e-10,
    impl: str = "eigh",
    flooring_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(log_gamma, ZBZ)``, each ``(N, I, T)``: ``log alpha - logdet B - M log max(z^H B^-1 z, eps)`` and the quadratic form.

    ``splitc._cacgmm_estep_sc`` (splitc.py:2481-2551); ``impl`` and
    ``flooring_fn`` as the module describes.
    """
    _check(impl)
    n_channels = Z.shape[0]
    Zb = Z.transpose(0, 1)  # (I, M, T)
    if impl == "chol":
        L = chol_piv(_symmetrised(block_embed(B)))[0]
        # logdet E(B) = 2 logdet B, and each diagonal entry of L comes twice; a
        # diagonal that float32 rounding leaves negative downstream of a breakdown is
        # clamped, so the (source, bin) gets a finite logdet and the next M-step heals it
        logdet = torch.log(torch.clamp(L.diagonal(dim1=-2, dim2=-1), min=1e-20)).sum(dim=-1)
        ZBZ = (Zb.conj() * (torch.linalg.inv_ex(B)[0] @ Zb)).sum(dim=-2).real
    else:
        lamb2, P2 = herm_eigh_embed(B)
        lamb2 = torch.clamp(lamb2, min=eps)
        logdet = torch.log(lamb2).sum(dim=-1) / 2
        # Re z^H B^-1 z = e^T E(B)^-1 e with e = [Re z; Im z]
        proj = P2.transpose(-1, -2) @ torch.cat([Zb.real, Zb.imag], dim=-2)  # (N, I, 2M, T)
        ZBZ = (proj * proj / lamb2[..., None]).sum(dim=-2)
    ZBZ = torch.clamp(ZBZ, min=eps) if flooring_fn is None else flooring_fn(torch.clamp(ZBZ, min=0))  # (N, I, T)
    log_gamma = (torch.log(alpha) - logdet)[:, :, None] - n_channels * torch.log(ZBZ)
    return log_gamma, ZBZ


def posterior(Z, alpha, B, eps: float = 1e-10, impl: str = "eigh", flooring_fn: Optional[Callable] = None) -> torch.Tensor:
    """The posterior ``gamma (N, I, T)``: the softmax of the E-step over sources (``splitc.cacgmm_posterior_sc``)."""
    return torch.softmax(estep(Z, alpha, B, eps=eps, impl=impl, flooring_fn=flooring_fn)[0], dim=0)


def step(
    Z: torch.Tensor,
    alpha: torch.Tensor,
    B: torch.Tensor,
    eps: float = 1e-10,
    normalization: bool = True,
    impl: str = "eigh",
    covariance_impl: str = "einsum",
    flooring_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EM iteration; returns ``(alpha, B)`` (``splitc.cacgmm_step_sc``, splitc.py:2560-2653).

    E-step posterior ``gamma``; ``alpha = mean_t gamma``; ``B = M sum_t G z
    z^H / max(sum_t gamma, eps)`` with ``G = gamma / z^H B^-1 z`` (or the
    kernel's mean over ``max(alpha, eps)``); the PSD projection (eigenvalues
    floored at ``eps``) or, under ``"chol"``, the relative ridge; with
    ``normalization``, ``B`` over its trace. ``flooring_fn`` as the module
    describes.
    """
    _check(impl, covariance_impl)
    n_channels = Z.shape[0]
    log_gamma, ZBZ = estep(Z, alpha, B, eps=eps, impl=impl, flooring_fn=flooring_fn)
    gamma = torch.softmax(log_gamma, dim=0)

    alpha = torch.mean(gamma, dim=-1)
    G = gamma / ZBZ
    if covariance_impl == "einsum":
        num = torch.einsum("nit,pit,qit->nipq", G.to(Z.dtype), Z, Z.conj())
        denom = torch.clamp(torch.sum(gamma, dim=2), min=eps)[:, :, None, None]
        B = n_channels * num / denom
    else:
        denom = torch.clamp(alpha, min=eps)[:, :, None, None]
        B = n_channels * covariance(Z, G).transpose(0, 1) / denom

    if impl == "chol" and flooring_fn is None:
        B = hermitize(B)
        rel = 1e-12 if B.dtype == torch.complex128 else 1e-6
        lam = eps + rel * B.diagonal(dim1=-2, dim2=-1).real.mean(dim=-1)
        B = B + lam[..., None, None] * torch.eye(n_channels, dtype=B.dtype, device=B.device)
    else:
        lamb2, P2 = herm_eigh_embed(hermitize(B))
        B = _extract((P2 * floor(lamb2, eps, flooring_fn)[..., None, :]) @ P2.transpose(-1, -2), n_channels)

    if normalization:
        trace = B.diagonal(dim1=-2, dim2=-1).real.sum(dim=-1)
        B = B / trace[..., None, None]
    return alpha, B


def loss(Z, alpha, B, eps: float = 1e-10, impl: str = "eigh", flooring_fn: Optional[Callable] = None) -> torch.Tensor:
    """Negative log-likelihood ``sum_i mean_t -logsumexp_n log_gamma``, a 0-dim tensor (``splitc.cacgmm_loss_sc``)."""
    value = -torch.logsumexp(estep(Z, alpha, B, eps=eps, impl=impl, flooring_fn=flooring_fn)[0], dim=0)  # (I, T)
    return torch.sum(torch.mean(value, dim=-1))
