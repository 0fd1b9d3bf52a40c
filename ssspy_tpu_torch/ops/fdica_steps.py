"""Frequency-domain ICA (FDICA) with the Laplace prior on native complex tensors: the IP1, IP2 and gradient steps and the loss.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``aux_laplace_fdica_ip1_step_sc``
(:2334-2357), ``aux_laplace_fdica_ip2_step_sc`` (:2360-2384),
``grad_laplace_fdica_step_sc`` (:4099-4139) and ``fdica_laplace_loss_sc``
(:4264-4276). FDICA runs an independent ICA in every bin: its weights and
scores are per scalar ``(N, I, T)``, where IVA's are per source and frame.
No kernel of its own: the weighted covariance goes through
:func:`~ssspy_tpu_torch.ops.iva_steps.covariance` (K1 with per-bin weights
in complex64), the IP1 sweep through
:func:`~ssspy_tpu_torch.ops.iva_steps.ip1_update` (K1b), the IP2 pairs
through :func:`~ssspy_tpu_torch.ops.iva_steps.auxiva_ip2_step` (K1 at two
sources once a pair) and the gradient through
:func:`~ssspy_tpu_torch.ops.iva_steps.grad_iva_step`; complex128 takes the
plain routes.

The three steps also take a batch of utterances on a leading axis (``X (B,
M, I, T)``, ``W (B, I, N, M)``), as the multi-device runners of
:mod:`ssspy_tpu_torch.parallel` call them: K1 once per utterance, K1b
folded into the bins. Nothing in them reduces over the bins, so they take
no cross-bin hook.
"""

from typing import Optional

import torch

from .iva_steps import (
    PairSelector,
    auxiva_ip2_step,
    clogabsdet,
    covariance,
    grad_iva_step,
    ip1_update,
    separate,
)

__all__ = [
    "scalar_laplace_varphi",
    "aux_laplace_fdica_ip1_step",
    "aux_laplace_fdica_ip2_step",
    "grad_laplace_fdica_step",
    "fdica_laplace_loss",
]

# the JAX step's float32 floor: FDICA's weights are per scalar, and near-silent cells drive 1 / |y| to
# 1e10 at the reference's 1e-10 (splitc.py:2343-2348); pass 1e-10 for complex128 parity
AUX_EPS = 1e-6


def scalar_laplace_varphi(Y: torch.Tensor, eps: float) -> torch.Tensor:
    """The Laplace MM weight per scalar, ``1 / max(|y|, eps)``: ``(N, I, T)``."""
    return 1.0 / torch.clamp(Y.abs(), min=eps)


def aux_laplace_fdica_ip1_step(X: torch.Tensor, W: torch.Tensor, eps: float = AUX_EPS) -> torch.Tensor:
    """One AuxLaplaceFDICA-IP1 iteration; returns the new demixing filters ``(I, N, M)``.

    ``X``: mixture ``(M, I, T)``; ``W``: ``(I, N, M)``. The weights
    ``1 / max(|y|, eps)`` per scalar, the weighted covariance with
    ``(N, I, T)`` weights, then the IP1 sweep. Counterpart of
    ``splitc.aux_laplace_fdica_ip1_step_sc`` (splitc.py:2334-2357).
    """
    return ip1_update(W, covariance(X, scalar_laplace_varphi(separate(X, W), eps)), eps=eps)


def aux_laplace_fdica_ip2_step(
    X: torch.Tensor, W: torch.Tensor, eps: float = AUX_EPS, pair_selector: Optional[PairSelector] = None
) -> torch.Tensor:
    """One AuxLaplaceFDICA-IP2 iteration; returns the new demixing filters ``(I, N, M)``.

    For each pair of ``pair_selector`` (sequential by default): the pair's
    two current rows separate ``X``, their weights ``(2, I, T)`` give the
    two covariances (K1 at two sources), then the IP2 pair update.
    Counterpart of ``splitc.aux_laplace_fdica_ip2_step_sc``
    (splitc.py:2360-2384) with any ``pair_selector``, as the JAX class's step
    (ssspy_tpu/bss/fdica.py:568-580).
    """
    return auxiva_ip2_step(
        X, W, eps=eps, pair_selector=pair_selector, varphi_of=lambda Y, pair: scalar_laplace_varphi(Y, eps)
    )


def grad_laplace_fdica_step(
    X: torch.Tensor,
    W: torch.Tensor,
    step_size: float = 1e-1,
    is_holonomic: bool = True,
    natural: bool = False,
    eps: float = 1e-10,
) -> torch.Tensor:
    """One Grad/NaturalGrad Laplace-FDICA iteration: the score ``y / max(|y|, eps)`` per scalar.

    Otherwise the gradient IVA step
    (:func:`~ssspy_tpu_torch.ops.iva_steps.grad_iva_step`: the natural
    direction, or ``W^-H`` by ``solve_ex``). Counterpart of
    ``splitc.grad_laplace_fdica_step_sc`` (splitc.py:4099-4139).
    """
    Y = separate(X, W)
    Phi = Y / torch.clamp(Y.abs(), min=eps)
    return grad_iva_step(W, Y, Phi, step_size=step_size, is_holonomic=is_holonomic, natural=natural)


def fdica_laplace_loss(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """FDICA's Laplace negative log-likelihood, a 0-dim tensor: ``sum_i [sum_n mean_t 2 |y_nit| - 2 log|det W_i|]``.

    Counterpart of ``splitc.fdica_laplace_loss_sc`` (splitc.py:4264-4276)
    and of ``FDICABase.make_loss`` (ssspy_tpu/bss/fdica.py:132-144).
    """
    G = 2 * separate(X, W).abs()  # (N, I, T)
    return torch.sum(torch.sum(torch.mean(G, dim=2), dim=0) - 2 * clogabsdet(W))
