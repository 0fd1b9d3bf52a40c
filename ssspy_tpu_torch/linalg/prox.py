"""Proximal operators of the PDS/ADMM solvers (parity: ssspy/linalg/prox.py:6-91).

Counterpart of :mod:`ssspy_tpu.linalg.prox` on torch tensors. The
negative log-determinant's prox is
:func:`ssspy_tpu_torch.ops.prox_steps.prox_neg_logdet` (one eigh of the
embedded Gram, the Jacobi kernel in float32), not an SVD beside it.
"""

import torch

__all__ = ["l1", "l21", "neg_log", "neg_logdet"]


def l1(x: torch.Tensor, step_size: float = 1) -> torch.Tensor:
    """Soft-thresholding (prox of the L1 norm)."""
    norm = torch.abs(x)
    norm = torch.where(norm < step_size, torch.full_like(norm, step_size), norm)
    return torch.clamp(1 - step_size / norm, min=0) * x


def l21(x: torch.Tensor, step_size: float = 1, axis1: int = -2, axis2: int = -1) -> torch.Tensor:
    """Group soft-thresholding (prox of the L21 norm) over ``axis2``."""
    norm = torch.linalg.vector_norm(x, dim=axis2, keepdim=True)
    norm = torch.where(norm < step_size, torch.full_like(norm, step_size), norm)
    return torch.clamp(1 - step_size / norm, min=0) * x


def neg_log(x: torch.Tensor, step_size: float = 1) -> torch.Tensor:
    """Prox of ``-mu log(x)``: ``(x + sqrt(x^2 + 4 mu)) / 2`` for ``x >= 0``."""
    return (x + torch.sqrt(x**2 + 4 * step_size)) / 2


def neg_logdet(X: torch.Tensor, step_size: float = 1) -> torch.Tensor:
    """Prox of the negative log-determinant: singular values through :func:`neg_log`.

    ``X``: square ``(..., M, M)``, complex or real (a real input is taken
    as complex and its real part returned).
    """
    from ..ops.prox_steps import prox_neg_logdet  # ops.prox_steps imports neg_log from here

    if X.is_complex():
        return prox_neg_logdet(X, step_size=step_size)
    return prox_neg_logdet(X.to(torch.complex128 if X.dtype == torch.float64 else torch.complex64),
                           step_size=step_size).real
