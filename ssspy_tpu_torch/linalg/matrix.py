"""Small batched matrix helpers: the 2 x 2 inverse, the solve, quadratic forms, matrix square roots and the geometric mean.

Counterparts of ``ssspy_tpu.linalg``'s ``inv2`` (inv.py), ``solve``
(_solve.py), ``quadratic`` (quadratic.py), ``sqrtmh`` and ``invsqrtmh``
(sqrtm.py) and ``gmeanmh`` (mean.py) on torch tensors, on the caller's
device (parity: ssspy/linalg). Every solve is ``solve_ex`` and every
inverse ``inv_ex``: a singular system gives non-finite values, not an
exception or a host read.
"""

from typing import Callable, Optional

import torch

from .eigh import eigh

__all__ = ["inv2", "solve", "quadratic", "sqrtmh", "invsqrtmh", "gmeanmh"]


def inv2(X: torch.Tensor) -> torch.Tensor:
    """The inverse of ``(..., 2, 2)`` matrices by the adjugate, elementwise over the batch."""
    if X.shape[-2:] != (2, 2):
        raise ValueError(f"2x2 matrix is expected, but given shape of {tuple(X.shape)}.")
    a, b, c, d = X[..., 0, 0], X[..., 0, 1], X[..., 1, 0], X[..., 1, 1]
    det = a * d - b * c
    adj = torch.stack([torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x = b`` batched (``solve_ex``); ``b`` a stack of vectors (``b.dim() == a.dim() - 1``) or of matrices."""
    if a.dim() == b.dim() + 1:
        return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]
    return torch.linalg.solve_ex(a, b)[0]


def quadratic(X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``x^H A x`` for vectors ``(..., M)`` and matrices ``(..., M, M)``."""
    return torch.einsum("...m,...mn,...n->...", X.conj() if X.is_complex() else X, A, X)


def _rebuild(P: torch.Tensor, lamb: torch.Tensor) -> torch.Tensor:
    return (P * lamb[..., None, :].to(P.dtype)) @ P.mH


def sqrtmh(X: torch.Tensor) -> torch.Tensor:
    """The principal square root of PSD Hermitian (or symmetric) ``(..., M, M)``."""
    lamb, P = eigh(X)
    return _rebuild(P, torch.sqrt(lamb))


def invsqrtmh(X: torch.Tensor, flooring_fn: Optional[Callable] = None) -> torch.Tensor:
    """The inverse principal square root, ``P diag(1 / flooring_fn(sqrt(lamb))) P^H`` (``flooring_fn=None``: none)."""
    lamb, P = eigh(X)
    root = torch.sqrt(lamb)
    return _rebuild(P, 1 / (root if flooring_fn is None else flooring_fn(root)))


def gmeanmh(A: torch.Tensor, B: torch.Tensor, type: int = 1) -> torch.Tensor:
    """The geometric mean of Hermitian PSD matrices: ``A # B`` (type 1), ``A^-1 # B`` (2), ``A # B^-1`` (3).

    From the generalized eigendecomposition of type ``type``
    (:func:`~ssspy_tpu_torch.linalg.eigh.eigh`): ``Z sqrt(lamb) Z^-1`` times
    ``B``, ``A^-1`` or ``B^-1``, as ``ssspy_tpu.linalg.gmeanmh`` (mean.py:13-33).
    """
    if type not in (1, 2, 3):
        raise ValueError(f"Invalid type={type} is given.")
    lamb, Z = eigh(A, B, type=type)
    ZLZ = (Z * torch.sqrt(lamb.to(Z.dtype))[..., None, :]) @ torch.linalg.inv_ex(Z)[0]
    if type == 1:
        return B @ ZLZ
    return torch.linalg.inv_ex(A if type == 2 else B)[0] @ ZLZ
