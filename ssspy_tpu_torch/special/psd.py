"""Projection onto the positive-semidefinite cone, and the floored PSD inverse.

Counterpart of :mod:`ssspy_tpu.special.psd` (``to_psd``, psd.py:24-55; parity
target ssspy/special/psd.py:11-71), of ``_psd_inv``
(ssspy_tpu/bss/_update_spatial_model.py:414-427) and of the relative
eigenvalue floor ``splitc._eig_floor`` (splitc.py:1261-1280).

Both are spectral functions of a Hermitian matrix, and the route of their
eigendecomposition is decided by dtype, before any launch: complex128 and
float64 go to ``torch.linalg.eigh`` on the matrix itself (the
reference-exact route of the CPU tests and the fixtures), in batches of
``CUDA_EIGH_BATCH`` matrices (:func:`eigh_in_batches`); complex64 goes
through the real ``2m x 2m`` embedding and
:func:`ssspy_tpu_torch.ops.prox_steps.herm_eigh_embed` (the Jacobi kernel
K7 on the card), with the two embedded copies averaged on the way back
(``splitc._spectral_sc``, splitc.py:1243-1258): the embedded spectrum comes
in exact pairs, so single eigenvector columns mean nothing, but
``P f(lamb) P^T`` is blind to the basis chosen inside a pair.
"""

import functools
from typing import Callable, Optional, Tuple

import torch

from .flooring import EPS, identity, max_flooring

__all__ = ["hermitize", "eig_floor", "eigh_in_batches", "spectral", "to_psd", "psd_inv"]


def hermitize(X: torch.Tensor) -> torch.Tensor:
    """``(X + X^H) / 2`` over the trailing two axes (the transpose for a real tensor)."""
    return (X + X.mH) / 2


def eig_floor(flooring_fn: Optional[Callable], rel: float = 0.0) -> Callable:
    """Eigenvalue floor: ``flooring_fn``, plus optionally ``rel`` times the matrix's top eigenvalue.

    Takes eigenvalues in ascending order, as an eigh returns them. The
    relative term keeps the algebra downstream scale-equivariant per bin: an
    absolute floor alone clips the inverse of a near-silent bin at ``1/eps``,
    which overflows the float32 IPA chain. ``rel = 0`` is the reference
    (splitc.py:1261-1280).
    """
    flooring_fn = identity if flooring_fn is None else flooring_fn

    def floor(lamb: torch.Tensor) -> torch.Tensor:
        floored = flooring_fn(lamb)
        if rel:
            floored = torch.maximum(floored, rel * torch.clamp(lamb[..., -1:], min=0))
        return floored

    return floor


# matrices per cuSOLVER batched eigh: it refuses dense GaussMNMF's model
# batch (257 x 626 = 160,882 complex128 8 x 8) in one call
CUDA_EIGH_BATCH = 16384


def eigh_in_batches(A: torch.Tensor, batch: int = CUDA_EIGH_BATCH) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.linalg.eigh`` of ``(..., m, m)``, called on at most ``batch`` matrices at a time.

    Every call of the port to ``torch.linalg.eigh`` goes through here, so
    that no batch reaches cuSOLVER whole; on the CPU, where LAPACK takes one
    matrix at a time, the split changes nothing.
    """
    flat = A.reshape(-1, *A.shape[-2:])
    if flat.shape[0] <= batch:
        return torch.linalg.eigh(A)
    parts = [torch.linalg.eigh(flat[k : k + batch]) for k in range(0, flat.shape[0], batch)]
    lamb, P = (torch.cat([part[j] for part in parts]) for j in (0, 1))
    return lamb.reshape(A.shape[:-1]), P.reshape(A.shape)


def spectral(A: torch.Tensor, f: Callable, *more: Callable):
    """``P f(lamb) P^H`` of Hermitian ``A (..., m, m)``, the eigh routed by dtype (see the module).

    With ``more`` functions, a tuple with one matrix per function, all from
    the one eigh.
    """
    if A.dtype in (torch.complex128, torch.float64):
        lamb, P = eigh_in_batches(A)
        out = tuple((P * g(lamb)[..., None, :].to(P.dtype)) @ P.mH for g in (f, *more))
    elif A.dtype == torch.complex64:
        # imported here: ops imports this module
        from ..ops.prox_steps import _extract, herm_eigh_embed

        lamb2, P2 = herm_eigh_embed(A)
        out = tuple(
            _extract((P2 * g(lamb2)[..., None, :]) @ P2.transpose(-1, -2), A.shape[-1]) for g in (f, *more)
        )
    else:
        raise ValueError(f"spectral takes complex128, float64 or complex64, got {A.dtype}")
    return out if more else out[0]


def to_psd(
    X: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    rel: float = 0.0,
) -> torch.Tensor:
    """Project Hermitian (or symmetric) ``(..., M, M)`` onto the PSD cone.

    Hermitize, floor the eigenvalues with :func:`eig_floor`, reassemble,
    hermitize (psd.py:24-55; ``splitc.to_psd_sc`` for ``rel``).
    """
    return hermitize(spectral(hermitize(X), eig_floor(flooring_fn, rel)))


def psd_inv(
    X: torch.Tensor,
    flooring_fn: Optional[Callable] = functools.partial(max_flooring, eps=EPS),
    rel: float = 0.0,
) -> torch.Tensor:
    """Inverse of PSD ``(..., M, M)`` through its floored eigenvalues.

    ``_psd_inv`` (_update_spatial_model.py:414-427; ``splitc.psd_inv_sc``
    for ``rel``). ``X`` is read as given, not hermitized.
    """
    floor = eig_floor(flooring_fn, rel)
    return spectral(X, lambda lamb: 1 / floor(lamb))
