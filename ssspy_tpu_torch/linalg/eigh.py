"""Batched (generalized) Hermitian eigendecompositions, and the closed-form one of 2 x 2 pencils.

:func:`gevd2` is the counterpart of ``splitc._gevd2_sc``
(ssspy_tpu/ops/splitc.py:838-931) and of its complex twin
``ssspy_tpu.linalg.eigh.eigh2`` (eigh.py:132) on native complex tensors:
every operation is elementwise over the batch, so the IP2 and ISS2 updates
solve their ``(bins, pairs)`` pencils without an iterative eigensolver.
``torch.linalg.eigh`` is not used on these pencils: its eigenvector phase
is another one, and the fixtures hold the gauge.

:func:`eigh` and :func:`eigh2` are the public functions of
``ssspy_tpu.linalg.eigh`` (eigh.py:80-150; parity: ssspy/linalg/eigh.py):
the generalized problems of types 1, 2 and 3, :func:`eigh` by Cholesky
whitening and ``torch.linalg.eigh``, :func:`eigh2` through :func:`gevd2`.
"""

from typing import Optional, Tuple

import torch

from ..special.psd import eigh_in_batches

__all__ = ["gevd2", "eigh", "eigh2"]


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real.square() + z.imag.square()


def gevd2(
    A: torch.Tensor, B: torch.Tensor, tiny: float = 1e-20, gauge: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvectors ``(lo, hi)`` of ``A z = lamb B z`` for Hermitian ``(..., 2, 2)`` pencils, ``B`` positive definite.

    ``lo`` belongs to the smaller eigenvalue and ``hi`` to the larger, each
    ``(..., 2)`` complex. The Cholesky factor ``L`` of ``B`` (diagonal
    floored at ``tiny``) reduces the pencil to ``C = L^-1 A L^-H``, whose
    closed-form ``lo`` eigenvector is taken from the better-conditioned of
    its two candidates (``e_1`` where both vanish) and gauged so that its
    larger-magnitude component is real positive; ``hi`` is the orthogonal
    complement ``(-conj(y_1), conj(y_0))`` of the gauged ``lo``. Both go
    back through ``L^-H``. Only the real parts of the diagonals and the
    ``(0, 1)`` entries are read. ``gauge=False`` leaves ``lo`` as its
    candidate gives it, as the JAX function does for real matrices.
    """
    a11, a22, a12 = A[..., 0, 0].real, A[..., 1, 1].real, A[..., 0, 1]
    b11, b22, b12 = B[..., 0, 0].real, B[..., 1, 1].real, B[..., 0, 1]

    # L = [[l11, 0], [l21, l22]], l21 = conj(b12) / l11
    l11 = torch.sqrt(torch.clamp(b11, min=tiny))
    l21 = b12.conj() / l11
    l22 = torch.sqrt(torch.clamp(b22 - _abs2(l21), min=tiny))
    inv11, inv22 = 1.0 / l11, 1.0 / l22
    s = -l21 * (inv11 * inv22)  # L^-1 = [[inv11, 0], [s, inv22]]

    # C = L^-1 A L^-H, Hermitian: c11 and c22 real
    c11 = a11 * inv11 * inv11
    c12 = inv11 * (a11 * s.conj() + a12 * inv22)
    t1 = s * a11 + inv22 * a12.conj()
    c22 = (t1 * s.conj()).real + (s * a12).real * inv22 + inv22 * inv22 * a22

    mean = (c11 + c22) / 2
    radius = torch.sqrt(((c11 - c22) / 2) ** 2 + _abs2(c12))
    lamb = mean - radius

    # candidates u = [c12, lamb - c11] and w = [lamb - c22, conj(c12)]
    d11, d22 = (lamb - c11).to(c12.dtype), (lamb - c22).to(c12.dtype)
    use_u = _abs2(c12) + (lamb - c11) ** 2 >= (lamb - c22) ** 2 + _abs2(c12)
    x0 = torch.where(use_u, c12, d22)
    x1 = torch.where(use_u, d11, c12.conj())
    nx = torch.sqrt(_abs2(x0) + _abs2(x1))
    degenerate = nx < tiny * 4  # C a multiple of I: e_1
    x0 = torch.where(degenerate, torch.ones_like(x0), x0)
    x1 = torch.where(degenerate, torch.zeros_like(x1), x1)
    nx = torch.where(degenerate, torch.ones_like(nx), nx)
    y0, y1 = x0 / nx, x1 / nx

    if gauge:  # the larger-magnitude component real positive
        anchor = torch.where(_abs2(y0) >= _abs2(y1), y0, y1)
        mag = torch.abs(anchor)
        phase = torch.where(mag > 0, anchor / torch.clamp(mag, min=tiny), torch.ones_like(anchor))
        y0, y1 = y0 * phase.conj(), y1 * phase.conj()

    def back(v0, v1):  # z = L^-H y
        return torch.stack([inv11 * v0 + s.conj() * v1, inv22 * v1], dim=-1)

    return back(y0, y1), back(-y1.conj(), y0.conj())


def eigh(A: torch.Tensor, B: Optional[torch.Tensor] = None, type: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hermitian (generalized) eigendecomposition, batched over the leading axes; eigenvalues ascending.

    ``B=None`` solves ``A z = lamb z`` (``torch.linalg.eigh``, in batches
    as :func:`~ssspy_tpu_torch.special.psd.eigh_in_batches` calls it);
    otherwise ``type=1``: ``A z = lamb B z``, ``type=2``: ``A B z = lamb z``,
    ``type=3``: ``B A z = lamb z``, reduced by the Cholesky factor ``L`` of
    ``B`` (``cholesky_ex``) to the standard problem of ``L^-1 A L^-H``
    (type 1) or ``L^H A L`` (types 2, 3), as ``ssspy_tpu.linalg.eigh.eigh``
    (eigh.py:80-131). Returns ``(eigenvalues, eigenvectors)``.
    """
    if B is None:
        return eigh_in_batches(A)
    if type not in (1, 2, 3):
        raise ValueError(f"Invalid type={type} is given.")
    L = torch.linalg.cholesky_ex(B)[0]
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    C = L_inv @ A @ L_inv.mH if type == 1 else L.mH @ A @ L
    lamb, y = eigh_in_batches(C)
    return lamb, (L_inv.mH @ y if type in (1, 2) else L @ y)


def eigh2(A: torch.Tensor, B: Optional[torch.Tensor] = None, type: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`eigh` for ``(..., 2, 2)`` inputs in closed form, through :func:`gevd2`.

    Types 2 and 3 are type 1 on the pencil ``(A, B^-1)`` (:func:`~ssspy_tpu_torch.linalg.matrix.inv2`),
    the eigenvectors ``B^-1 w`` (type 2) or ``w``: ``B``-normalized (types
    1, 2) or ``B^-1``-normalized (type 3) as the JAX function's. The
    eigenvalues are the Rayleigh quotients of the eigenvectors, ascending.
    Real inputs run in complex without the phase gauge, as the JAX
    function's, and return the real part. Parity: ``ssspy_tpu.linalg.eigh.eigh2``
    (eigh.py:134-150).
    """
    from .matrix import inv2, quadratic

    if A.shape[-2:] != (2, 2):
        raise ValueError(f"2x2 matrix is expected, but given shape of {tuple(A.shape)}.")
    if type not in (1, 2, 3):
        raise ValueError(f"Invalid type={type} is given.")
    real = not A.is_complex()
    cdtype = torch.complex128 if A.dtype == torch.float64 else (torch.complex64 if real else A.dtype)
    A = A.to(cdtype)
    if B is None:
        pencil = torch.eye(2, dtype=cdtype, device=A.device).expand(A.shape)
    else:
        B = B.to(cdtype)
        pencil = B if type == 1 else inv2(B)
    lo, hi = gevd2(A, pencil, gauge=not real)
    W = torch.stack([lo, hi], dim=-1)  # (..., 2, 2), columns the eigenvectors
    w = W.transpose(-2, -1)
    lamb = quadratic(w, A[..., None, :, :]).real / quadratic(w, pencil[..., None, :, :]).real
    Z = pencil @ W if B is not None and type == 2 else W  # type 2: z = B^-1 w
    return lamb, (Z.real if real else Z)
