"""The closed-form generalized eigenproblem of Hermitian 2 x 2 pencils.

Counterpart of ``splitc._gevd2_sc`` (ssspy_tpu/ops/splitc.py:838-931) and
of its complex twin ``ssspy_tpu.linalg.eigh.eigh2`` (eigh.py:132) on
native complex tensors: every operation is elementwise over the batch, so
the IP2 and ISS2 updates solve their ``(bins, pairs)`` pencils without an
iterative eigensolver. ``torch.linalg.eigh`` is not used on these pencils:
its eigenvector phase is another one, and the fixtures hold the gauge.
"""

from typing import Tuple

import torch

__all__ = ["gevd2"]


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real.square() + z.imag.square()


def gevd2(A: torch.Tensor, B: torch.Tensor, tiny: float = 1e-20) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenvectors ``(lo, hi)`` of ``A z = lamb B z`` for Hermitian ``(..., 2, 2)`` pencils, ``B`` positive definite.

    ``lo`` belongs to the smaller eigenvalue and ``hi`` to the larger, each
    ``(..., 2)`` complex. The Cholesky factor ``L`` of ``B`` (diagonal
    floored at ``tiny``) reduces the pencil to ``C = L^-1 A L^-H``, whose
    closed-form ``lo`` eigenvector is taken from the better-conditioned of
    its two candidates (``e_1`` where both vanish) and gauged so that its
    larger-magnitude component is real positive; ``hi`` is the orthogonal
    complement ``(-conj(y_1), conj(y_0))`` of the gauged ``lo``. Both go
    back through ``L^-H``. Only the real parts of the diagonals and the
    ``(0, 1)`` entries are read.
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

    # gauge: the larger-magnitude component real positive
    anchor = torch.where(_abs2(y0) >= _abs2(y1), y0, y1)
    mag = torch.abs(anchor)
    phase = torch.where(mag > 0, anchor / torch.clamp(mag, min=tiny), torch.ones_like(anchor))
    y0, y1 = y0 * phase.conj(), y1 * phase.conj()

    def back(v0, v1):  # z = L^-H y
        return torch.stack([inv11 * v0 + s.conj() * v1, inv22 * v1], dim=-1)

    return back(y0, y1), back(-y1.conj(), y0.conj())
