"""FastIVA and FasterIVA on native complex tensors: the spectrogram whitening, the polar factor, the steps and their loss.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``whiten_sc`` (:3754-3796),
``_polar_sc`` with its eigh route (:3823, :3875-3885, on ``_spectral_sc``
:1243), ``fast_iva_step_sc`` (:3886-3927), ``faster_iva_step_sc`` with its
eigh route (:3992-4044) and ``fast_iva_laplace_loss_sc`` (:4279). Every
eigendecomposition is the real symmetric eigh of the ``2M x 2M`` embedding
of a Hermitian matrix through :func:`~ssspy_tpu_torch.ops.prox_steps.herm_eigh_embed`,
which sends float32 to the Jacobi kernel K7 and float64 to LAPACK; FasterIVA's
per-source covariance goes through
:func:`~ssspy_tpu_torch.ops.iva_steps.covariance` (K1). The embedded
eigensolver fixes another eigenvector phase than a complex one: the
whitened input differs from the complex whitening by a phase per
component, which the fixed-point updates carry through and projection back
removes.
"""

import torch

from .iva_steps import covariance, separate
from .prox_steps import _extract, herm_eigh_embed

__all__ = [
    "whiten_spectrogram",
    "polar",
    "top_eigvec",
    "fast_iva_update",
    "fast_iva_step",
    "faster_iva_update",
    "faster_iva_step",
    "fast_iva_laplace_loss",
]


def whiten_spectrogram(X: torch.Tensor, tiny: float = 1e-20) -> torch.Tensor:
    """Per-bin whitening ``z = Lambda^-1/2 Gamma^H x`` of ``X (M, I, T)``: the same shape.

    The covariance ``mean_t x x^H`` of each bin first gets a graded
    diagonal jitter, ``jitter * mean(diag) * diag(0, 1, ..., M - 1)`` with
    ``jitter`` 1e-5 in float32 and 1e-12 in float64, which splits a
    (near-)isotropic bin's degenerate eigenvalues along the axes, so that
    the complex eigenvectors taken from the embedding stay orthogonal;
    then one embedded eigh (K7 in float32), the eigenvalues floored at
    ``tiny``. Counterpart of ``splitc.whiten_sc`` (splitc.py:3754-3796).
    """
    n_channels, _, n_frames = X.shape
    C = torch.einsum("mit,nit->imn", X, X.conj()) / n_frames  # (I, M, M)
    jitter = 1e-12 if X.real.dtype == torch.float64 else 1e-5
    mean_diag = torch.diagonal(C, dim1=-2, dim2=-1).real.mean(dim=-1)  # (I,)
    grades = torch.arange(n_channels, dtype=X.real.dtype, device=X.device)
    C = C + torch.diag_embed((jitter * mean_diag)[:, None] * grades).to(C.dtype)
    lamb2, P2 = herm_eigh_embed(C)
    lamb = torch.clamp(lamb2[..., 0::2], min=tiny)  # (I, M) ascending
    G = torch.complex(P2[..., :n_channels, 0::2], P2[..., n_channels:, 0::2])  # (I, M, M) eigenvectors
    Z = torch.einsum("imk,mit->kit", G.conj(), X)
    return (Z * torch.rsqrt(lamb).T[:, :, None]).contiguous()


def polar(W: torch.Tensor, tiny: float = 1e-20) -> torch.Tensor:
    """Unitary polar factor ``W (W^H W)^-1/2`` of ``(..., M, M)``.

    One embedded eigh of the Hermitized Gram (K7 in float32), its
    eigenvalues mapped to ``1 / sqrt(max(lambda, tiny))`` and the two
    embedded copies of the result averaged. Equals the SVD's ``u v^H``
    wherever ``W`` is nonsingular. Counterpart of ``splitc._polar_sc``'s
    eigh route (splitc.py:3875-3885).
    """
    G = W.mH @ W
    lamb, P = herm_eigh_embed((G + G.mH) / 2)
    F = (P * torch.rsqrt(torch.clamp(lamb, min=tiny))[..., None, :]) @ P.transpose(-1, -2)
    return W @ _extract(F, W.shape[-1])


def top_eigvec(U: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of Hermitian ``U (..., M, M)``: ``(..., M)``.

    The last column of the embedded eigh (K7 in float32), its phase
    canonicalized: the largest-magnitude component made real positive, so
    that the pick inside the embedding's doubled eigenspace does not leak
    into the trajectory (splitc.py:4026-4040).
    """
    n_channels = U.shape[-1]
    _, P2 = herm_eigh_embed(U)
    v = torch.complex(P2[..., :n_channels, -1], P2[..., n_channels:, -1])
    anchor = torch.gather(v, -1, torch.argmax(v.real.square() + v.imag.square(), dim=-1, keepdim=True))
    anchor = anchor / torch.sqrt(torch.clamp(anchor.real.square() + anchor.imag.square(), min=1e-30))
    return v * anchor.conj()


def fast_iva_update(
    Z: torch.Tensor, W: torch.Tensor, Y: torch.Tensor, varphi: torch.Tensor, y_gg: torch.Tensor
) -> torch.Tensor:
    """One FastIVA fixed-point update of ``W (I, N, M)`` on the whitened ``Z (M, I, T)``, then :func:`polar`.

    ``Y = W Z``; ``varphi = G'(r) / flooring(2r)`` and
    ``y_gg = (2 varphi - G''(r)) / flooring(2r)``, each ``(N, T)``:
    ``w_n <- mean(varphi_n) w_n - mean_t varphi_n y_n z^H - mean_t y_gg |y_n|^2 w_n``
    per bin (parity: ssspy_tpu/bss/iva.py:722-747).
    """
    n_frames = Y.shape[-1]
    YZ = torch.einsum("nt,nit,mit->inm", varphi.to(Z.dtype), Y, Z.conj()) / n_frames
    YY_GG = torch.einsum("nt,nit->ni", y_gg, Y.real.square() + Y.imag.square()) / n_frames  # (N, I)
    scale = varphi.mean(dim=-1)[None, :, None] - YY_GG.T[:, :, None]  # (I, N, 1)
    return polar(W * scale.to(W.dtype) - YZ)


def fast_iva_step(Z: torch.Tensor, W: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """One FastIVA iteration with the Laplace contrast ``G(y) = 2 ||y||`` (``G'' = 0``).

    ``varphi = 2 / max(2 ||y_n||, eps)``, ``y_gg = 2 varphi / max(2 ||y_n||, eps)``,
    the norm over bins. Counterpart of ``splitc.fast_iva_step_sc``
    (splitc.py:3886-3927).
    """
    Y = separate(Z, W)
    denom = torch.clamp(2 * torch.linalg.vector_norm(Y, dim=1), min=eps)
    varphi = 2 / denom
    return fast_iva_update(Z, W, Y, varphi, 2 * varphi / denom)


def faster_iva_update(Z: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """FasterIVA's demixing filters from the weights ``varphi (N, T)``: ``(I, N, M)``.

    The per-source weighted covariance of ``Z`` (K1, ``(N, T)`` weights),
    its top eigenvector per (bin, source) (:func:`top_eigvec`, K7 at
    ``(I N, 2M, 2M)``), conjugated into rows, then :func:`polar`.
    """
    return polar(top_eigvec(covariance(Z, varphi)).conj())


def faster_iva_step(Z: torch.Tensor, W: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """One FasterIVA iteration with the Laplace contrast: ``varphi = 2 / max(2 ||y_n||, eps)``.

    Counterpart of ``splitc.faster_iva_step_sc``'s eigh route
    (splitc.py:3992-4044).
    """
    Y = separate(Z, W)
    return faster_iva_update(Z, 2 / torch.clamp(2 * torch.linalg.vector_norm(Y, dim=1), min=eps))


def fast_iva_laplace_loss(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``sum_n mean_t 2 ||y_n||`` on the whitened input, a 0-dim tensor: no log-det, ``W`` stays unitary.

    Counterpart of ``splitc.fast_iva_laplace_loss_sc`` (splitc.py:4279-4290).
    """
    return (2 * torch.linalg.vector_norm(separate(Z, W), dim=1)).mean(dim=-1).sum()
