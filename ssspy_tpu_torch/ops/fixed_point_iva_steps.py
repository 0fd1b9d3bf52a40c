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

Two routes without an eigendecomposition are options, as the JAX package
takes them on a float32 TPU (splitc.py:3843-3845, :4011-4013): the polar
factor by QDWH (``polar(impl="qdwh")``, ``fast_iva_step(polar_impl=)``) and
FasterIVA's step without an eigh (``faster_iva_step(eig_impl="solve")``: the
top eigenvectors by shift-invert, ``top_eigvec(impl="solve")``, and the
polar factor by QDWH), both on :mod:`ssspy_tpu_torch.linalg.eig_free`. The
eigh routes stay the default.

The two steps also take a batch of utterances on a leading axis (``Z (B, M,
I, T)``, ``W (B, I, N, M)``) and ``bin_sum``, as the multi-device runners
of :mod:`ssspy_tpu_torch.parallel` call them: the contrast's norm over the
bins goes through the hook (one call for every utterance), K1 runs once
per utterance and each eigh once for all of them.
"""

import torch

from ..linalg.eig_free import block_embed, chol_piv, qdwh_schedule, top_eigvec_shift_invert, tri_lower_inv
from .iva_steps import bin_norm, covariance, separate
from .prox_steps import _extract, herm_eigh_embed

POLAR_IMPLS = ("eigh", "qdwh")
EIG_IMPLS = ("eigh", "solve")

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


def polar(W: torch.Tensor, tiny: float = 1e-20, impl: str = "eigh") -> torch.Tensor:
    """Unitary polar factor ``W (W^H W)^-1/2`` of ``(..., M, M)``.

    ``impl="eigh"``: one embedded eigh of the Hermitized Gram (K7 in
    float32), its eigenvalues mapped to ``1 / sqrt(max(lambda, tiny))`` and
    the two embedded copies of the result averaged. Equals the SVD's
    ``u v^H`` wherever ``W`` is nonsingular. ``impl="qdwh"``: no
    eigendecomposition; from ``W`` over its Frobenius norm, each weight
    ``(a, b, c)`` of :func:`~ssspy_tpu_torch.linalg.eig_free.qdwh_schedule`
    takes ``X <- (b / c) X + (a - b / c) X (I + c X^H X)^-1``, the inverse
    from the pivot-certified Cholesky of the embedded ``I + c X^H X`` and
    its triangular inverse; a (near-)singular ``W`` gives a partial
    isometry. Its products run in float32 as every product of the port
    does (TF32 off, PyTorch's default). Counterpart of ``splitc._polar_sc``
    (splitc.py:3823-3885).
    """
    if impl == "qdwh":
        return _polar_qdwh(W, tiny)
    if impl != "eigh":
        raise ValueError(f"unknown polar impl {impl!r}; expected one of {POLAR_IMPLS}")
    G = W.mH @ W
    lamb, P = herm_eigh_embed((G + G.mH) / 2)
    F = (P * torch.rsqrt(torch.clamp(lamb, min=tiny))[..., None, :]) @ P.transpose(-1, -2)
    return W @ _extract(F, W.shape[-1])


def _polar_qdwh(W: torch.Tensor, tiny: float) -> torch.Tensor:
    """:func:`polar`'s ``"qdwh"`` route (splitc.py:3848-3872)."""
    M = W.shape[-1]
    fro = torch.sqrt(torch.sum(W.real.square() + W.imag.square(), dim=(-2, -1), keepdim=True))
    X = W / torch.clamp(fro, min=tiny)
    eye2 = torch.eye(2 * M, dtype=fro.dtype, device=W.device)
    for a, b, c in qdwh_schedule():
        E = block_embed(X.mH @ X)
        L_inv = tri_lower_inv(chol_piv(eye2 + c * ((E + E.transpose(-1, -2)) / 2))[0])
        Q = L_inv.transpose(-1, -2) @ L_inv  # the embedded (I + c X^H X)^-1
        w = b / c
        X = w * X + (a - w) * (X @ torch.complex(Q[..., :M, :M], Q[..., M:, :M]))
    return X


def top_eigvec(U: torch.Tensor, impl: str = "eigh") -> torch.Tensor:
    """Unit eigenvector of the largest eigenvalue of Hermitian ``U (..., M, M)``: ``(..., M)``.

    ``impl="eigh"``: the last column of the embedded eigh (K7 in float32);
    ``impl="solve"``: :func:`~ssspy_tpu_torch.linalg.eig_free.top_eigvec_shift_invert`,
    no eigendecomposition. Either way its phase is canonicalized: the
    largest-magnitude component made real positive, so that the pick
    inside the embedding's doubled eigenspace does not leak into the
    trajectory (splitc.py:4011-4040).
    """
    n_channels = U.shape[-1]
    if impl == "solve":
        v = top_eigvec_shift_invert(U)
    elif impl == "eigh":
        _, P2 = herm_eigh_embed(U)
        v = torch.complex(P2[..., :n_channels, -1], P2[..., n_channels:, -1])
    else:
        raise ValueError(f"unknown eig_impl {impl!r}; expected one of {EIG_IMPLS}")
    anchor = torch.gather(v, -1, torch.argmax(v.real.square() + v.imag.square(), dim=-1, keepdim=True))
    anchor = anchor / torch.sqrt(torch.clamp(anchor.real.square() + anchor.imag.square(), min=1e-30))
    return v * anchor.conj()


def fast_iva_update(
    Z: torch.Tensor,
    W: torch.Tensor,
    Y: torch.Tensor,
    varphi: torch.Tensor,
    y_gg: torch.Tensor,
    polar_impl: str = "eigh",
) -> torch.Tensor:
    """One FastIVA fixed-point update of ``W (I, N, M)`` on the whitened ``Z (M, I, T)``, then :func:`polar`.

    ``Y = W Z``; ``varphi = G'(r) / flooring(2r)`` and
    ``y_gg = (2 varphi - G''(r)) / flooring(2r)``, each ``(N, T)``:
    ``w_n <- mean(varphi_n) w_n - mean_t varphi_n y_n z^H - mean_t y_gg |y_n|^2 w_n``
    per bin (parity: ssspy_tpu/bss/iva.py:722-747); ``polar_impl`` as
    :func:`polar`'s ``impl``. Any leading batch axes.
    """
    n_frames = Y.shape[-1]
    YZ = torch.einsum("...nt,...nit,...mit->...inm", varphi.to(Z.dtype), Y, Z.conj()) / n_frames
    YY_GG = torch.einsum("...nt,...nit->...ni", y_gg, Y.real.square() + Y.imag.square()) / n_frames  # (N, I)
    scale = varphi.mean(dim=-1)[..., None, :, None] - YY_GG.transpose(-2, -1)[..., None]  # (I, N, 1)
    return polar(W * scale.to(W.dtype) - YZ, impl=polar_impl)


def fast_iva_step(
    Z: torch.Tensor, W: torch.Tensor, eps: float = 1e-10, polar_impl: str = "eigh", bin_sum=None
) -> torch.Tensor:
    """One FastIVA iteration with the Laplace contrast ``G(y) = 2 ||y||`` (``G'' = 0``).

    ``varphi = 2 / max(2 ||y_n||, eps)``, ``y_gg = 2 varphi / max(2 ||y_n||, eps)``,
    the norm over bins; the polar factor by ``polar_impl``. Counterpart of
    ``splitc.fast_iva_step_sc`` (splitc.py:3886-3927). Batched and
    ``bin_sum`` as the module describes.
    """
    Y = separate(Z, W)
    denom = torch.clamp(2 * bin_norm(Y, bin_sum), min=eps)
    varphi = 2 / denom
    return fast_iva_update(Z, W, Y, varphi, 2 * varphi / denom, polar_impl=polar_impl)


def faster_iva_update(Z: torch.Tensor, varphi: torch.Tensor, eig_impl: str = "eigh") -> torch.Tensor:
    """FasterIVA's demixing filters from the weights ``varphi (N, T)``: ``(I, N, M)``.

    The per-source weighted covariance of ``Z`` (K1, ``(N, T)`` weights),
    its top eigenvector per (bin, source) (:func:`top_eigvec` by
    ``eig_impl``: K7 at ``(I N, 2M, 2M)``, or shift-invert), conjugated into
    rows, then :func:`polar`: its eigh route after K7, its QDWH route after
    shift-invert, as the JAX package pairs them (splitc.py:4011-4013,
    :3843-3845). The rows of two sources can be nearly collinear (least
    singular value 2e-5 on the 8-channel 10 s mixture after four steps);
    there the Gram's least eigenvalue, ``sigma_min^2``, sits under float32's
    rounding of the Gram and the eigh polar scales by the inverse square
    root of rounding noise. The shift-invert eigenvectors with the eigh polar
    diverged so on the H100 (filters' singular values to 5e6 from the fourth
    step) while QDWH stays unitary to 5e-6
    (scripts/torch_faster_iva_solve_drift.py; PERF.md, section 6).
    """
    rows = top_eigvec(covariance(Z, varphi), impl=eig_impl).conj()
    return polar(rows, impl="qdwh" if eig_impl == "solve" else "eigh")


def faster_iva_step(
    Z: torch.Tensor, W: torch.Tensor, eps: float = 1e-10, eig_impl: str = "eigh", bin_sum=None
) -> torch.Tensor:
    """One FasterIVA iteration with the Laplace contrast: ``varphi = 2 / max(2 ||y_n||, eps)``.

    Counterpart of ``splitc.faster_iva_step_sc`` (splitc.py:3992-4044);
    ``eig_impl="solve"`` takes no eigh: the top eigenvectors by shift-invert
    and the polar factor by QDWH, as :func:`faster_iva_update` sets out.
    Batched and ``bin_sum`` as the module describes.
    """
    Y = separate(Z, W)
    return faster_iva_update(Z, 2 / torch.clamp(2 * bin_norm(Y, bin_sum), min=eps), eig_impl=eig_impl)


def fast_iva_laplace_loss(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``sum_n mean_t 2 ||y_n||`` on the whitened input, a 0-dim tensor: no log-det, ``W`` stays unitary.

    Counterpart of ``splitc.fast_iva_laplace_loss_sc`` (splitc.py:4279-4290).
    """
    return (2 * torch.linalg.vector_norm(separate(Z, W), dim=1)).mean(dim=-1).sum()
