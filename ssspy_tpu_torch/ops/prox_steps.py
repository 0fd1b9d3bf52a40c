"""The proximal-splitting iterations (PDSIVA, HVA, ADMMIVA) on native complex tensors.

Counterparts of the split-complex functions of the prox family in
``ssspy_tpu/ops/splitc.py`` (``prox_neg_logdet_sc``, ``prox_l21_sc``,
``harmonic_mask_sc``, ``pds_iva_step_sc``, ``hva_pds_step_sc``,
``admm_quad_inv_sc``, ``admm_iva_step_sc``, ``hva_admm_step_sc``,
``prox_iva_loss_sc``). The log-det prox shrinks singular values through one
real symmetric eigh of the embedded Gram ``E(G)^T E(G)``; every eigh of the
family goes through :func:`symm_eigh`, which sends float32 to the Jacobi
kernel K7 (:func:`ssspy_tpu_torch.ops.kernels.jacobi_eigh`, looked up at
each call) and float64 to LAPACK, as the JAX package routes them
(splitc.py:1219-1221, :2703-2707).

Each family has one step, :func:`pds_step` and :func:`admm_step`, with the
dual or spectrogram prox passed in; the L21 and harmonic-mask steps and the
classes' penalty lists are instances of it.

The PDSIVA, ADMMIVA and HVA steps also take a batch of utterances on a
leading axis (``X (B, M, I, T)``, filters ``(B, I, N, M)``, spectrograms
``(B, N, I, T)``) and ``bin_sum``, as the multi-device runners of
:mod:`ssspy_tpu_torch.parallel` call them: the log-det prox runs K7 once
for all utterances, and the step's one cross-bin reduction goes through
the hook in one call for all of them: the L21 group norm, or HVA's floored
log magnitude, which :func:`gathered_harmonic_mask` gathers over the bin
group so that every rank runs the whole-axis cepstral transform on cuFFT.
``bin_sum=None`` runs the single-device code.
"""

import math
from typing import Callable, Optional, Tuple

import torch

from ..linalg.eig_free import block_embed
from ..linalg.prox import neg_log
from ..special.psd import eigh_in_batches
from . import kernels
from .iva_steps import bin_norm, clogabsdet, separate

__all__ = [
    "block_embed",
    "symm_eigh",
    "herm_eigh_embed",
    "prox_neg_logdet",
    "prox_l21",
    "log_magnitude",
    "cepstral_mask",
    "harmonic_mask",
    "gathered_harmonic_mask",
    "pds_step",
    "pds_iva_step",
    "hva_pds_step",
    "prox_iva_loss",
    "admm_quad_inv",
    "admm_step",
    "admm_iva_step",
    "hva_admm_step",
]


def _extract(W2: torch.Tensor, n: int) -> torch.Tensor:
    """Complex matrix from an embedded one, averaging the two copies (splitc.py:2720-2721)."""
    Wr = (W2[..., :n, :n] + W2[..., n:, n:]) / 2
    Wi = (W2[..., n:, :n] - W2[..., :n, n:]) / 2
    return torch.complex(Wr, Wi)


def symm_eigh(S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigh of real symmetric ``(..., n, n)``: ``(lamb ascending, V)``, routed by dtype and shape.

    float32 up to ``n = 32`` goes to
    :func:`ssspy_tpu_torch.ops.kernels.jacobi_eigh` (the kernel on CUDA, its
    plain version on the CPU); float64, and float32 above the kernel's
    ``n`` (:func:`~ssspy_tpu_torch.ops.kernels.jacobi_eigh_takes`), to
    ``torch.linalg.eigh`` through
    :func:`~ssspy_tpu_torch.special.psd.eigh_in_batches` (the JAX package's
    LAPACK route "for f64 parity runs", splitc.py:1219-1221). The choice is
    made here, by dtype and shape, before any launch, on every device alike;
    any other dtype raises.
    """
    if S.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"symm_eigh takes float32 or float64, got {S.dtype}")
    n = S.shape[-1]
    if S.dtype == torch.float64 or not kernels.jacobi_eigh_takes(n):
        return eigh_in_batches(S)
    lamb, V = kernels.jacobi_eigh(S.reshape(-1, n, n).contiguous())
    return lamb.reshape(S.shape[:-1]), V.reshape(S.shape)


def _symmetrised(S: torch.Tensor) -> torch.Tensor:
    return (S + S.transpose(-1, -2)) / 2


def herm_eigh_embed(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigh of the real ``2m x 2m`` embedding of Hermitian ``(..., m, m)``.

    Each eigenvalue of ``A`` comes doubled and adjacent after the ascending
    sort. Counterpart of ``splitc._herm_eigh_embed`` (splitc.py:1207-1226)
    with its ``"auto"`` routing: :func:`symm_eigh`.
    """
    return symm_eigh(_symmetrised(block_embed(A)).contiguous())


def prox_neg_logdet(
    G: torch.Tensor, step_size: float = 1.0, rel: Optional[float] = None, lift_null: bool = False
) -> torch.Tensor:
    """Prox of ``-step log|det W|`` at complex ``G (..., M, M)``: singular values ``s -> (s + sqrt(s^2 + 4 step)) / 2``.

    ``splitc.prox_neg_logdet_sc`` (splitc.py:2663-2784): one eigh of the
    embedded right Gram ``E(G)^T E(G) = V S^2 V^T``, ``B = E(G) V`` and
    ``W = B diag(f(s) / max(s, rel s_max)) V^T``. One change: ``s`` is the
    column norm of ``B`` (``||G v||``), not ``sqrt(lambda)``. The Gram's
    eigenvalue of a small singular value carries an absolute error of
    about ``eps s_max^2``, its column norm one of about ``eps s_max``. On
    HVA's ill-conditioned iterates the ``sqrt(lambda)`` route of the JAX
    package misses the reference fixture ``hva.npz`` after 10 float64
    iterations, and the column norm meets it (tests/test_torch_prox.py).
    ``rel`` defaults to
    1e-12 (float64) or 1e-6 (float32). With ``lift_null`` the left Gram
    ``E(G) E(G)^T`` rides the same eigh call (a batch of twice the
    matrices), directions whose pair of singular values lies under
    ``rel_null s_max`` get no shrinkage term, and each is lifted to exactly
    ``sqrt(step)`` by the sign-aligned left/right pair (ADMM's zero and
    rank-deficient iterates; ``G = 0`` gives ``sqrt(step) I``).
    """
    f64 = G.real.dtype == torch.float64
    if rel is None:
        rel = 1e-12 if f64 else 1e-6
    rel_null = max(rel, 1e-7 if f64 else 1e-3)
    n = G.shape[-1]

    G2 = block_embed(G)  # (..., 2M, 2M)
    G2T = G2.transpose(-1, -2)
    SR = _symmetrised(G2T @ G2)

    if not lift_null:
        V2 = symm_eigh(SR.contiguous())[1]  # eigenvalues sigma^2, doubled, ascending
        B2 = G2 @ V2
        sigma = torch.linalg.vector_norm(B2, dim=-2)
        divisor = torch.maximum(sigma, rel * sigma.amax(dim=-1, keepdim=True))
        ratio = neg_log(sigma, step_size=step_size) / divisor
        return _extract((B2 * ratio[..., None, :]) @ V2.transpose(-1, -2), n)

    SL = _symmetrised(G2 @ G2T)
    V2, U2 = symm_eigh(torch.stack([SR, SL], dim=0))[1]
    B2 = G2 @ V2
    sigma = torch.linalg.vector_norm(B2, dim=-2)
    shrunk = neg_log(sigma, step_size=step_size)

    # the two embedded copies of one complex sigma classify together
    sigma_max = sigma.amax(dim=-1, keepdim=True)
    thresh = rel_null * sigma_max
    pair_big = (sigma[..., 0::2] > thresh) | (sigma[..., 1::2] > thresh)  # (..., M)
    big = pair_big.repeat_interleave(2, dim=-1)
    divisor = torch.maximum(sigma, rel * sigma_max)
    ratio = torch.where(big, shrunk / divisor, torch.zeros_like(sigma))
    W2 = (B2 * ratio[..., None, :]) @ V2.transpose(-1, -2)

    # null-space lift in complex space: align each complex direction's two
    # embedded column outer products by the sign of
    # Re((u1^H u2)(v2^H v1)), then one embedded product with the
    # interleaved weights (wp, wp s) (splitc.py:2747-2780)
    u1r, u1i = U2[..., :n, 0::2], U2[..., n:, 0::2]
    u2r, u2i = U2[..., :n, 1::2], U2[..., n:, 1::2]
    v1r, v1i = V2[..., :n, 0::2], V2[..., n:, 0::2]
    v2r, v2i = V2[..., :n, 1::2], V2[..., n:, 1::2]
    ar = torch.sum(u1r * u2r + u1i * u2i, dim=-2)  # Re(u1^H u2)
    ai = torch.sum(u1r * u2i - u1i * u2r, dim=-2)
    br = torch.sum(v2r * v1r + v2i * v1i, dim=-2)  # Re(v2^H v1)
    bi = torch.sum(v2r * v1i - v2i * v1r, dim=-2)
    sign = torch.where(ar * br - ai * bi >= 0, 1.0, -1.0).to(sigma.dtype)
    wp = torch.where(pair_big, torch.zeros_like(sign), torch.full_like(sign, math.sqrt(step_size)))
    wcols = torch.stack([wp, wp * sign], dim=-1).reshape(*wp.shape[:-1], 2 * n)
    W2 = W2 + (U2 * wcols[..., None, :]) @ V2.transpose(-1, -2)
    return _extract(W2, n)


def prox_l21(Z: torch.Tensor, step_size: float = 1.0, axis: int = -2, bin_sum=None) -> torch.Tensor:
    """Group soft-thresholding of complex ``Z`` over ``axis`` (by default the bin axis of ``(..., N, I, T)``).

    Counterpart of ``splitc.prox_l21_sc`` (splitc.py:3608-3617). With
    ``bin_sum`` (``axis`` the bin axis, which ``Z`` holds a slice of) the
    group norm is summed over the bin group (one call); zero-padded bins add
    nothing to it.
    """
    if bin_sum is None:
        norm = torch.linalg.vector_norm(Z, dim=axis, keepdim=True)
    else:
        norm = bin_norm(Z.movedim(axis, -2), bin_sum).unsqueeze(axis)
    norm = torch.where(norm < step_size, torch.full_like(norm, step_size), norm)
    return torch.clamp(1 - step_size / norm, min=0) * Z


def _irfft_bins(a: torch.Tensor, n_real: int, n_fft: int, norm: str) -> torch.Tensor:
    """``irfft`` over the bin axis (-2) of the first ``n_real`` bins, first ``n_real`` samples, zero-padded back."""
    out = torch.fft.irfft(a[..., :n_real, :], n=n_fft, dim=-2, norm=norm)[..., :n_real, :]
    pad = a.shape[-2] - n_real
    return torch.nn.functional.pad(out, (0, 0, 0, pad)) if pad else out


def log_magnitude(Z: torch.Tensor, eps: float = 1e-10, flooring_fn: Optional[Callable] = None) -> torch.Tensor:
    """The first stage of :func:`harmonic_mask`: the floored log magnitude ``zeta``, real, of ``Z``'s shape.

    ``log max(|Z|, eps)``, or ``log flooring_fn(|Z|)`` when given.
    """
    magnitude = Z.abs()
    y = flooring_fn(magnitude) if flooring_fn is not None else torch.clamp(magnitude, min=eps)
    return torch.log(y)


def cepstral_mask(
    zeta: torch.Tensor, attenuation: float, mask_iter: int = 1, n_real: Optional[int] = None
) -> torch.Tensor:
    """The rest of :func:`harmonic_mask` from the log magnitude ``zeta (..., N, I, T)``: the mask, the same shape.

    Bins on axis -2, sources on axis -3; ``n_real`` as
    :func:`harmonic_mask` takes it.
    """
    n_bins = zeta.shape[-2]
    n_real = n_bins if n_real is None else n_real
    n_fft = 2 * (n_real - 1)
    if n_real != n_bins:
        valid = (torch.arange(n_bins, device=zeta.device) < n_real)[:, None]
        zeta = torch.where(valid, zeta, torch.zeros_like(zeta))
        zeta_mean = zeta.sum(dim=-2, keepdim=True) / n_real
        rho = torch.where(valid, zeta - zeta_mean, torch.zeros_like(zeta))
    else:
        zeta_mean = zeta.mean(dim=-2, keepdim=True)
        rho = zeta - zeta_mean

    nu = _irfft_bins(rho, n_real, n_fft, "backward")
    varsigma = torch.clamp(nu, max=1.0)
    for _ in range(mask_iter):
        varsigma = (1 - torch.cos(math.pi * varsigma)) / 2
    xi = _irfft_bins(varsigma * nu, n_real, n_fft, "forward")
    m = 2 * (xi + zeta_mean)
    v = torch.exp(m - m.max(dim=-3, keepdim=True).values)
    return (v / v.sum(dim=-3, keepdim=True)) ** attenuation


def harmonic_mask(
    Z: torch.Tensor,
    attenuation: float,
    mask_iter: int = 1,
    eps: float = 1e-10,
    n_real: Optional[int] = None,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """HVA's cepstral cosine-shrinkage mask: real ``(N, I, T)`` for complex ``Z (N, I, T)``.

    Counterpart of ``splitc.harmonic_mask_sc`` (splitc.py:2787-2840) and
    the class closure of ``ssspy_tpu/bss/hva.py:27-51``: floored log
    magnitude (:func:`log_magnitude`), then :func:`cepstral_mask`:
    ``irfft`` over bins (``norm="backward"``), cosine shrinkage
    ``mask_iter`` times, ``irfft`` back (``norm="forward"``), then a
    softmax over sources with the maximum subtracted, to the power
    ``attenuation``. The floor is ``max(|Z|, eps)``, or ``flooring_fn(|Z|)``
    when given (the classes' ``flooring_fn``). ``n_real``: the true bin
    count when the bin axis carries trailing zero padding; the transform
    and the log-magnitude mean then cover the first ``n_real`` bins, and a
    padded bin's mask is the softmax of the mean alone. Any leading batch
    axes.
    """
    return cepstral_mask(log_magnitude(Z, eps, flooring_fn), attenuation, mask_iter=mask_iter, n_real=n_real)


def gathered_harmonic_mask(
    Z: torch.Tensor,
    attenuation: float,
    bin_sum,
    bins: Tuple[int, int],
    mask_iter: int = 1,
    eps: float = 1e-10,
) -> torch.Tensor:
    """:func:`harmonic_mask` of a rank's slice ``Z (..., N, I_local, T)`` of the bins, the whole axis gathered once.

    ``bins = (first, n_bins)``: the global index of the rank's first bin and
    the global bin count; the rank's bins past ``n_bins`` are padding. Each
    rank writes the floored log magnitude of its real bins into a zero-filled
    buffer of ``n_bins`` bins and one call of ``bin_sum`` sums the buffers:
    exact, since every entry has one nonzero term. Then every rank runs the
    unchanged :func:`cepstral_mask` over the whole axis (two ``irfft`` on
    cuFFT) and keeps its own bins; a padded bin's mask is zero (its
    spectrogram is zero and its result is dropped). One call of the hook,
    where the JAX runner's DFT-as-matmul transform all-reduces twice
    (tests/parallel/test_hlo_collectives.py:259).
    """
    first, n_bins = bins
    n_local = Z.shape[-2]
    real = max(0, min(n_local, n_bins - first))
    zeta = log_magnitude(Z, eps)
    full = torch.zeros(zeta.shape[:-2] + (n_bins, zeta.shape[-1]), dtype=zeta.dtype, device=zeta.device)
    full.narrow(-2, first, real).copy_(zeta.narrow(-2, 0, real))
    (full,) = bin_sum(full)
    mask = cepstral_mask(full, attenuation, mask_iter=mask_iter).narrow(-2, first, real)
    return torch.nn.functional.pad(mask, (0, 0, 0, n_local - real)) if n_local > real else mask


# ---- primal-dual splitting ------------------------------------------------------


def _relax(a: float, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return a * new + (1 - a) * old


def pds_step(
    X: torch.Tensor,
    W: torch.Tensor,
    Y: torch.Tensor,
    dual_prox: Callable[[torch.Tensor], torch.Tensor],
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One primal-dual splitting iteration; returns ``(W, Y)``.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``;
    ``Y``: dual ``(N, I, T)``, or ``(Q, N, I, T)`` with one dual per
    penalty. ``W~ = prox_neglogdet(W - mu1 mu2 (sum_q Y_q) X^H)``, the
    reflected separation ``Z = Y + X(2 W~ - W)`` and ``Y~ = dual_prox(Z)``,
    then the relaxation (ssspy_tpu/bss/pdsbss.py:167-190, :375-395;
    splitc.py:3620-3655). ``relaxation == 1`` skips the blend. Any
    leading batch axes on all three (the penalty axis then after them).
    """
    Y_sum = Y.sum(dim=-4) if Y.dim() > X.dim() else Y
    XY = torch.einsum("...nit,...mit->...inm", Y_sum, X.conj())  # sum_t y conj(x), per bin
    Wt = prox_neg_logdet(W - mu1 * mu2 * XY, step_size=mu1)
    Yt = dual_prox(Y + separate(X, 2 * Wt - W))
    if relaxation == 1:
        return Wt, Yt
    return _relax(relaxation, Wt, W), _relax(relaxation, Yt, Y)


def pds_iva_step(
    X: torch.Tensor, W: torch.Tensor, Y: torch.Tensor, mu1: float = 1.0, mu2: float = 1.0,
    relaxation: float = 1.0, bin_sum=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One PDSIVA iteration (L21 penalty over bins): ``Y~ = Z - prox_l21(Z, 1/mu2)``.

    Counterpart of ``splitc.pds_iva_step_sc`` (splitc.py:3620-3655);
    ``Y``: ``(N, I, T)``. Returns ``(W, Y)``. Batched and ``bin_sum`` as
    the module describes: one call of the hook, the group norm.
    """
    return pds_step(X, W, Y, lambda Z: Z - prox_l21(Z, step_size=1 / mu2, bin_sum=bin_sum), mu1, mu2, relaxation)


def hva_pds_step(
    X: torch.Tensor,
    W: torch.Tensor,
    Y: torch.Tensor,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    attenuation: Optional[float] = None,
    mask_iter: int = 1,
    eps: float = 1e-10,
    n_real: Optional[int] = None,
    bin_sum=None,
    bins: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One HVA (masking PDS) iteration: ``Y~ = Z - mask(Z) Z`` with :func:`harmonic_mask`.

    Counterpart of ``splitc.hva_pds_step_sc`` (splitc.py:2843-2899);
    ``attenuation`` defaults to ``1 / N``. Returns ``(W, Y)``. Batched as
    the module describes; with ``bin_sum`` the mask is
    :func:`gathered_harmonic_mask` over ``bins = (first, n_bins)`` (one
    call of the hook), and ``n_real`` is not taken.
    """
    attenuation = 1.0 / Y.shape[-3] if attenuation is None else attenuation

    def dual_prox(Z):
        if bin_sum is not None:
            return Z - gathered_harmonic_mask(Z, attenuation, bin_sum, bins, mask_iter=mask_iter, eps=eps) * Z
        return Z - harmonic_mask(Z, attenuation, mask_iter=mask_iter, eps=eps, n_real=n_real) * Z

    return pds_step(X, W, Y, dual_prox, mu1, mu2, relaxation)


def prox_iva_loss(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """PDSIVA / ADMMIVA loss ``sum_{n,t} ||y_n(., t)|| - sum_i log|det W_i|``, a 0-dim tensor.

    Counterpart of ``splitc.prox_iva_loss_sc`` (splitc.py:4422-4434).
    """
    penalty = torch.linalg.vector_norm(separate(X, W), dim=1).sum()
    return penalty - clogabsdet(W).sum()


# ---- ADMM ---------------------------------------------------------------------------


def admm_quad_inv(X: torch.Tensor, n_penalties: int = 1) -> torch.Tensor:
    """``(Q X X^H + I)^{-1}`` per bin, ``(I, M, M)``: the loop-invariant operator of ADMM's ``W`` update.

    Counterpart of ``splitc.admm_quad_inv_sc`` (splitc.py:3658-3676);
    ``Q = n_penalties`` (the penalty-list classes, admmbss.py:301). Taken
    once, outside the loop, with ``inv_ex``. A batch ``X (B, M, I, T)``
    gives ``(B, I, M, M)``.
    """
    n_channels = X.shape[-3]
    XX = torch.einsum("...mit,...pit->...imp", X.conj(), X)
    E = torch.eye(n_channels, dtype=X.dtype, device=X.device)
    return torch.linalg.inv_ex(n_penalties * XX + E)[0]


def admm_step(
    X: torch.Tensor,
    V: torch.Tensor,
    Vt: torch.Tensor,
    Y: torch.Tensor,
    Yt: torch.Tensor,
    spectrogram_prox: Callable[[torch.Tensor], torch.Tensor],
    rho: float = 1.0,
    relaxation: float = 1.0,
    *,
    quad_inv: torch.Tensor,
):
    """One ADMM iteration; returns ``(W, V, Vt, Y, Yt)``.

    ``V``/``Y``: filter-shaped auxiliary and dual ``(I, N, M)``;
    ``Vt``/``Yt``: spectrogram-shaped ``(N, I, T)``, or ``(Q, N, I, T)``
    with one pair per penalty. ``W = (Q X X^H + I)^{-1} (V - Y + (X^H
    sum_q (Vt_q - Yt_q))^T)`` (``quad_inv`` from :func:`admm_quad_inv`,
    taken once per run), the relaxed ``U``, ``V = prox_neglogdet(U + Y,
    1/rho)`` with the null lift, ``Vt = spectrogram_prox(Ut + Yt)``, and
    the dual ascent (ssspy_tpu/bss/admmbss.py:287-324;
    splitc.py:3679-3748). Any leading batch axes (the penalty axis then
    after them).
    """
    VT = Vt - Yt
    if VT.dim() > X.dim():
        VT = VT.sum(dim=-4)
    XVY = torch.einsum("...mit,...nit->...imn", X.conj(), VT)
    W = quad_inv @ (V - Y + XVY.transpose(-2, -1))
    XW = separate(X, W)

    if relaxation == 1:
        U, Ut = W, XW
    else:
        U, Ut = _relax(relaxation, W, V), _relax(relaxation, XW, Vt)

    V = prox_neg_logdet(U + Y, step_size=1 / rho, lift_null=True)
    Vt = spectrogram_prox(Ut + Yt)
    return W, V, Vt, Y + U - V, Yt + Ut - Vt


def admm_iva_step(
    X: torch.Tensor,
    V: torch.Tensor,
    Vt: torch.Tensor,
    Y: torch.Tensor,
    Yt: torch.Tensor,
    rho: float = 1.0,
    relaxation: float = 1.0,
    *,
    quad_inv: torch.Tensor,
    bin_sum=None,
):
    """One ADMMIVA iteration (L21 penalty over bins); returns ``(W, V, Vt, Y, Yt)``.

    Counterpart of ``splitc.admm_iva_step_sc`` (splitc.py:3679-3748).
    Batched and ``bin_sum`` as the module describes: one call of the hook,
    the group norm.
    """
    return admm_step(
        X, V, Vt, Y, Yt, lambda Z: prox_l21(Z, step_size=1 / rho, bin_sum=bin_sum), rho, relaxation,
        quad_inv=quad_inv,
    )


def hva_admm_step(
    X: torch.Tensor,
    V: torch.Tensor,
    Vt: torch.Tensor,
    Y: torch.Tensor,
    Yt: torch.Tensor,
    rho: float = 1.0,
    relaxation: float = 1.0,
    attenuation: Optional[float] = None,
    mask_iter: int = 1,
    eps: float = 1e-10,
    n_real: Optional[int] = None,
    *,
    quad_inv: torch.Tensor,
):
    """One MaskingADMMHVA iteration: ``Vt = mask(Z) Z`` with :func:`harmonic_mask`.

    Counterpart of ``splitc.hva_admm_step_sc`` (splitc.py:4437-4511);
    ``attenuation`` defaults to ``1 / N``. Returns ``(W, V, Vt, Y, Yt)``.
    """
    attenuation = 1.0 / Vt.shape[0] if attenuation is None else attenuation

    def spectrogram_prox(Z):
        return harmonic_mask(Z, attenuation, mask_iter=mask_iter, eps=eps, n_real=n_real) * Z

    return admm_step(X, V, Vt, Y, Yt, spectrogram_prox, rho, relaxation, quad_inv=quad_inv)
