"""The AuxIVA iterations (IP1, IP2, ISS1, ISS2, IPA), the gradient IVA step and their loss on native complex tensors.

Counterparts of the split-complex functions in ``ssspy_tpu/ops/splitc.py``;
the port carries complex tensors, so the ``[real, imag]`` planes and the
``_sc`` suffix are gone. The kernels are looked up on
:mod:`ssspy_tpu_torch.ops.kernels` at each call.

Three of them are reached only through a router of this module, which
chooses by dtype and shape before any launch, on every device alike:
:func:`covariance` (K1), :func:`ip1_update` (K1b) and :func:`iss1_update`
(K2). The pairwise updates IP2 and ISS2 and the gradient step run no kernel
of their own: IP2 reaches K1 through :func:`covariance`, and the rest is
batched PyTorch operations, as the JAX package keeps them in XLA. complex64 within the kernel's sizes goes to the kernel wrapper (the
kernel on the card, its plain version on the CPU); complex128, and any
size the kernel does not take, goes to the plain version on the same
device. No kernel failure is caught: a wrapper still refuses what its
kernel does not take, and only the routers decide.

The IP1, ISS1, IP2, ISS2 and IPA steps and the gradient steps also take a batch of utterances on
a leading axis (``X (B, M, I, T)``, ``W (B, I, N, M)``, ``Y (B, N, I,
T)``), as the multi-device runners of :mod:`ssspy_tpu_torch.parallel`
call them. The routers then fold the utterances into the bin axis where a
kernel takes the fold for free (K1b at ``(B I, N, M)``) and loop over
them otherwise (K1 and K2, one launch per utterance on its contiguous
slice, with the single-utterance weights). Each step takes ``bin_sum``:
``None`` runs the single-device code; a
:class:`~ssspy_tpu_torch.parallel.collectives.BinAllReduce` sums the
step's cross-bin partials (the Laplace norm) over the bin group, one call
for every utterance of the batch.
"""

from typing import Callable, Iterable, Optional, Tuple

import torch

from ..linalg.eigh import gevd2
from ..special.flooring import floor
from ..utils.select_pair import sequential_pair_selector
from . import kernels

__all__ = [
    "covariance",
    "ip1_update",
    "iss1_update",
    "separate",
    "bin_norm",
    "auxiva_ip1_step",
    "auxiva_iss1_step",
    "auxiva_ipa_step",
    "ip2_pair_update",
    "ip2_update",
    "auxiva_ip2_step",
    "iss2_sweep",
    "auxiva_iss2_step",
    "grad_iva_step",
    "grad_laplace_iva_step",
    "clogabsdet",
    "ls_demix",
    "iva_laplace_loss",
]


def separate(X: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Per-bin demixing ``y_i = W_i x_i``: ``(I,N,M) x (M,I,T) -> (N,I,T)``, or ``(B, N, I, T)`` for a batch.

    Counterpart of ``splitc._csep`` (splitc.py:242-253). The einsum is a
    product batched over bins, whose ``(N, I, T)`` view is permuted; the
    copy makes it contiguous, as the ISS1 kernel takes it.
    """
    return torch.einsum("...inm,...mit->...nit", W, X).contiguous()


def covariance(X: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """``U[i,n] = mean_t varphi[n,(i),t] x_it x_it^H``, ``(I, N, M, M)``, routed by dtype and shape.

    K1 (:func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance`) for
    complex64 ``X`` with float32 weights within
    :func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance_takes` (``N M
    (M + 1) / 2 <= 8,192``); the einsum
    (:func:`~ssspy_tpu_torch.ops.kernels.weighted_covariance_plain`)
    otherwise, as the JAX package falls back by shape
    (pallas_kernels.py:167-177). A batch ``X (B, M, I, T)`` with weights
    ``(B, N, T)`` or ``(B, N, I, T)`` gives ``(B, I, N, M, M)``, one call
    per utterance.
    """
    if X.dim() == 4:
        return torch.stack([covariance(X[b], varphi[b]) for b in range(X.shape[0])])
    if (
        X.dtype == torch.complex64
        and varphi.dtype == torch.float32
        and kernels.weighted_covariance_takes(X.shape[0], varphi.shape[0])
    ):
        return kernels.weighted_covariance(X.contiguous(), varphi.contiguous())
    return kernels.weighted_covariance_plain(X, varphi)


def ip1_update(
    W: torch.Tensor, U: torch.Tensor, eps: float = 1e-10, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """The sequential IP1 sweep of ``W (I, N, M)`` over ``U (I, N, M, M)``, routed by dtype, shape and floor.

    K1b (:func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep`) for complex64 with
    ``N = M <= 17`` (:func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep_takes`);
    :func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep_plain` with its ``"lu"``
    solve (``solve_ex``) otherwise, the route the CPU classes meet the
    fixtures with. A batch ``W (B, I, N, M)``, ``U (B, I, N, M, M)`` is
    folded into its bins, one sweep for all. A ``flooring_fn`` (one that is
    not ``max(., eps)``; the kernel floors with an ``eps``) takes the plain
    sweep with the callable in place of ``max(., eps)``, on every device.
    """
    if W.dim() == 4:
        return ip1_update(W.flatten(0, 1), U.flatten(0, 1), eps=eps, flooring_fn=flooring_fn).view(W.shape)
    n_sources, n_channels = W.shape[-2:]
    if (
        flooring_fn is None
        and W.dtype == U.dtype == torch.complex64
        and n_sources == n_channels
        and kernels.ip1_sweep_takes(n_channels)
    ):
        return kernels.ip1_sweep(W.contiguous(), U.contiguous(), eps=eps)
    return kernels.ip1_sweep_plain(W, U, eps=eps, flooring_fn=flooring_fn)


def iss1_update(
    Y: torch.Tensor, varphi: torch.Tensor, eps: float = 1e-10, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """The sequential ISS1 sweep of ``Y (N, I, T)`` with weights ``(N, T)`` or ``(N, I, T)``, routed by dtype, shape and floor.

    K2 (:func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep`) for complex64 ``Y``
    with float32 weights and ``N <= 16``
    (:func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep_takes`);
    :func:`~ssspy_tpu_torch.ops.kernels.iss1_sweep_plain` otherwise. A
    batch ``Y (B, N, I, T)`` with weights ``(B, N, T)`` or ``(B, N, I, T)``
    takes one sweep per utterance. A ``flooring_fn`` takes the plain sweep
    with the callable, as :func:`ip1_update` does.
    """
    if Y.dim() == 4:
        return torch.stack([iss1_update(Y[b], varphi[b], eps=eps, flooring_fn=flooring_fn) for b in range(Y.shape[0])])
    if (
        flooring_fn is None
        and Y.dtype == torch.complex64
        and varphi.dtype == torch.float32
        and kernels.iss1_sweep_takes(Y.shape[0])
    ):
        return kernels.iss1_sweep(Y.contiguous(), varphi.contiguous(), eps=eps)
    return kernels.iss1_sweep_plain(Y, varphi, eps=eps, flooring_fn=flooring_fn)


def bin_norm(Y: torch.Tensor, bin_sum=None) -> torch.Tensor:
    """``||y_n(., t)||``, the norm over the bins (axis -2) of ``(..., N, I, T)``: ``(..., N, T)``.

    With ``bin_sum`` the squared magnitudes are summed over the rank's bins,
    then over the bin group (one call), then rooted.
    """
    if bin_sum is None:
        return torch.linalg.vector_norm(Y, dim=-2)
    return torch.sqrt(bin_sum((Y.real.square() + Y.imag.square()).sum(dim=-2))[0])


def _laplace_varphi(Y: torch.Tensor, eps: float, bin_sum=None) -> torch.Tensor:
    """Laplace weight ``1 / max(||y_n(., t)||, eps)`` with the norm over the bins (:func:`bin_norm`): ``(..., N, T)``."""
    return 1.0 / torch.clamp(bin_norm(Y, bin_sum), min=eps)


def auxiva_ip1_step(X: torch.Tensor, W: torch.Tensor, eps: float = 1e-10, bin_sum=None) -> torch.Tensor:
    """One AuxIVA-IP1 iteration; returns the new demixing filters.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``.
    Laplace weight ``phi = 1 / max(||y_n||, eps)`` with the norm over bins,
    the weighted covariance, then the IP1 sweep. Counterpart of
    ``splitc.auxiva_ip1_step_sc`` (splitc.py:256-278). Batched and
    ``bin_sum`` as the module describes.
    """
    return ip1_update(W, covariance(X, _laplace_varphi(separate(X, W), eps, bin_sum)), eps=eps)


def auxiva_iss1_step(Y: torch.Tensor, eps: float = 1e-10, bin_sum=None) -> torch.Tensor:
    """One AuxIVA-ISS1 iteration on the separated spectrograms ``(N, I, T)``.

    ISS carries no demixing matrix: the Laplace weight ``(N, T)``, then the
    ISS1 sweep. Counterpart of ``splitc.auxiva_iss1_step_sc``
    (splitc.py:401-411). Batched and ``bin_sum`` as the module describes.
    """
    return iss1_update(Y, _laplace_varphi(Y, eps, bin_sum), eps=eps)


def auxiva_ipa_step(
    Y: torch.Tensor,
    eps: float = 1e-10,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    secular_impl: str = "eigh",
    bin_sum=None,
) -> torch.Tensor:
    """One AuxIVA-IPA iteration on the separated spectrograms ``(N, I, T)``.

    Demix-free, as ISS: the Laplace weight ``(N, T)``, then the IPA sweep
    (:func:`ssspy_tpu_torch.ops.ipa_steps.ipa_sweep`: the congruence sweep
    in complex64, the reference's data flow in complex128; ``secular_impl``
    as it takes it). Counterpart of
    ``splitc.auxiva_ipa_step_sc`` (splitc.py:2235-2264). Batched and
    ``bin_sum`` as the module describes; a batch takes one sweep per
    utterance.
    """
    from .ipa_steps import ipa_sweep  # ipa_steps imports prox_steps, which imports this module

    def sweep(Y, varphi):
        return ipa_sweep(
            Y, varphi, eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter,
            secular_impl=secular_impl,
        )

    varphi = _laplace_varphi(Y, eps, bin_sum)
    if Y.dim() == 4:
        return torch.stack([sweep(Y[b], varphi[b]) for b in range(Y.shape[0])])
    return sweep(Y, varphi)


# ---- IP2: pairwise iterative projection ------------------------------------------------------


PairSelector = Callable[[int], Iterable[Tuple[int, int]]]


def _pairs(n_sources: int, pair_selector: Optional[PairSelector]):
    """The sweep's ``(m, n)`` pairs, negative indices taken modulo ``n_sources``."""
    pair_selector = sequential_pair_selector if pair_selector is None else pair_selector
    return [(m % n_sources, n % n_sources) for m, n in pair_selector(n_sources)]


def _pair_rows(A: torch.Tensor, pair: Tuple[int, int], dim: int) -> torch.Tensor:
    """Rows ``m`` and ``n`` of ``A`` along ``dim``, stacked there in that order."""
    m, n = pair
    return torch.stack([A.select(dim, m), A.select(dim, n)], dim=dim)


def _set_pair_rows(A: torch.Tensor, pair: Tuple[int, int], rows: torch.Tensor, dim: int) -> torch.Tensor:
    """``A`` with its rows ``m`` and ``n`` along ``dim`` replaced by ``rows`` (stacked there in that order)."""
    out = list(A.unbind(dim))
    out[pair[0]], out[pair[1]] = rows.unbind(dim)
    return torch.stack(out, dim=dim)


def _quad(h: torch.Tensor, G: torch.Tensor) -> torch.Tensor:
    """``Re(h^H G h)`` for ``h (..., 2)`` and Hermitian ``G (..., 2, 2)``, from the real diagonal and ``G[0, 1]``."""
    h0, h1 = h[..., 0], h[..., 1]
    cross = (G[..., 0, 1] * h0.conj() * h1).real
    return G[..., 0, 0].real * (h0.real.square() + h0.imag.square()) + G[..., 1, 1].real * (
        h1.real.square() + h1.imag.square()
    ) + 2 * cross


def ip2_pair_update(
    W: torch.Tensor,
    U_m: torch.Tensor,
    U_n: torch.Tensor,
    pair: Tuple[int, int],
    eps: float = 1e-10,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """One IP2 pair update: the new rows ``m`` and ``n`` of ``W (I, N, M)``, as ``(I, 2, M)``.

    Counterpart of ``splitc.ip2_pair_update_sc`` (splitc.py:934-1035;
    parity: ssspy/bss/_update_spatial_model.py:317-395). Both pair systems
    ``(W U) P = E_mn`` are one batched ``solve_ex`` over a new leading axis
    of 2; the pencils ``G = P^H U P`` go through :func:`~ssspy_tpu_torch.linalg.eigh.gevd2`;
    ``h_m`` is the eigenvector of the larger eigenvalue, ``h_n`` of the
    smaller, each normalized by ``max(sqrt(h^H G h), eps)``, and the rows
    are stored conjugated. A bin whose pencil is degenerate (``h^H G h > 0``
    fails for either row; NaN fails too) keeps its old rows. Any ``(m, n)``
    with ``m != n``. A batch ``W (B, I, N, M)`` with ``U_m``, ``U_n`` ``(B,
    I, M, M)`` gives ``(B, I, 2, M)``. ``flooring_fn`` replaces
    ``max(., eps)`` on the norms, as ``update_by_ip2_one_pair`` floors them
    (ssspy_tpu/bss/_update_spatial_model.py:146).
    """
    m, n = pair
    n_channels = W.shape[-1]
    eye = torch.eye(n_channels, dtype=W.dtype, device=W.device)
    E = torch.stack([eye[:, m], eye[:, n]], dim=-1)  # (M, 2)
    U = torch.stack([U_m, U_n])  # (2, I, M, M)
    P = torch.linalg.solve_ex(W @ U, E.expand(*U.shape[:-1], 2))[0]  # (2, [B,] I, M, 2)
    G = P.mH @ U @ P  # (2, [B,] I, 2, 2)
    lo, hi = gevd2(G[0], G[1])
    h = torch.stack([hi, lo])  # (2, [B,] I, 2): h_m, h_n
    quad = _quad(h, G)  # (2, [B,] I)
    h = h / floor(torch.sqrt(torch.clamp(quad, min=0.0)), eps, flooring_fn)[..., None].to(h.dtype)
    rows = (P @ h[..., None])[..., 0].conj().movedim(0, -2)  # ([B,] I, 2, M)
    valid = ((quad[0] > 0) & (quad[1] > 0))[..., None, None]
    return torch.where(valid, rows, _pair_rows(W, pair, dim=-2))


def ip2_update(
    W: torch.Tensor,
    U: torch.Tensor,
    eps: float = 1e-10,
    pair_selector: Optional[PairSelector] = None,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """The IP2 sweep of ``W (I, N, M)`` over fixed covariances ``U (I, N, M, M)``, one pair update per pair.

    ILRMA's and FastGaussMNMF's form: the covariances come from the source
    model once per iteration and every pair reads its two rows of them
    (splitc.py:540-549, :2448-2457; ssspy_tpu/bss/_update_spatial_model.py:80-106).
    """
    for pair in _pairs(W.shape[1], pair_selector):
        m, n = pair
        W = _set_pair_rows(W, pair, ip2_pair_update(W, U[:, m], U[:, n], pair, eps=eps, flooring_fn=flooring_fn), dim=1)
    return W


def auxiva_ip2_step(
    X: torch.Tensor,
    W: torch.Tensor,
    eps: float = 1e-10,
    pair_selector: Optional[PairSelector] = None,
    varphi_of: Optional[Callable[[torch.Tensor, Tuple[int, int]], torch.Tensor]] = None,
    bin_sum=None,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """One AuxIVA-IP2 iteration; returns the new demixing filters ``(I, N, M)``.

    For each pair: the pair's two current rows separate ``X``, their weights
    ``(2, T)`` (``varphi_of(Y_pair, pair)``; the Laplace weight
    ``1 / max(||y||, eps)`` by default) give the two covariances through
    :func:`covariance` (K1 at ``N = 2``), then :func:`ip2_pair_update`.
    Every pair re-reads ``X``. Counterpart of ``splitc.auxiva_ip2_step_sc``
    (splitc.py:1038-1072) with any ``pair_selector`` (sequential by
    default), as the JAX class's step (ssspy_tpu/bss/iva.py:955-968).
    Batched and ``bin_sum`` as the module describes: one call of the hook
    per pair, the Laplace norm of the pair's rows. ``flooring_fn`` goes to
    :func:`ip2_pair_update`.
    """
    for pair in _pairs(W.shape[-2], pair_selector):
        Y = separate(X, _pair_rows(W, pair, dim=-2))  # ([B,] 2, I, T)
        varphi = _laplace_varphi(Y, eps, bin_sum) if varphi_of is None else varphi_of(Y, pair)
        U = covariance(X, varphi)  # ([B,] I, 2, M, M)
        rows = ip2_pair_update(W, U[..., 0, :, :], U[..., 1, :, :], pair, eps=eps, flooring_fn=flooring_fn)
        W = _set_pair_rows(W, pair, rows, dim=-2)
    return W


# ---- ISS2: pairwise iterative source steering -------------------------------------------------


def iss2_sweep(
    Y: torch.Tensor,
    varphi: torch.Tensor,
    eps: float = 1e-10,
    tiny: float = 1e-20,
    pair_selector: Optional[PairSelector] = None,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """The ISS2 sweep of ``Y (N, I, T)`` with weights ``(N, T)`` (IVA) or ``(N, I, T)`` (ILRMA).

    For each pair ``(m, n)`` every other row ``s`` gets
    ``Y_s += conj(q_1) Y_m + conj(q_2) Y_n`` with ``q = -G_s^-1 f_s`` from the
    2 x 2 weighted covariance ``G_s`` of the pair and its cross terms
    ``f_s`` (the determinant floored at ``tiny`` with its sign), and the
    pair is rotated by the :func:`~ssspy_tpu_torch.linalg.eigh.gevd2` of
    ``(G_m, G_n)``: row ``m`` takes the eigenvector of the smaller
    eigenvalue, row ``n`` the larger, each normalized by
    ``max(sqrt(h^H G h), eps)``. All rows' statistics come from the pair's
    rows as they entered. Counterpart of ``splitc.iss2_sweep_sc``
    (splitc.py:1089ff; parity: ssspy/bss/_update_spatial_model.py:197-314)
    with any ``pair_selector``; no kernel, as in the JAX package.
    ``flooring_fn`` replaces ``max(., eps)`` on the pair's norms, as
    ``update_by_iss2`` floors them (ssspy_tpu/bss/_update_spatial_model.py:243).
    """
    n_sources, n_frames = Y.shape[0], Y.shape[-1]
    phi = varphi.to(Y.dtype)
    if phi.dim() == 2:
        phi = phi[:, None, :]  # (N, 1, T): the einsums broadcast it over the bins
    for pair in _pairs(n_sources, pair_selector):
        Y_main = _pair_rows(Y, pair, dim=0)  # (2, I, T)
        # weighted means per row s and bin: the pair's powers, its cross term, and f_s
        power = (Y_main.real.square() + Y_main.imag.square()).to(Y.dtype)
        g = torch.einsum("sit,ait->sia", phi, power).real / n_frames  # (N, I, 2)
        g12 = torch.einsum("sit,it->si", phi, Y_main[0] * Y_main[1].conj()) / n_frames
        f = torch.einsum("sit,ait,sit->sia", phi, Y_main, Y.conj()) / n_frames
        g11, g22 = g[..., 0], g[..., 1]

        det = g11 * g22 - (g12.real.square() + g12.imag.square())
        tiny_det = torch.full_like(det, tiny)
        det = torch.where(det.abs() < tiny, torch.where(det < 0, -tiny_det, tiny_det), det)
        f1, f2 = f[..., 0], f[..., 1]
        q = -torch.stack([g22 * f1 - g12 * f2, g11 * f2 - g12.conj() * f1], dim=-1) / det[..., None]

        # the pair: G_m, G_n are rows m and n of the statistics
        G = torch.stack(
            [torch.stack([g11.to(Y.dtype), g12], dim=-1), torch.stack([g12.conj(), g22.to(Y.dtype)], dim=-1)],
            dim=-2,
        )  # (N, I, 2, 2)
        G_pair = _pair_rows(G, pair, dim=0)
        lo, hi = gevd2(G_pair[0], G_pair[1])
        h = torch.stack([lo, hi])  # (2, I, 2): row m, row n
        d = floor(torch.sqrt(torch.clamp(_quad(h, G_pair), min=0.0)), eps, flooring_fn)
        p = h / d[..., None].to(h.dtype)

        coef = _set_pair_rows(q, pair, p, dim=0).conj()  # (N, I, 2)
        corr = torch.einsum("sia,ait->sit", coef, Y_main)
        Y = _set_pair_rows(Y + corr, pair, _pair_rows(corr, pair, dim=0), dim=0)
    return Y


def auxiva_iss2_step(Y: torch.Tensor, eps: float = 1e-10, tiny: float = 1e-20, bin_sum=None) -> torch.Tensor:
    """One AuxIVA-ISS2 iteration on the separated spectrograms ``(N, I, T)``.

    The Laplace weight ``(N, T)`` from the entering ``Y``, once per
    iteration, then :func:`iss2_sweep`. Counterpart of
    ``splitc.auxiva_iss2_step_sc`` (splitc.py:1075-1086). Batched and
    ``bin_sum`` as the module describes; a batch takes one sweep per
    utterance.
    """
    varphi = _laplace_varphi(Y, eps, bin_sum)
    if Y.dim() == 4:
        return torch.stack([iss2_sweep(Y[b], varphi[b], eps=eps, tiny=tiny) for b in range(Y.shape[0])])
    return iss2_sweep(Y, varphi, eps=eps, tiny=tiny)


# ---- gradient IVA --------------------------------------------------------------------------------


def grad_iva_step(
    W: torch.Tensor,
    Y: torch.Tensor,
    Phi: torch.Tensor,
    step_size: float = 1e-1,
    is_holonomic: bool = True,
    natural: bool = False,
) -> torch.Tensor:
    """One gradient IVA step of ``W (I, N, M)`` from ``Y = W X`` and the score ``Phi (N, I, T)``.

    ``PhiY[i] = mean_t Phi_t y_t^H``; the direction is ``PhiY - I``
    (holonomic) or ``PhiY`` off the diagonal, applied to ``W`` (natural) or
    to ``W^-H`` (vanilla, one ``solve_ex`` of ``W^H Z = I``). Counterpart of
    ``splitc._grad_direction_sc`` and ``grad_laplace_iva_step_sc``
    (splitc.py:4046-4097) and of the JAX class's ``_grad_step``
    (ssspy_tpu/bss/iva.py:425-448). Any leading batch axes.
    """
    PhiY = torch.einsum("...nit,...mit->...inm", Phi, Y.conj()) / Y.shape[-1]
    eye = torch.eye(W.shape[-2], dtype=W.dtype, device=W.device)
    direction = PhiY - eye if is_holonomic else (1 - eye) * PhiY
    if natural:
        return W - step_size * (direction @ W)
    W_inv_H = torch.linalg.solve_ex(W.mH, eye.expand(W.shape))[0]
    return W - step_size * (direction @ W_inv_H)


def grad_laplace_iva_step(
    X: torch.Tensor,
    W: torch.Tensor,
    step_size: float = 1e-1,
    is_holonomic: bool = True,
    natural: bool = False,
    eps: float = 1e-10,
    bin_sum=None,
) -> torch.Tensor:
    """One Grad/NaturalGrad Laplace-IVA iteration: the score ``y / max(||y||, eps)``, norm over bins.

    Counterpart of ``splitc.grad_laplace_iva_step_sc`` (splitc.py:4055-4097).
    Batched and ``bin_sum`` as the module describes: one call of the hook,
    the norm.
    """
    Y = separate(X, W)
    Phi = Y / torch.clamp(bin_norm(Y, bin_sum), min=eps)[..., None, :]
    return grad_iva_step(W, Y, Phi, step_size=step_size, is_holonomic=is_holonomic, natural=natural)


def clogabsdet(W: torch.Tensor) -> torch.Tensor:
    """``log|det W|`` of batched complex square matrices ``(..., N, N) -> (...)``.

    Counterpart of ``splitc.clogabsdet_sc`` (splitc.py:4148-4167). That
    one squares W into its Gram matrix (about 1e-3 relative in f32) because
    the TPU path has no complex LU; here the LU of ``slogdet`` runs on W
    itself.
    """
    return torch.linalg.slogdet(W)[1]


def ls_demix(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Least-squares demixing filter ``W = Y X^H (X X^H)^{-1}`` per bin: ``(I, N, M)``.

    Recovers the implicit demixing matrix of a demix-free (ISS) state.
    Counterpart of ``splitc.ls_demix_sc`` (splitc.py:4170-4187); the
    inverse is ``inv_ex``, so a singular bin gives non-finite values
    instead of an exception.
    """
    Xb = X.transpose(0, 1)  # (I, M, T)
    XH = Xb.transpose(-2, -1).conj()
    return Y.transpose(0, 1) @ XH @ torch.linalg.inv_ex(Xb @ XH)[0]


def iva_laplace_loss(
    X: torch.Tensor, W: Optional[torch.Tensor] = None, Y: Optional[torch.Tensor] = None, bin_sum=None
) -> torch.Tensor:
    """AuxLaplaceIVA negative log-likelihood, a 0-dim tensor on the input's device.

    ``sum_n mean_t 2 ||y_n(., t)|| - 2 sum_i log|det W_i|``. Pass ``W`` for
    the demix-filter state (IP) or ``Y`` for the demix-free state (ISS),
    whose ``W`` is recovered by :func:`ls_demix`. Counterpart of
    ``splitc.iva_laplace_loss_sc`` (splitc.py:4190-4207). With ``bin_sum``
    (the inputs one rank's bins) the squared norms and the log-determinants
    are summed over the bin group in one call: every rank gets the loss of
    all bins.
    """
    if W is not None:
        Y = separate(X, W)
    else:
        W = ls_demix(Y, X)
    if bin_sum is None:
        G = 2 * torch.linalg.vector_norm(Y, dim=1)  # (N, T)
        return G.mean(dim=-1).sum() - 2 * clogabsdet(W).sum()
    sq, logdet = bin_sum((Y.real.square() + Y.imag.square()).sum(dim=1), clogabsdet(W).sum())
    return (2 * torch.sqrt(sq)).mean(dim=-1).sum() - 2 * logdet
