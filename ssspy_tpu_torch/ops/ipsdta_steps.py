"""IPSDTA on native complex tensors: the MM + VCD iteration, its loss and its start.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``_ipsdta_model_sc``
(:3294-3308), ``_vcd_sweep_sc`` (:3311-3395), ``ipsdta_vcd_step_sc``
(:3408-3605) and ``ipsdta_loss_sc`` (:4352-4419), and of the PSDTF start of
``ssspy_tpu/bss/ipsdta.py`` (:226-267, :505-515) and ``ssspy_tpu/fast.py``
(:960-987).

The source model is a block-decomposed PSDTF: the ``I`` bins are cut into
``n_blocks`` blocks of ``J = I // n_blocks`` neighbours, the last
``I % n_blocks`` blocks one bin longer, and per source and block ``K`` PSD
``J x J`` basis matrices ``T_kb`` are mixed by activations ``v_kt`` into the
model ``R_tb = sum_k v_kt T_kb``. The two block sizes are two parts
(``T_parts``, each ``(N, K, B_p, J_p, J_p)``; :func:`part_shapes`). The
spatial update is vector-wise coordinate descent (VCD) on the demixing
filters ``W (I, N, M)``; IPSDTA separates as many sources as channels.

The routes follow the dtype, before any launch, as dense GaussMNMF's do
(:func:`~ssspy_tpu_torch.ops.mnmf_steps._routes`):

- complex64: the ridge model and the Cholesky geometric mean; the model's
  inverse is K3 (:func:`~ssspy_tpu_torch.ops.kernels.gj_inverse`), three
  launches per part per iteration (before the basis, the activation and the
  spatial update); the Gaussian basis update's geometric mean launches the
  Jacobi eigh K7 once per part (the ``2J x 2J`` embedding), the Student's-t
  update twice (``Q^1/2`` and ``M^-1/2``).
- complex128: the reference's eigenvalue-floored projections and the
  ``eigh2`` geometric mean through ``torch.linalg.eigh``; the inverse is
  ``inv_ex``.

By shape: K3 takes ``J <= 32`` and larger blocks take ``inv_ex``
(:func:`hermitian_inverse`); an embedding above ``n = 32`` takes
``torch.linalg.eigh`` (:func:`~ssspy_tpu_torch.ops.prox_steps.symm_eigh`).
Every product is full float32 (PyTorch keeps TF32 off for matmuls unless
asked): at reduced precision the JAX step went non-finite within 10
iterations (splitc.py:3449-3456).

:func:`ipsdta_vcd_step` also takes a batch of utterances on a leading axis
and ``bin_sum``, as the multi-device runner of
:mod:`ssspy_tpu_torch.parallel` calls it with whole blocks on each rank:
the activation update's numerator and denominator and the basis traces of
the normalization (sums over blocks) are summed over the bin group in one
call. The t model's frame weight, a sum over all bins, is not sharded.

A ``flooring_fn`` that is not ``max(., eps)`` replaces ``max(., eps)``
where the JAX complex class floors with its callable: the projections of
the basis update (``to_psd``, ssspy_tpu/bss/ipsdta.py:603-606, :775-780),
the t model's ``invsqrtmh`` (:779), the VCD sweep's singular test
``|xi_hat| < flooring_fn(0)`` (:643, :819) and the activation's start
(:270). The model keeps its projection at ``eps``, as that class's
``_block_reconstruct`` does (:56-59). The step then takes the
eigenvalue-floored route in either dtype (the ridge stands in for the
projections that the callable floors).
"""

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..special.flooring import floor
from ..special.psd import hermitize, spectral
from . import kernels
from .iva_steps import clogabsdet, separate
from .mnmf_steps import _routes, gmean2, psd_project

__all__ = [
    "part_shapes",
    "split_bins",
    "merge_bins",
    "hermitian_inverse",
    "model_inverse",
    "part_stats",
    "vcd_covariance",
    "vcd_sweep",
    "normalize_psdtf",
    "random_psdtf",
    "ipsdta_vcd_step",
    "ipsdta_loss",
]


def part_shapes(n_bins: int, n_blocks: int) -> List[Tuple[int, int]]:
    """``[(B_0, J), (B_1, J + 1)]``: the blocks of each part and their bins; one part when ``n_bins % n_blocks == 0``."""
    n_remains, n_neighbors = n_bins % n_blocks, n_bins // n_blocks
    shapes = [(n_blocks - n_remains, n_neighbors)]
    if n_remains:
        shapes.append((n_remains, n_neighbors + 1))
    return shapes


def split_bins(A: torch.Tensor, axis: int, shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """The bin axis ``axis`` of ``A`` cut into each part's ``(B_p, J_p)`` axes."""
    pieces = torch.split(A, [B * J for B, J in shapes], dim=axis)
    return [p.reshape(p.shape[:axis] + (B, J) + p.shape[axis + 1 :]) for p, (B, J) in zip(pieces, shapes)]


def merge_bins(parts: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
    """Inverse of :func:`split_bins`."""
    return torch.cat([p.flatten(axis, axis + 1) for p in parts], dim=axis)


def _shapes_of(T_parts) -> List[Tuple[int, int]]:
    return [(Tp.shape[-3], Tp.shape[-2]) for Tp in T_parts]


def hermitian_inverse(R: torch.Tensor) -> torch.Tensor:
    """``R^-1`` of Hermitian positive definite ``(..., m, m)``, routed by dtype and shape.

    K3 in complex64 up to ``m = 32``
    (:func:`~ssspy_tpu_torch.ops.kernels.gj_inverse_takes`): the pivot-free
    Gauss-Jordan of the JAX step's ``planar_inverse_sc``. ``inv_ex`` in
    complex128, and in complex64 above that.
    """
    if R.dtype == torch.complex64 and kernels.gj_inverse_takes(R.shape[-1]):
        return kernels.gj_inverse(R.contiguous())
    return torch.linalg.inv_ex(R)[0]


def _model(T_part: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """``R[n,t,b] = sum_k v_nkt T_nkb``, ``([B_utt,] N, T, B, J, J)``."""
    return torch.einsum("...nkt,...nkbij->...ntbij", V.to(T_part.dtype), T_part)


def model_inverse(T_part: torch.Tensor, V: torch.Tensor, eps: float, psd_impl: str) -> torch.Tensor:
    """The inverse of the projected model, ``(N, T, B, J, J)`` (``splitc._ipsdta_model_sc``, splitc.py:3294-3308)."""
    return hermitian_inverse(psd_project(_model(T_part, V), eps, psd_impl))


def part_stats(T_part, Y_part, V, eps: float, psd_impl: str):
    """``(R^-1, R^-1 y y^H R^-1, sum_b max(Re y^H R^-1 y, 0))`` of one part (splitc.py:3478-3499).

    ``Y_part``: the part's separated blocks ``(N, B, J, T)``. With
    ``u = R^-1 y`` the sandwich is the rank-one ``u u^H``, ``R^-1`` being
    Hermitian; the last entry is ``(N, T)``.
    """
    R_inv = model_inverse(T_part, V, eps, psd_impl)
    y = Y_part.movedim(-1, -3)  # ([B_utt,] N, T, B, J)
    u = (R_inv @ y[..., None])[..., 0]
    RYYR = u[..., :, None] * u[..., None, :].conj()
    YRY = torch.clamp((y.conj() * u).real.sum(dim=-1), min=0).sum(dim=-1)
    return R_inv, RYYR, YRY


def _frame_weighted(A: torch.Tensor, pi: Optional[torch.Tensor]) -> torch.Tensor:
    """``pi[n, t] A[n, t, ...]``, or ``A`` for the Gaussian model."""
    return A if pi is None else pi[..., None, None, None].to(A.dtype) * A


def _root(lamb: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.clamp(lamb, min=0.0))


def _basis_update(T, R_inv, RYYR, V, pi, dof, eps, psd_impl, gmean_impl, flooring_fn=None):
    """The MM basis update of one part (splitc.py:3510-3547).

    Gauss: ``T <- P^-1 # TQT``. Student's t:
    ``T <- T Q^1/2 (Q^1/2 T P T Q^1/2)^-1/2 Q^1/2 T``. ``P`` and ``Q`` are
    the activation-weighted frame means of ``R^-1`` and of the (t: frame
    weighted) ``R^-1 y y^H R^-1``. The inverse square root floors the
    eigenvalues at ``eps``, ``1 / sqrt(max(lamb, eps))``, where the JAX step
    floors the root, ``1 / max(sqrt(max(lamb, 0)), eps)``: the two agree
    wherever ``lamb >= eps``, which the eigenvalue-floored model of
    complex128 guarantees. Under the ridge model the float32 rounding of
    ``M`` leaves eigenvalues at or below zero, the JAX form turns them into
    ``1 / eps = 1e10``, and its float32 step goes non-finite at the second
    iteration on a 0.6 s cut of the 8-channel mixture (``dof = 1000``); this
    form gives ``1e5`` and stays finite. ``flooring_fn`` takes the place of
    ``max(., eps)`` in the projections and gives the JAX form
    ``1 / flooring_fn(sqrt(max(lamb, 0)))`` (``invsqrtmh``).
    """
    project = functools.partial(psd_project, eps=eps, impl=psd_impl, flooring_fn=flooring_fn)
    Vc = V.to(T.dtype)
    n_frames = V.shape[-1]
    P = torch.einsum("...nkt,...ntbij->...nkbij", Vc, R_inv) / n_frames
    Q = torch.einsum("...nkt,...ntbij->...nkbij", Vc, _frame_weighted(RYYR, pi)) / n_frames
    if dof is None:
        T_new = gmean2(project(P), project(T @ Q @ T), impl=gmean_impl)
    else:
        Q_half = spectral(hermitize(project(Q)), _root)
        M = project(Q_half @ T @ P @ T @ Q_half)
        if flooring_fn is None:
            M_inv_half = spectral(hermitize(M), lambda lamb: 1 / torch.sqrt(torch.clamp(lamb, min=eps)))
        else:
            M_inv_half = spectral(hermitize(M), lambda lamb: 1 / flooring_fn(_root(lamb)))
        T_new = T @ (Q_half @ M_inv_half @ Q_half) @ T
    return project(T_new)


def _psdtf_trace(T_parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The summed trace of each basis over the blocks of every part, ``([B_utt,] N, K)``."""
    return sum(Tp.diagonal(dim1=-2, dim2=-1).real.sum(dim=(-2, -1)) for Tp in T_parts)


def _normalized(T_parts: Sequence[torch.Tensor], V: torch.Tensor, trace: torch.Tensor):
    return [Tp / trace[..., None, None, None] for Tp in T_parts], V * trace[..., None]


def normalize_psdtf(T_parts: Sequence[torch.Tensor], V: torch.Tensor):
    """Unit summed trace of each basis over the blocks of every part, the scale moved to ``V`` (splitc.py:3564-3569)."""
    return _normalized(T_parts, V, _psdtf_trace(T_parts))


def vcd_covariance(R_inv: torch.Tensor, X_part: torch.Tensor) -> torch.Tensor:
    """``RXX[b,i,j,n,p,q] = mean_t R^-1[n,t,b,j,i] x[p,b,i,t] conj(x[q,b,j,t])``, ``(B, J, J, N, M, M)``.

    ``R_inv``: ``(N, T, B, J, J)`` (frame-weighted for the t model);
    ``X_part``: ``(M, B, J, T)`` (splitc.py:3571-3597). The weighted frames
    ``R^-1[n,t,b,j,i] x[p,b,i,t]`` are formed once, ``B J^2 N M T``
    entries (0.32 GB in complex64 at the 8-channel timing shape), and
    contracted over the frames with ``conj(x[q,b,j,t])`` as one batched
    product.
    """
    M, B, J, T = X_part.shape
    N = R_inv.shape[0]
    weighted = R_inv.permute(2, 4, 3, 0, 1)[:, :, :, :, None, :] * X_part.permute(1, 2, 0, 3)[:, :, None, None]
    RXX = weighted.reshape(B, J, J, N * M, T) @ X_part.permute(1, 2, 3, 0).conj()[:, None]
    return RXX.reshape(B, J, J, N, M, M) / T


_VCD_TINY = 1e-30  # the sweep's floor on xi, as the JAX sweep's ``tiny``


def vcd_sweep(
    W: torch.Tensor, RXX: torch.Tensor, eps: float = 1e-10, singular_fn: Optional[Callable] = None
) -> torch.Tensor:
    """One VCD sweep over the bins of each block and the sources (``splitc._vcd_sweep_sc``, splitc.py:3311-3395).

    ``W``: ``(B, J, N, M)``, whose rows are ``conj(w)``; ``RXX``:
    ``(B, J, J, N, M, M)`` from :func:`vcd_covariance`; ``N == M``. For bin
    ``i`` and source ``n``, with ``U = RXX[i, i, n]``: ``eta`` solves
    ``(W_i U) eta = e_n`` and ``eta_hat`` solves ``U eta_hat = g``,
    ``g = sum_{j != i} RXX[i, j, n] conj(w_jn)``, stacked into one
    ``solve_ex`` as the JAX sweep stacks them. With ``z = eta^H U``,
    ``xi = max(Re z eta, 0)`` and ``xi_hat = z eta_hat``, the new filter is
    ``c eta - eta_hat``, ``c = s xi_hat``,
    ``s = (1 - sqrt(1 + 4 xi / |xi_hat|^2)) / (2 max(xi, tiny))``, or
    ``c = 1 / sqrt(max(xi, tiny))`` where ``|xi_hat| < eps``,
    ``tiny = 1e-30``. Where ``solve_ex`` reports a singular system (a
    silent bin, ``U = 0``) the update is not taken and the row keeps its
    value, as the IP1 sweep freezes its rows
    (:func:`~ssspy_tpu_torch.ops.kernels.ip1_sweep_plain`); any other
    non-finite value reaches the output. ``singular_fn(xi_hat)``, where
    given, is the singular test in place of ``|xi_hat| < eps``
    (``update_by_block_decomposition_vcd``'s, and the JAX class's
    ``|xi_hat| < flooring_fn(0)``, ssspy_tpu/bss/ipsdta.py:643). Returns the
    new ``W``.
    """
    n_blocks, n_neighbors, n_sources, n_channels = W.shape
    if n_sources != n_channels:
        raise ValueError(f"the VCD sweep takes as many sources as channels, got W {tuple(W.shape)}")
    W = W.clone()
    e = torch.eye(n_sources, dtype=W.dtype, device=W.device)
    for i in range(n_neighbors):
        others = torch.ones(n_neighbors, dtype=W.real.dtype, device=W.device)
        others[i] = 0
        for n in range(n_sources):
            U = RXX[:, i, i, n]  # (B, M, M)
            RXY = (RXX[:, i, :, n] @ W[:, :, n, :].conj()[..., None])[..., 0]  # (B, J, M)
            g = (others[:, None] * RXY).sum(dim=1)
            A = torch.stack([W[:, i] @ U, U])
            b = torch.stack([e[n].expand(n_blocks, n_channels), g])
            (eta, eta_hat), info = torch.linalg.solve_ex(A, b[..., None])
            eta, eta_hat = eta[..., 0], eta_hat[..., 0]
            z = (eta.conj()[:, None, :] @ U)[:, 0]
            xi = torch.clamp((z * eta).sum(dim=-1).real, min=0)
            xi_hat = (z * eta_hat).sum(dim=-1)
            mag2 = xi_hat.real.square() + xi_hat.imag.square()
            singular = torch.sqrt(mag2) < eps if singular_fn is None else singular_fn(xi_hat)
            xi_safe = torch.clamp(xi, min=_VCD_TINY)
            s = (1 - torch.sqrt(1 + 4 * xi / torch.where(singular, torch.ones_like(mag2), mag2))) / (2 * xi_safe)
            c = torch.where(singular, torch.complex(1 / torch.sqrt(xi_safe), torch.zeros_like(xi)), s * xi_hat)
            w = c[:, None] * eta - eta_hat
            solved = (info == 0).all(dim=0)
            W[:, i, n] = torch.where(solved[:, None], w.conj(), W[:, i, n])
    return W


def random_psdtf(rng: np.random.Generator, n_sources: int, n_basis: int, n_frames: int, shapes, dtype,
                 device, eps: float, basis: bool = True, activation: bool = True,
                 flooring_fn: Optional[Callable] = None):
    """The random start of the JAX class and fast path, drawn on the host in their order.

    Per part (``shapes``, :func:`part_shapes`) a diagonal basis of uniform
    draws, ``(N, K, B_p, J_p, J_p)`` in ``dtype``; then the activation
    ``max(draw, eps)``, ``(N, K, T)`` in ``dtype``'s real type
    (ssspy_tpu/bss/ipsdta.py:226-249, ssspy_tpu/fast.py:970-980). A part or
    the activation whose flag is off is neither drawn nor returned
    (``None``), so that a warm start keeps the draw order. ``flooring_fn``
    floors the activation in place of ``max(., eps)``.
    """
    real = torch.empty((), dtype=dtype).real.dtype
    T_parts = None
    if basis:
        T_parts = [
            torch.diag_embed(torch.as_tensor(rng.random((n_sources, n_basis, B, J)), dtype=real)).to(device, dtype)
            for B, J in shapes
        ]
    V = None
    if activation:
        V = floor(torch.as_tensor(rng.random((n_sources, n_basis, n_frames)), dtype=real), eps, flooring_fn).to(device)
    return T_parts, V


def ipsdta_vcd_step(
    X: torch.Tensor,
    W: torch.Tensor,
    T_parts: Sequence[torch.Tensor],
    V: torch.Tensor,
    dof: Optional[float] = None,
    eps: float = 1e-10,
    normalization: bool = True,
    bin_sum=None,
    flooring_fn: Optional[Callable] = None,
):
    """One IPSDTA iteration, MM source update and VCD spatial update (``splitc.ipsdta_vcd_step_sc``, splitc.py:3408-3605).

    ``X``: the mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``;
    ``T_parts``: the PSDTF basis parts ``(N, K, B_p, J_p, J_p)``; ``V``: the
    activation ``(N, K, T)``, real. ``dof=None`` is the Gaussian model; a
    float ``dof`` the Student's-t model, whose frame weight
    ``pi = (dof + 2 I) / (dof + 2 sum_b y^H R^-1 y)`` is taken afresh before
    each update. In order: the basis update, the activation update
    ``V <- V sqrt(sum tr(R^-1 y y^H R^-1 T) / sum tr(R^-1 T))``, with
    ``normalization`` the unit-trace normalization of the basis (the JAX
    step always runs it; the reference's ``source_normalization=False``
    skips it), and one VCD sweep; the separated blocks ``y`` are those of
    the ``W`` the step starts from. The model's projection and the
    geometric mean follow the dtype (see the module); the JAX step's
    ``psd_impl``, ``gmean_impl`` and ``inv_impl`` choose them by backend
    and have no counterpart. Returns ``(W, T_parts, V)``.

    A batch (``X (B_utt, M, I, T)``, ``W (B_utt, I, N, M)``, parts
    ``(B_utt, N, K, B_p, J_p, J_p)``, ``V (B_utt, N, K, T)``) runs the
    source model batched, K3 and K7 once for all, and the VCD sweep once
    per utterance. With ``bin_sum`` the rank holds whole blocks of the bins
    (one part) and the sums over blocks are summed over the bin group, as
    the module describes; the Gaussian model only (``dof=None``).
    ``flooring_fn`` as the module describes.
    """
    if dof is not None and bin_sum is not None:
        raise ValueError("the t model's frame weight is not sharded over bins: dof takes bin_sum=None")
    psd_impl, gmean_impl = _routes(X.dtype, flooring_fn=flooring_fn)
    bin_axis = X.dim() - 2
    n_bins = X.shape[bin_axis]
    shapes = _shapes_of(T_parts)
    Y_parts = split_bins(separate(X, W), bin_axis, shapes)

    def stats(T_parts, V):
        out = [part_stats(Tp, Yp, V, eps, psd_impl) for Tp, Yp in zip(T_parts, Y_parts)]
        pi = None if dof is None else (dof + 2 * n_bins) / (dof + 2 * sum(s[2] for s in out))
        return out, pi

    # ---- the basis (gauss ipsdta.py:932-997; t :1491-1580) ----
    out, pi = stats(T_parts, V)
    T_parts = [
        _basis_update(Tp, R_inv, RYYR, V, pi, dof, eps, psd_impl, gmean_impl, flooring_fn)
        for Tp, (R_inv, RYYR, _) in zip(T_parts, out)
    ]

    # ---- the activation (ipsdta.py:1001-1006) ----
    out, pi = stats(T_parts, V)
    num = sum(
        torch.einsum("...ntbij,...nkbji->...nkt", _frame_weighted(RYYR, pi), Tp).real
        for Tp, (_, RYYR, _) in zip(T_parts, out)
    )
    denom = sum(torch.einsum("...ntbij,...nkbji->...nkt", R_inv, Tp).real for Tp, (R_inv, _, _) in zip(T_parts, out))
    # the normalization's traces are those of the basis just updated, which the activation leaves as it is
    trace = _psdtf_trace(T_parts) if normalization else None
    if bin_sum is not None and trace is None:
        num, denom = bin_sum(num, denom)
    elif bin_sum is not None:
        num, denom, trace = bin_sum(num, denom, trace)
    V = V * torch.sqrt(num / denom)

    # ---- the source normalization (ipsdta.py:666-697) ----
    if normalization:
        T_parts, V = _normalized(T_parts, V, trace)

    # ---- the spatial update, VCD (ipsdta.py:1058-1147; t weights :1751-1811) ----
    out, pi = stats(T_parts, V)
    X_parts, W_parts = split_bins(X, bin_axis, shapes), split_bins(W, bin_axis - 1, shapes)

    singular_fn = None
    if flooring_fn is not None:
        floor0 = flooring_fn(torch.zeros((), dtype=X.real.dtype, device=X.device))

        def singular_fn(xi_hat):
            return xi_hat.abs() < floor0

    def sweep(R_inv, Xp, Wp):
        return vcd_sweep(Wp, vcd_covariance(R_inv, Xp), eps=eps, singular_fn=singular_fn)

    W_new = []
    for (R_inv, _, _), Xp, Wp in zip(out, X_parts, W_parts):
        R_inv = _frame_weighted(R_inv, pi)
        if X.dim() == 4:
            W_new.append(torch.stack([sweep(R_inv[b], Xp[b], Wp[b]) for b in range(X.shape[0])]))
        else:
            W_new.append(sweep(R_inv, Xp, Wp))
    return merge_bins(W_new, bin_axis - 1), T_parts, V


def ipsdta_loss(
    X: torch.Tensor,
    W: torch.Tensor,
    T_parts: Sequence[torch.Tensor],
    V: torch.Tensor,
    dof: Optional[float] = None,
    eps: float = 1e-10,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """IPSDTA negative log-likelihood (``splitc.ipsdta_loss_sc``, splitc.py:4352-4419).

    Gauss: ``mean_t [sum_{n,b} y^H R^-1 y + sum_{n,b} log det R] - 2 sum_i
    log|det W_i|``; Student's t: the first term becomes
    ``sum_n ((dof + 2 I) / 2) log(1 + (2 / dof) sum_b y^H R^-1 y)``. ``R`` is
    the model projected as :func:`ipsdta_vcd_step` projects it. One batched
    LU of ``R`` (``lu_factor_ex``) gives both ``R^-1 y`` and ``log det R``,
    as the dense-MNMF loss does; no kernel runs here. A 0-dim tensor on the
    input's device. ``flooring_fn`` chooses the route only: the model keeps
    its projection at ``eps``.
    """
    psd_impl, _ = _routes(X.dtype, flooring_fn=flooring_fn)
    Y_parts = split_bins(separate(X, W), 1, _shapes_of(T_parts))
    YRY = logdet_R = 0.0
    for Tp, Yp in zip(T_parts, Y_parts):
        LU, pivots, _ = torch.linalg.lu_factor_ex(psd_project(_model(Tp, V), eps, psd_impl))
        y = Yp.permute(0, 3, 1, 2)[..., None]  # (N, T, B, J, 1)
        u = torch.linalg.lu_solve(LU, pivots, y)
        YRY = YRY + torch.clamp((y.conj() * u).real.sum(dim=(-2, -1)), min=0).sum(dim=-1)  # (N, T)
        logdet_R = logdet_R + torch.log(LU.diagonal(dim1=-2, dim2=-1).abs()).sum(dim=(0, 2, 3))  # (T,)
    logdet_W = clogabsdet(W).sum()
    if dof is None:
        return torch.mean(YRY.sum(dim=0) + logdet_R) - 2 * logdet_W
    value = (((dof + 2 * X.shape[1]) / 2) * torch.log1p((2 / dof) * YRY)).sum(dim=0)
    return torch.mean(value + logdet_R) - 2 * logdet_W
