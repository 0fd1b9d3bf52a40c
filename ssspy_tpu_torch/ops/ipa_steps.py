"""The IPA (iterative projection with adjustment) source sweep on native complex tensors.

Counterpart of the IPA section of ``ssspy_tpu/ops/splitc.py``
(``lqpqm2_sc``, ``_ipa_qp_sc``, ``ipa_sweep_sc``,
``_ipa_sweep_congruence_sc``; splitc.py:1503-2232) and of
``ssspy_tpu.bss._update_spatial_model.update_by_ipa``
(_update_spatial_model.py:253-338). Per source, IPA reduces the update of
the separated spectrogram ``Y (N, I, T)`` to a log-quadratically penalized
quadratic minimization and applies its solution as a rank-one change of
the other rows plus a new row ``n``.

The route is decided by dtype, before any launch (:func:`ipa_sweep`):

- complex128 takes :func:`ipa_sweep_direct`, the reference's data flow:
  the weighted covariance stack recomputed from ``Y`` before each source,
  projected onto the PSD cone and inverted through floored eigenvalues
  (``torch.linalg.eigh``, in batches). The CPU tests and the fixtures run it.
- complex64 takes :func:`ipa_sweep_congruence`, what the JAX package runs
  in float32: the stack computed once per sweep by the weighted covariance
  kernel, a relative Tikhonov ridge ``U + (eps + rel tr(U) / N) I`` in
  place of the eigenvalue floor, each source's update ``Y <- T Y`` pushed
  through the stack as ``U[s] <- T U[s] T^H`` by the congruence kernel, and
  one final ``Y <- G Y``. The pencil's eigh goes to the Jacobi kernel.

Both share :func:`ipa_qp`. The congruence sweep solves its LQPQM with
:func:`lqpqm2`, which carries the float32 safeguards: the solution as the
positive-definite solve ``(lamb I - H)^{-1} H v`` and the clamp
``lamb >= phi_max (1 + 32 eps)`` relative to the dtype; the direct sweep
keeps the reference's solver. Every small solve is
``solve_ex`` and every inverse ``inv_ex``: a silent bin gives values, not
an exception or a host read.
"""

import functools
from typing import Callable, Optional, Tuple

import torch

from ..linalg import lqpqm as reference
from ..linalg.eig_free import secular_root_solve
from ..linalg.lqpqm import _find_largest_root_real, solve_equation
from ..special.flooring import floor, max_flooring
from ..special.psd import eigh_in_batches, hermitize, psd_inv, to_psd
from . import kernels
from .iva_steps import covariance
from .prox_steps import herm_eigh_embed

__all__ = ["lqpqm2", "ipa_qp", "congruence_round", "ipa_sweep_direct", "ipa_sweep_congruence", "ipa_sweep"]

_F32_REL = 1e-6  # relative ridge of the float32 sweep (splitc.py:1792-1793)
SECULAR_IMPLS = ("eigh", "solve")


def _check_secular_impl(secular_impl: str) -> None:
    if secular_impl not in SECULAR_IMPLS:
        raise ValueError(f"unknown secular_impl {secular_impl!r}; expected one of {SECULAR_IMPLS}")


def _drop(v: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``v`` without index ``n`` along ``dim``: two slices, no index tensor."""
    return torch.cat([v.narrow(dim, 0, n), v.narrow(dim, n + 1, v.shape[dim] - n - 1)], dim=dim)


def _insert(v: torch.Tensor, n: int, fill: float) -> torch.Tensor:
    """``(I, N - 1) -> (I, N)`` with the constant ``fill`` at column ``n``: the inverse of :func:`_drop`."""
    column = torch.full_like(v[:, :1], fill)
    return torch.cat([v[:, :n], column, v[:, n:]], dim=1)


def _pencil_spectrum(H: torch.Tensor, v: torch.Tensor):
    """``(phi ascending, |sigma_i^H v|^2, top eigenvector)`` of Hermitian ``H (..., K, K)``, the eigh routed by dtype.

    complex128: ``torch.linalg.eigh`` on ``H``. complex64: the real
    ``2K x 2K`` embedding through the Jacobi kernel; each eigenvalue comes
    twice, adjacent after the sort, and the two squared projections of the
    embedded ``v`` add up to the complex ``|v~_i|^2``, so the pair
    reduction gives the same secular function term by term
    (splitc.py:1562-1570). Single columns of the embedded basis mean
    nothing inside a pair; the top column is used all the same, by the
    singular branch alone, whose direction is arbitrary (its norm is 1).
    """
    if H.dtype == torch.complex128:
        phi, sigma = eigh_in_batches(H)
        vt = torch.sum(sigma.conj() * v[..., :, None], dim=-2)
        return phi, vt.real.square() + vt.imag.square(), sigma[..., :, -1]
    if H.dtype != torch.complex64:
        raise ValueError(f"the IPA sweep takes complex128 or complex64, got {H.dtype}")
    K = v.shape[-1]
    lamb2, P2 = herm_eigh_embed(H)  # (..., 2K), (..., 2K, 2K)
    vt2 = torch.sum(P2 * torch.cat([v.real, v.imag], dim=-1)[..., :, None], dim=-2)
    phi = (lamb2[..., 0::2] + lamb2[..., 1::2]) / 2
    vsq = vt2[..., 0::2].square() + vt2[..., 1::2].square()
    top = P2[..., :, -1]
    return phi, vsq, torch.complex(top[..., :K], top[..., K:])


def lqpqm2(
    H: torch.Tensor,
    v: torch.Tensor,
    z: torch.Tensor,
    eps: float = 1e-10,
    max_iter: int = 10,
    secular_impl: str = "eigh",
) -> torch.Tensor:
    """LQPQM type 2 for the sweep: ``argmin_q q^H q - log((q + v)^H H (q + v) + z)``.

    ``H``: Hermitian PSD ``(..., K, K)``; ``v``: ``(..., K)``; ``z``: real
    ``(...,)``. Counterpart of ``splitc.lqpqm2_sc`` with
    ``secular_impl="eigh"`` (splitc.py:1503-1617), which follows the
    reference's trajectory (:func:`ssspy_tpu_torch.linalg.lqpqm.lqpqm2`)
    and differs from it where float32 breaks:

    - the root ``lamb`` of the secular equation comes from
      :func:`~ssspy_tpu_torch.linalg.lqpqm.solve_equation` with the
      real-arithmetic cubic start, then is clamped to
      ``phi_max (1 + 32 eps_dtype)``: the solver's own ``phi_max + eps``
      rounds to ``phi_max`` in float32 and would make ``lamb I - H``
      singular;
    - the solution is the solve ``(lamb I - H)^{-1} H v``, equal to the
      eigen-sum ``sum_i sigma_i phi_i v~_i / (lamb - phi_i)`` but stable,
      where the sum cancels as ``lamb`` nears the pole ``phi_max``;
    - ``||v|| < eps`` takes the singular branch: a step of length
      ``sqrt((max(z, phi_max) - z) / phi_max)`` along the top eigenvector.

    ``secular_impl="solve"`` finds the root without an eigendecomposition
    (:func:`~ssspy_tpu_torch.linalg.eig_free.secular_root_solve`, each of
    its trips one pivot-certified Cholesky of the embedded pencil; 12 trips
    in float32 and 8 in float64, the JAX package's defaults), nudged
    ``32 eps_dtype`` relative above itself and clamped above the estimated
    ``phi_max``; the singular branch then steps along the shift-invert top
    eigenvector. It solves the true secular equation, where the eigh route
    keeps the reference's normalization (``v`` scaled by ``phi_max``), so the
    two roots differ; ``max_iter`` does not apply. Counterpart of
    ``lqpqm2_sc``'s ``"solve"`` (splitc.py:1532-1556).
    """
    _check_secular_impl(secular_impl)
    norm = torch.linalg.vector_norm(v, dim=-1)
    real = H.real.dtype
    gap = 32 * torch.finfo(real).eps
    if secular_impl == "solve":
        lamb, (phi_max, sigma_max) = secular_root_solve(H, v, z, trips=8 if real == torch.float64 else 12)
        lamb = lamb * (1 + gap) + torch.finfo(real).tiny
        lamb = torch.maximum(lamb, phi_max * (1 + gap))
    else:
        phi, vsq, sigma_max = _pencil_spectrum(H, v)
        phi_max = phi[..., -1]
        lamb = solve_equation(
            phi, torch.sqrt(vsq), z, flooring_fn=functools.partial(max_flooring, eps=eps),
            max_iter=max_iter, normalization=True, root_finder=_find_largest_root_real,
        )
        lamb = torch.maximum(lamb, phi_max * (1 + gap))

    positive = phi_max > 0
    scale = (torch.maximum(z, phi_max) - z) / torch.where(positive, phi_max, 1.0)
    scale = torch.sqrt(torch.clamp(torch.where(positive, scale, 0.0), min=0))
    y_singular = scale[..., None] * sigma_max

    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    Hv = (H @ v[..., None])[..., 0]
    y = torch.linalg.solve_ex(lamb[..., None, None] * eye - H, Hv)[0]
    return torch.where((norm < eps)[..., None], y_singular, y)


def ipa_qp(
    Un: torch.Tensor,
    Un_inv: torch.Tensor,
    a_n: torch.Tensor,
    b_n: torch.Tensor,
    n: int,
    eps: float = 1e-10,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    solver: Optional[Callable] = None,
    flooring_fn: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Source ``n``'s reduction to LQPQM; returns ``(q (I, N-1), p (I, N))``.

    ``Un``: source ``n``'s floored or ridged covariance ``(I, N, N)``;
    ``Un_inv``: its inverse; ``a_n``, ``b_n``: the other sources' entries
    ``U[s, n, n]`` (real) and ``U[s, n, s]``, ``(I, N-1)`` each, ``s``
    ascending without ``n``. ``C`` and ``d`` are the other sources' block
    and column ``n`` of ``conj(Un_inv)``, ``z_n = Un_inv[n, n] - d^H C^{-1}
    d``, and with ``H = C / sqrt(a a^T)`` (divided by its trace, with ``z``,
    under ``lqpqm_normalization``) and ``v = -b / sqrt(a) - sqrt(a) C^{-1}
    d`` the solution ``q~`` of :func:`lqpqm2` gives ``q = q~ / sqrt(a) -
    b / a``. The new row is ``p = Un^{-1} q_t / sqrt(q_t^H Un^{-1} q_t)``
    with ``q_t = e_n - sum_s conj(q_s) e_s``. ``solver(H, v, z, eps=,
    max_iter=)`` is :func:`lqpqm2` unless given. ``flooring_fn`` replaces
    ``max(., eps)`` on the new row's norm (``update_by_ipa``,
    ssspy_tpu/bss/_update_spatial_model.py:327). Counterpart of
    ``splitc._ipa_qp_sc`` (splitc.py:1643-1727).
    """
    solver = lqpqm2 if solver is None else solver
    C = _drop(_drop(Un_inv, n, 1), n, 2).conj()
    d = _drop(Un_inv[:, :, n], n, 1).conj()
    Cd = torch.linalg.solve_ex(C, d)[0]
    z_n = Un_inv[:, n, n].real - torch.sum(d.conj() * Cd, dim=-1).real

    a_sqrt = torch.sqrt(a_n)
    H = C / (a_sqrt[:, :, None] * a_sqrt[:, None, :])
    v = -b_n / a_sqrt - a_sqrt * Cd
    if lqpqm_normalization:
        trace = H.diagonal(dim1=-2, dim2=-1).real.sum(dim=-1)
        H, z_n = H / trace[:, None, None], z_n / trace

    q = solver(H, v, z_n, eps=eps, max_iter=newton_iter) / a_sqrt - b_n / a_n

    q_t = _insert(-q.conj(), n, 1.0)
    Uq = torch.linalg.solve_ex(Un, q_t)[0]
    qUq = torch.sum(q_t.conj() * Uq, dim=-1).real
    denom = floor(torch.sqrt(torch.clamp(qUq, min=0)), eps, flooring_fn)
    return q, Uq / denom[:, None]


def _covariance_stack(Y: torch.Tensor, varphi: torch.Tensor) -> torch.Tensor:
    """``U[i, s] = mean_t varphi[s, (i,) t] y_it y_it^H``, hermitized: ``(I, S, N, N)``."""
    return hermitize(covariance(Y, varphi))


def congruence_round(T: torch.Tensor, U: torch.Tensor, G: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(T U[s] T^H for every s, T G)`` per bin, routed by dtype and shape.

    K6 (:func:`~ssspy_tpu_torch.ops.kernels.ipa_congruence`) for complex64
    with ``N, S <= 16``
    (:func:`~ssspy_tpu_torch.ops.kernels.ipa_congruence_takes`);
    :func:`~ssspy_tpu_torch.ops.kernels.ipa_congruence_plain` otherwise.
    """
    if T.dtype == U.dtype == G.dtype == torch.complex64 and kernels.ipa_congruence_takes(U.shape[-1], U.shape[1]):
        return kernels.ipa_congruence(T.contiguous(), U.contiguous(), G.contiguous())
    return kernels.ipa_congruence_plain(T, U, G)


def _reference_lqpqm2(H, v, z, eps, max_iter, flooring_fn=None):
    """The reference's solver (eigen-sum, no clamp of the root) behind :func:`lqpqm2`'s signature.

    It floors with ``flooring_fn``, ``max(., eps)`` unless given, and its
    singular test is ``x < flooring_fn(0)`` (update_by_ipa's,
    ssspy_tpu/bss/_update_spatial_model.py:311-318).
    """
    flooring_fn = functools.partial(max_flooring, eps=eps) if flooring_fn is None else flooring_fn
    return reference.lqpqm2(H, v, z, flooring_fn=flooring_fn, max_iter=max_iter)


def _solve_solver(secular_impl: str) -> Optional[Callable]:
    """:func:`lqpqm2` with the eigendecomposition-free root for ``secular_impl="solve"``; ``None`` for ``"eigh"``."""
    _check_secular_impl(secular_impl)
    if secular_impl == "eigh":
        return None
    return functools.partial(lqpqm2, secular_impl="solve")


def ipa_sweep_direct(
    Y: torch.Tensor,
    varphi: torch.Tensor,
    eps: float = 1e-10,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    rel: float = 0.0,
    secular_impl: str = "eigh",
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """IPA sweep with the statistics recomputed before each source; returns the new ``Y``.

    ``Y``: ``(N, I, T)``; ``varphi``: real ``(N, T)`` or ``(N, I, T)``. Per
    source: the covariance stack of the current ``Y``, projected onto the
    PSD cone with eigenvalues floored at ``max(eps, rel lamb_max)``
    (:func:`~ssspy_tpu_torch.special.psd.to_psd`), source ``n``'s inverse
    through its floored eigenvalues, :func:`ipa_qp`, then rows ``s != n``
    gain ``conj(q_s) y_n`` and row ``n`` becomes ``sum_s conj(p_s) y_s``.
    ``update_by_ipa`` (_update_spatial_model.py:253-338) and the
    ``psd_impl="eigh"`` branch of ``ipa_sweep_sc`` (splitc.py:1899-1973).

    The LQPQM solver is the reference's own
    (:func:`ssspy_tpu_torch.linalg.lqpqm.lqpqm2`), not :func:`lqpqm2`: where
    every ``phi |v|^2`` falls under the secular mask the reference returns
    the root ``lamb = z``, which may lie left of ``phi_max``, and its
    eigen-sum divides by ``z - phi``; :func:`lqpqm2` clamps that root to
    ``phi_max (1 + 32 eps_dtype)`` and divides by a difference of 7e-15 in
    float64. The fixtures follow the reference there. ``secular_impl="solve"``
    takes :func:`lqpqm2`'s eigendecomposition-free root instead, as
    ``ipa_sweep_sc`` does with it (splitc.py:1739-1812).

    ``flooring_fn`` replaces ``max(., eps)`` everywhere ``update_by_ipa``
    floors with its callable: the PSD projection and the inverse
    (ssspy_tpu/bss/_update_spatial_model.py:280, :287), the LQPQM solver and
    its singular test (:311-318) and the new row's norm (:327).
    """
    solver = _solve_solver(secular_impl) or functools.partial(_reference_lqpqm2, flooring_fn=flooring_fn)
    eig_floor = functools.partial(max_flooring, eps=eps) if flooring_fn is None else flooring_fn
    for n in range(Y.shape[0]):
        U = to_psd(_covariance_stack(Y, varphi), flooring_fn=eig_floor, rel=rel)
        Un = U[:, n]
        a_n = _drop(U[:, :, n, n].real, n, 1)
        b_n = _drop(U[:, :, n, :].diagonal(dim1=1, dim2=2), n, 1)
        q, p = ipa_qp(
            Un, psd_inv(Un, flooring_fn=eig_floor, rel=rel), a_n, b_n, n,
            eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter, solver=solver,
            flooring_fn=flooring_fn,
        )
        row_n = torch.einsum("is,sit->it", p.conj(), Y)
        Y = Y + _insert(q.conj(), n, 0.0).transpose(0, 1)[:, :, None] * Y[n]  # row n gains 0
        Y[n] = row_n
    return Y


def ipa_sweep_congruence(
    Y: torch.Tensor,
    varphi: torch.Tensor,
    eps: float = 1e-10,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    rel: Optional[float] = None,
    secular_impl: str = "eigh",
) -> torch.Tensor:
    """IPA sweep with congruence-updated statistics; returns the new ``Y``.

    The weights are fixed for the sweep, and source ``n``'s update is the
    per-bin linear map ``Y <- T_n Y`` with ``T_n = (I - e_n e_n^T) +
    conj(q) e_n^T + e_n conj(p)^T``, so the next source's statistics follow
    as ``U[s] <- T_n U[s] T_n^H`` with no pass over the spectrogram:

    - the full stack ``(I, S, N, N)`` once, by the weighted covariance
      (:func:`~ssspy_tpu_torch.ops.iva_steps.covariance`: the kernel K1),
      hermitized;
    - per source: the ridge ``eps + rel tr(U[s]) / N`` from the stack's own
      trace, ``a`` and ``b`` as entries of the stack, the ridged inverse
      (``inv_ex``), :func:`ipa_qp`, ``T_n`` by two rank-one terms, the
      congruence round (:func:`congruence_round`: the kernel K6),
      and the stack hermitized again against rounding drift;
    - one ``Y <- G Y`` with the accumulated ``G = T_{N-1} ... T_0``.

    Equal to :func:`ipa_sweep_direct` under the same ridge up to
    reassociation; the stack is rebuilt from ``Y`` every sweep, so nothing
    drifts across iterations. ``rel`` defaults to 0 in float64 and 1e-6 in
    float32. complex128 reaches this sweep only when called directly (the
    tests): there :func:`lqpqm2`'s clamp leaves a gap of 7e-15, a step at the
    pole is ~1e14 long, and a bin may go non-finite, on which
    ``torch.linalg.eigh`` raises. Counterpart of ``splitc._ipa_sweep_congruence_sc`` and its
    lanes form (splitc.py:1976-2232); the lane layout and the padding of
    bins to 128 were the TPU's and are gone. ``secular_impl`` as
    :func:`lqpqm2` takes it.
    """
    solver = _solve_solver(secular_impl)
    n_sources, n_bins, _ = Y.shape
    real = Y.real.dtype
    if rel is None:
        rel = 0.0 if real == torch.float64 else _F32_REL

    U = _covariance_stack(Y, varphi)
    eye = torch.eye(n_sources, dtype=real, device=Y.device)
    G = eye.to(Y.dtype).expand(n_bins, -1, -1).contiguous()

    for n in range(n_sources):
        lam = eps + rel * U.diagonal(dim1=-2, dim2=-1).real.sum(dim=-1) / n_sources  # (I, S)
        Un = U[:, n] + lam[:, n, None, None] * eye
        a_n = _drop(U[:, :, n, n].real + lam, n, 1)
        b_n = _drop(U[:, :, n, :].diagonal(dim1=1, dim2=2), n, 1)
        q, p = ipa_qp(
            Un, torch.linalg.inv_ex(Un)[0], a_n, b_n, n,
            eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter, solver=solver,
        )

        e_n = eye[n]
        T_n = (
            (eye - e_n[:, None] * e_n)
            + _insert(q.conj(), n, 0.0)[:, :, None] * e_n
            + e_n[:, None] * p.conj()[:, None, :]
        )
        U, G = congruence_round(T_n, U, G)
        U = hermitize(U)

    return torch.einsum("inm,mit->nit", G, Y).contiguous()


def ipa_sweep(
    Y: torch.Tensor,
    varphi: torch.Tensor,
    eps: float = 1e-10,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    secular_impl: str = "eigh",
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """One IPA sweep over the sources: :func:`ipa_sweep_direct` for complex128, :func:`ipa_sweep_congruence` for complex64.

    ``secular_impl``: ``"eigh"`` (the default, every dtype) solves each
    source's secular equation on the pencil's spectrum (the Jacobi kernel
    K7 in complex64); ``"solve"`` without an eigendecomposition, as
    :func:`lqpqm2` takes it (12 trips in float32, 8 in float64).

    A ``flooring_fn`` (one that is not ``max(., eps)``) takes
    :func:`ipa_sweep_direct` in either dtype, with the callable where
    ``update_by_ipa`` applies it: the congruence sweep's ridge stands in for
    the floored projection, so it cannot take the callable.
    """
    if Y.dtype == torch.complex128 or (flooring_fn is not None and Y.dtype == torch.complex64):
        return ipa_sweep_direct(Y, varphi, eps, lqpqm_normalization, newton_iter, 0.0, secular_impl, flooring_fn)
    if Y.dtype == torch.complex64:
        return ipa_sweep_congruence(Y, varphi, eps, lqpqm_normalization, newton_iter, None, secular_impl)
    raise ValueError(f"the IPA sweep takes complex128 or complex64, got {Y.dtype}")
