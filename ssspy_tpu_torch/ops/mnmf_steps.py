"""Dense GaussMNMF on native complex tensors: the iteration, its loss and the Wiener filter.

Counterparts of ``ssspy_tpu/ops/splitc.py``'s ``instant_covariance_sc``
(:2905-2918), ``_psd_project_sc`` (:3150-3162), ``gmean2_sc`` with
``_chol_unrolled`` and ``_tri_lower_inv`` (:3165-3291),
``gauss_mnmf_step_sc`` (:2921-3124) and ``gauss_mnmf_loss_sc``
(:4306-4331), and of the multichannel Wiener filter of
``ssspy_tpu/fast.py:902-908`` and ``ssspy_tpu/bss/mnmf.py:322-334``.

The routes are decided by dtype, before any launch; the JAX package makes
the same choices by backend (splitc.py:2974-2992):

- complex64, the accelerator route: ``psd_impl="ridge"`` (hermitize and add
  ``eps I``) and ``gmean_impl="chol"``; every model, inverse, sandwich,
  trace and frame-sum pass is the fused kernel K5
  (:func:`ssspy_tpu_torch.ops.kernels.model_traces`), three times per
  iteration and a fourth with the latent ``Z``; the geometric mean's
  embedded eigh and the new ``H``'s eigenvalue floor
  (:func:`spatial_projection`) are K7 at ``B = N I``, ``n = 2M``, twice per
  iteration. With ``psd_impl="eigh"``
  (the JAX package's parity model in float32) the step runs unfused: the
  inverse sandwich K4 (:func:`ssspy_tpu_torch.ops.kernels.inv_sandwich`)
  three times per iteration (four with ``Z``), and every PSD projection,
  ``B = I T`` embedded ``2M x 2M`` matrices for each model ``R``, through K7.
  Beyond the kernels' sizes the route is chosen by shape, before any launch:
  above 16 channels (or where one block's shared memory cannot hold the
  sources) the ridge model runs unfused, the sandwich as ``inv_ex`` and
  ``matmul`` (:func:`_inv_sandwich`, :func:`_fused`), and above 16 channels
  the embedded eigh is ``torch.linalg.eigh``
  (:func:`~ssspy_tpu_torch.ops.prox_steps.symm_eigh`).
- complex128, the reference route: ``psd_impl="eigh"`` through
  ``torch.linalg.eigh`` and ``gmean_impl="eigh2"``; the inverse and the
  sandwich are ``torch.linalg.inv_ex`` and ``matmul``, since the kernels
  take float32 only.

A ``flooring_fn`` that is not ``max(., eps)`` replaces ``max(., eps)``
wherever the JAX complex class floors with its callable: every PSD
projection (``to_psd``, ssspy_tpu/bss/mnmf.py:213, :331, :349, :386,
:395-399, :435) and the NMF updates (:356-374). It runs the eigh model in
either dtype, unfused: K5's ridge ``eps I`` stands in for the projection
``to_psd`` of the model, which the callable floors, so K5 does not launch.
"""

import functools
from typing import Callable, Optional, Tuple

import torch

from ..linalg.eig_free import chol_piv, tri_lower_inv
from ..special.flooring import floor, max_flooring
from ..special.psd import hermitize, spectral, to_psd
from . import kernels, prox_steps
from .ilrma_steps import reconstruct_nmf
from .prox_steps import _extract, block_embed

__all__ = [
    "instant_covariance",
    "psd_project",
    "gmean2",
    "gauss_mnmf_step",
    "gauss_mnmf_loss",
    "wiener_separate",
]

PSD_IMPLS = ("ridge", "eigh")
# complex64: the new spatial covariances' eigenvalue floor relative to their top eigenvalue
# (see spatial_projection; scripts/torch_mnmf_float32_floor.py measures it)
F32_SPATIAL_REL = 1e-6
GMEAN_IMPLS = ("chol", "eigh2")


def _routes(
    dtype: torch.dtype, psd_impl: str = "auto", gmean_impl: str = "auto", flooring_fn: Optional[Callable] = None
) -> Tuple[str, str]:
    """``(psd_impl, gmean_impl)`` with ``"auto"`` resolved by dtype and floor (see the module; IPSDTA's step takes the same)."""
    if dtype not in (torch.complex64, torch.complex128):
        raise ValueError(f"the step takes complex64 or complex128, got {dtype}")
    f32 = dtype == torch.complex64
    psd_impl = ("ridge" if f32 and flooring_fn is None else "eigh") if psd_impl == "auto" else psd_impl
    gmean_impl = ("chol" if f32 else "eigh2") if gmean_impl == "auto" else gmean_impl
    if psd_impl not in PSD_IMPLS:
        raise ValueError(f"unknown psd_impl {psd_impl!r}; expected 'auto' or one of {PSD_IMPLS}")
    if gmean_impl not in GMEAN_IMPLS:
        raise ValueError(f"unknown gmean_impl {gmean_impl!r}; expected 'auto' or one of {GMEAN_IMPLS}")
    return psd_impl, gmean_impl


def psd_project(
    A: torch.Tensor, eps: float, impl: str, rel: float = 0.0, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """PSD projection of Hermitian ``(..., m, m)`` (splitc.py:3150-3162).

    ``"eigh"`` floors the eigenvalues at ``max(eps, rel lamb_max)``
    (:func:`~ssspy_tpu_torch.special.psd.to_psd`; ``rel = 0`` is the JAX
    step), ``flooring_fn`` in place of ``max(., eps)`` where given;
    ``"ridge"`` hermitizes and adds ``eps I``.
    """
    if impl == "eigh":
        return to_psd(A, functools.partial(max_flooring, eps=eps) if flooring_fn is None else flooring_fn, rel=rel)
    if impl == "ridge":
        return hermitize(A) + eps * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    raise ValueError(f"unknown psd_impl {impl!r}; expected one of {PSD_IMPLS}")


def instant_covariance(
    X: torch.Tensor, eps: float = 1e-10, psd_impl: str = "auto", flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """``XX[i,t] = psd_project(x_it x_it^H)``, ``(I, T, M, M)`` from ``X (M, I, T)`` (splitc.py:2905-2918).

    ``psd_impl`` and ``flooring_fn`` as :func:`gauss_mnmf_step` takes them;
    the rank-one outer product is PSD by construction, so the ridge is its
    float32 route.
    """
    psd_impl, _ = _routes(X.dtype, psd_impl, flooring_fn=flooring_fn)
    XX = torch.einsum("pit,qit->itpq", X, X.conj())
    return psd_project(XX, eps, psd_impl, flooring_fn=flooring_fn).contiguous()


def _symmetrised(S: torch.Tensor) -> torch.Tensor:
    return (S + S.transpose(-1, -2)) / 2


def gmean2(A: torch.Tensor, B: torch.Tensor, impl: str = "eigh2") -> torch.Tensor:
    """Geometric mean ``A^-1 # B`` of Hermitian PSD pairs ``(..., m, m)``: the Hermitian PD ``G`` with ``G A G = B``.

    ``splitc.gmean2_sc`` (splitc.py:3222-3291; reference
    ``ssspy.linalg.gmeanmh(A, B, type=2)``). ``"eigh2"``:
    ``A^-1/2 (A^1/2 B A^1/2)^1/2 A^-1/2``, one eigh of ``A`` for both outer
    roots and one for the inner one, each routed by dtype
    (:func:`~ssspy_tpu_torch.special.psd.spectral`). ``"chol"``: with the
    real embedding ``E(A) = F F^T`` (:func:`~ssspy_tpu_torch.linalg.eig_free.chol_piv`),
    ``E(G) = F^-T (F^T E(B) F)^1/2 F^-1``: one real symmetric eigh of
    ``2m x 2m`` matrices through :func:`prox_steps.symm_eigh` (the Jacobi
    kernel K7 in float32) and a triangular inverse; it needs ``A``
    positive definite, as the step's projections leave it.
    """
    if impl == "chol":
        n = A.shape[-1]
        F = chol_piv(_symmetrised(block_embed(A)))[0]
        F_inv = tri_lower_inv(F)
        C = _symmetrised(F.transpose(-1, -2) @ _symmetrised(block_embed(B)) @ F)
        lamb, P = prox_steps.symm_eigh(C)
        S = (P * torch.sqrt(torch.clamp(lamb, min=0.0))[..., None, :]) @ P.transpose(-1, -2)
        return _extract(F_inv.transpose(-1, -2) @ S @ F_inv, n)
    if impl == "eigh2":
        def root(lamb):
            return torch.sqrt(torch.clamp(lamb, min=0.0))

        A_half, A_inv_half = spectral(A, root, lambda lamb: 1 / root(lamb))
        S = spectral(hermitize(A_half @ B @ A_half), root)
        return hermitize(A_inv_half @ S @ A_inv_half)
    raise ValueError(f"unknown gmean_impl {impl!r}; expected one of {GMEAN_IMPLS}")


def _model(Lamb: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """``R = sum_n Lamb_n H_n``, ``([B,] I, T, M, M)``."""
    return torch.einsum("...nit,...nipq->...itpq", Lamb.to(H.dtype), H)


def _trace_real(A: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """``Re tr(A[i,t] H[n,i])`` as ``([B,] N, I, T)``, without forming the products (bss/mnmf.py:44-46)."""
    return torch.einsum("...itab,...niba->...nit", A, H).real


def _model_traces(Lamb: torch.Tensor, H: torch.Tensor, XX: torch.Tensor, eps: float, outputs: str):
    """K5 (:func:`~ssspy_tpu_torch.ops.kernels.model_traces`), one launch per utterance of a batch."""
    if Lamb.dim() == 3:
        return kernels.model_traces(Lamb, H, XX, eps, outputs=outputs)
    per_utterance = [
        kernels.model_traces(Lamb[b].contiguous(), H[b].contiguous(), XX[b], eps, outputs=outputs)
        for b in range(Lamb.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*per_utterance))


def _inv_sandwich(R: torch.Tensor, C: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(R^-1, R^-1 C R^-1)``, routed by dtype and shape.

    K4 in complex64 up to ``m = 16``
    (:func:`~ssspy_tpu_torch.ops.kernels.inv_sandwich_takes`); ``inv_ex``
    and ``matmul`` in complex128, and in complex64 above that.
    """
    if R.dtype == torch.complex64 and kernels.inv_sandwich_takes(R.shape[-1]):
        return kernels.inv_sandwich(R.contiguous(), C.contiguous())
    R_inv = torch.linalg.inv_ex(R)[0]
    return R_inv, (R_inv @ C) @ R_inv


def spatial_projection(
    G: torch.Tensor, eps: float, psd_impl: str, flooring_fn: Optional[Callable] = None
) -> torch.Tensor:
    """The projection of the new spatial covariances: ``psd_impl`` in complex128, an eigenvalue floor in complex64.

    In complex64 the eigenvalues of ``G`` are floored at
    ``max(eps, F32_SPATIAL_REL lamb_max)`` whatever ``psd_impl``: one more
    K7 eigh of the ``N I`` embedded ``2M x 2M`` matrices. Once a spatial
    covariance nears rank one, the absolute ``eps`` vanishes under float32
    rounding, ``H`` and then ``R`` lose definiteness, a trace that is
    non-negative in exact arithmetic comes out negative and the square root
    of the MM update is NaN (the JAX float32 step as well). On the 8-channel
    10 s mixture a floor relative to the top eigenvalue keeps the step
    finite closer to complex128 than a relative ridge, which lifts every
    eigenvalue (scripts/torch_mnmf_float32_floor.py; PERF.md, section 6).
    ``flooring_fn`` takes the place of ``max(., eps)`` where given.
    """
    if G.dtype == torch.complex64:
        return psd_project(G, eps, "eigh", rel=F32_SPATIAL_REL, flooring_fn=flooring_fn)
    return psd_project(G, eps, psd_impl, flooring_fn=flooring_fn)


def _fused(dtype: torch.dtype, psd_impl: str, n_sources: int, m: int) -> bool:
    """Whether the step runs the fused kernel K5: complex64, the ridge model, and a shape K5 takes
    (:func:`~ssspy_tpu_torch.ops.kernels.model_traces_takes`); otherwise the unfused route."""
    return dtype == torch.complex64 and psd_impl == "ridge" and kernels.model_traces_takes(n_sources, m)


def gauss_mnmf_step(
    XX: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    H: torch.Tensor,
    Z: Optional[torch.Tensor] = None,
    eps: float = 1e-10,
    psd_impl: str = "auto",
    normalization: bool = True,
    gmean_impl: str = "auto",
    bin_mask: Optional[torch.Tensor] = None,
    bin_sum=None,
    flooring_fn: Optional[Callable] = None,
):
    """One dense GaussMNMF iteration (``splitc.gauss_mnmf_step_sc``, splitc.py:2921-3124).

    ``XX``: instant covariances ``(I, T, M, M)``; ``T``, ``V``: NMF basis
    ``(N, I, K)`` and activation ``(N, K, T)`` (with ``Z``: ``(I, K)``,
    ``(K, T)`` and the latent ``(N, K)``); ``H``: spatial covariances
    ``(N, I, M, M)``. MM updates of the basis, then the activation, from the
    Wiener traces ``tr(R^-1 XX R^-1 H_n)`` and ``tr(R^-1 H_n)``; the spatial
    update ``H <- P^-1 # HQH``; unit-trace normalization; the latent update.
    ``psd_impl`` (``"ridge"`` or ``"eigh"``) and ``gmean_impl`` (``"chol"``
    or ``"eigh2"``) default by dtype, and complex64 with the ridge model
    runs fused (see the module). In complex64 the new ``H`` takes an
    eigenvalue floor relative to its top eigenvalue
    (:func:`spatial_projection`), without which the float32 step goes
    non-finite as the JAX float32 step does. The JAX step's ``inv_impl``, ``fuse`` and ``XX_lanes`` choose TPU
    layouts and have no counterpart.

    ``bin_mask`` (optional, ``(I,)`` bool; splitc.py:2960-2968,
    :3044-3106): bins marked False are inert padding. Their traces are
    zeroed (``torch.where``: the singular model of a zero bin can give
    non-finite traces, which K5's outputs for those bins are then
    discarded with) before any contraction over bins, their basis rows and
    spatial covariances are frozen, and a zero trace of a frozen ``H``
    divides by 1, so a zero-padded bin leaves every real bin's trajectory
    exactly as it is without it. ``None`` runs the step as before.

    The step also takes a batch of utterances on a leading axis (``XX (B,
    I, T, M, M)``, ``T (B, N, I, K)`` or ``(B, I, K)``, ``V``, ``H (B, N,
    I, M, M)``, ``Z (B, N, K)``), K5 launched once per utterance, and
    ``bin_sum`` (:mod:`ssspy_tpu_torch.parallel.collectives`): the
    activation update's numerator and denominator, sums over bins, are
    summed over the bin group in one call, and with ``Z`` the latent
    update's in another. Returns ``(T, V, H)`` or ``(T, V, H, Z)``.

    ``flooring_fn`` (not ``max(., eps)``) floors the NMF updates and every
    PSD projection in place of ``max(., eps)``, on the unfused eigh model
    (see the module).
    """
    psd_impl, gmean_impl = _routes(XX.dtype, psd_impl, gmean_impl, flooring_fn)
    fused = flooring_fn is None and _fused(XX.dtype, psd_impl, H.shape[-4], H.shape[-1])
    project = functools.partial(psd_project, eps=eps, impl=psd_impl, flooring_fn=flooring_fn)
    keep = None if bin_mask is None else bin_mask.to(H.device)

    def traces(T, V, Z, H):
        Lamb = reconstruct_nmf(T, V, Z).contiguous()
        if fused:
            num, denom = _model_traces(Lamb, H, XX, eps, outputs="traces")
        else:
            R_inv, S = _inv_sandwich(project(_model(Lamb, H)), XX)
            num, denom = _trace_real(S, H), _trace_real(R_inv, H)
        if keep is not None:
            mask = keep[:, None]  # over (..., I, T)
            num = torch.where(mask, num, torch.zeros_like(num))
            denom = torch.where(mask, denom, torch.zeros_like(denom))
        return num, denom

    def bin_sums(n_, d_):
        return (n_, d_) if bin_sum is None else bin_sum(n_, d_)

    # ---- MM updates of basis, then activation (mnmf.py:836-968) ----
    num, denom = traces(T, V, Z, H)
    if Z is None:
        n_, d_ = (torch.einsum("...nkt,...nit->...nik", V, x) for x in (num, denom))
    else:
        n_, d_ = (torch.einsum("...nk,...kt,...nit->...ik", Z, V, x) for x in (num, denom))
    T_new = floor(T * torch.sqrt(n_ / d_), eps, flooring_fn)
    T = T_new if keep is None else torch.where(keep[:, None], T_new, T)  # padded basis rows frozen

    num, denom = traces(T, V, Z, H)
    if Z is None:
        n_, d_ = (torch.einsum("...nik,...nit->...nkt", T, x) for x in (num, denom))
    else:
        n_, d_ = (torch.einsum("...nk,...ik,...nit->...kt", Z, T, x) for x in (num, denom))
    n_, d_ = bin_sums(n_, d_)
    V = floor(V * torch.sqrt(n_ / d_), eps, flooring_fn)

    # ---- spatial update H <- P^-1 # HQH (mnmf.py:970-1016) ----
    Lamb = reconstruct_nmf(T, V, Z).contiguous()
    if fused:
        P, Q = _model_traces(Lamb, H, XX, eps, outputs="sums")
    else:
        R_inv, S = _inv_sandwich(project(_model(Lamb, H)), XX)
        Lc = Lamb.to(H.dtype)
        P = torch.einsum("...nit,...itpq->...nipq", Lc, R_inv)
        Q = torch.einsum("...nit,...itpq->...nipq", Lc, S)
    P = project(P)
    HQH = project(H @ Q @ H)
    G = gmean2(P, HQH, impl=gmean_impl)
    H_new = spatial_projection(G, eps, psd_impl) if flooring_fn is None else spatial_projection(G, eps, psd_impl, flooring_fn)
    H = H_new if keep is None else torch.where(keep[:, None, None], H_new, H)  # padded covariances frozen

    # ---- unit-trace normalization (mnmf.py:391-414) ----
    if normalization:
        trace = H.diagonal(dim1=-2, dim2=-1).real.sum(dim=-1)  # ([B,] N, I)
        if keep is not None:
            trace = torch.where(trace > 0, trace, torch.ones_like(trace))  # a frozen zero H stays finite
        H = H / trace[..., None, None]
        if Z is None:
            T = trace[..., None] * T

    # ---- latent update (partitioning, mnmf.py:1018-1073) ----
    if Z is not None:
        num, denom = traces(T, V, Z, H)
        n_, d_ = bin_sums(*(torch.einsum("...ik,...kt,...nit->...nk", T, V, x) for x in (num, denom)))
        Z = Z * torch.sqrt(n_ / d_)
        return T, V, H, Z / Z.sum(dim=-2, keepdim=True)
    return T, V, H


def gauss_mnmf_loss(
    XX: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    H: torch.Tensor,
    Z: Optional[torch.Tensor] = None,
    eps: float = 1e-10,
    psd_impl: str = "auto",
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Negative log-likelihood ``sum_i mean_t [tr(R^-1 XX) + log det R]`` (splitc.py:4306-4331).

    ``R`` is the model projected as :func:`gauss_mnmf_step` projects it.
    One batched LU (``lu_factor_ex``, which reports a singular system
    instead of raising) gives both terms: ``lu_solve`` for the trace and
    the log-magnitudes of its pivots for the log-determinant, as the
    class's ``solve`` and ``slogdet`` (bss/mnmf.py:426-441). A 0-dim tensor
    on the input's device. ``flooring_fn`` as :func:`gauss_mnmf_step` takes it.
    """
    psd_impl, _ = _routes(XX.dtype, psd_impl, flooring_fn=flooring_fn)
    R = psd_project(_model(reconstruct_nmf(T, V, Z), H), eps, psd_impl, flooring_fn=flooring_fn)
    LU, pivots, _ = torch.linalg.lu_factor_ex(R)
    trace = torch.linalg.lu_solve(LU, pivots, XX).diagonal(dim1=-2, dim2=-1).real.sum(dim=-1)
    logdet = torch.log(LU.diagonal(dim1=-2, dim2=-1).abs()).sum(dim=-1)
    return torch.sum(torch.mean(trace + logdet, dim=-1))


def wiener_separate(
    X: torch.Tensor,
    Lamb: torch.Tensor,
    H: torch.Tensor,
    reference_id: int = 0,
    eps: Optional[float] = None,
    flooring_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Multichannel Wiener filter at the reference channel: ``Y (N, I, T)`` from ``X (M, I, T)``.

    ``y_n = [R_n^H R^-H x]_ref`` with ``R_n = Lamb_n H_n`` and ``R = sum_n
    R_n`` (fast.py:902-908), projected first with ``eps`` as the class does
    (bss/mnmf.py:322-334; the step's model for the dtype; ``eps=None``: not
    projected, as the fast path; ``flooring_fn`` as :func:`gauss_mnmf_step`
    takes it).
    The reference forms ``W_n = R^-1 R_n`` for every source, an
    ``(N, I, T, M, M)`` tensor; here one ``solve_ex`` of ``R^H z = x`` serves
    every source, and ``y_n = Lamb_n conj(H_n[:, ref]) . z``.
    """
    R = _model(Lamb, H)
    if eps is not None:
        R = psd_project(R, eps, _routes(R.dtype, flooring_fn=flooring_fn)[0], flooring_fn=flooring_fn)
    z = torch.linalg.solve_ex(R.mH, X.permute(1, 2, 0)[..., None])[0][..., 0]  # (I, T, M)
    return Lamb.to(X.dtype) * torch.einsum("nip,itp->nit", H[..., :, reference_id].conj(), z)
