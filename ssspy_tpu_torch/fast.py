"""Production separator entry points.

Counterpart of :mod:`ssspy_tpu.fast`. The JAX package's ``fast_*`` entry
points run planar ``[real, imag]`` f32 scans; here the same iterations run
on complex64 tensors through the hand-written kernels
(:mod:`ssspy_tpu_torch.ops.kernels`), on the card unless the caller passes
``device="cpu"``. Scale restoration runs on the same device, with
``inv_ex``, where the JAX package does it on the host.

>>> Y, W = fast_auxiva(spectrogram, n_iter=100)                   # (N,I,T), (I,N,M)
>>> Y, (T, V), W = fast_gauss_ilrma(spectrogram, n_basis=8, n_iter=100)
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .algorithm import projection_back
from .ops.ilrma_steps import ilrma_ip_step, ilrma_iss_step
from .ops.iva_steps import auxiva_ip1_step, auxiva_iss1_step, separate
from .utils.device import DEFAULT_DEVICE, resolve_device

__all__ = ["fast_auxiva", "fast_gauss_ilrma", "fast_t_ilrma", "fast_ggd_ilrma"]

_ALGORITHMS = ("IP1", "IP2", "ISS1", "ISS2", "IPA")
_PORTED_ALGORITHMS = ("IP1", "ISS1")


def _check_algorithm(name: str, algorithm: str) -> None:
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unsupported option: {algorithm}.")
    if algorithm not in _PORTED_ALGORITHMS:
        raise NotImplementedError(
            f"{name}(algorithm={algorithm!r}) is not ported to ssspy_tpu_torch yet "
            f"(ROADMAP.md, Queue 1, items 3 and 5); use one of {_PORTED_ALGORITHMS}."
        )


def _spectrogram(spectrogram, device) -> torch.Tensor:
    """The input as a contiguous complex64 tensor on ``device`` (checked)."""
    return torch.as_tensor(spectrogram, device=resolve_device(device)).to(torch.complex64).contiguous()


def _identity_filters(X: torch.Tensor) -> torch.Tensor:
    n_channels, n_bins, _ = X.shape
    return torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(n_bins, -1, -1).contiguous()


def _restore_filters(X, W, reference_id):
    """Rescale each filter row by ``W^{-1}`` at ``reference_id`` (fast.py:122-126)."""
    W = W * torch.linalg.inv_ex(W)[0][:, reference_id, :, None]
    return separate(X, W), W


def fast_auxiva(
    spectrogram,
    n_iter: int = 100,
    algorithm: str = "IP1",
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """AuxLaplaceIVA in complex64 (counterpart of ``ssspy_tpu.fast.fast_auxiva``, fast.py:96-132).

    ``spectrogram``: complex ``(n_channels, n_bins, n_frames)``, a tensor
    or an array. ``algorithm``: ``"IP1"`` (demixing filters) or ``"ISS1"``
    (demix-free). ``device``: the card by default; ``"cpu"`` runs on the
    CPU. Every iteration floors with ``eps=1e-10``, as the JAX fast path
    does. With ``scale_restoration``, IP1 rescales each filter row by
    ``W^{-1}`` at ``reference_id`` and ISS1 projects ``Y`` back onto that
    channel of the mixture (fast.py:60-72). Returns
    ``(separated (N, I, T), demix_filter (I, N, M) or None)``.
    """
    _check_algorithm("fast_auxiva", algorithm)
    X = _spectrogram(spectrogram, device)

    if algorithm == "IP1":
        W = _identity_filters(X)
        for _ in range(n_iter):
            W = auxiva_ip1_step(X, W)
        if scale_restoration:
            return _restore_filters(X, W, reference_id)
        return separate(X, W), W

    Y = X
    for _ in range(n_iter):
        Y = auxiva_iss1_step(Y)
    if scale_restoration:
        Y = projection_back(Y, reference=X, reference_id=reference_id)
    return Y, None


def _fast_ilrma(
    name, spectrogram, n_basis, n_iter, algorithm, scale_restoration, reference_id, rng, device,
    **model,
):
    """The loop shared by the ILRMA fast paths (fast.py:196-325).

    Draws ``T0``, then ``V0``, as ``rng.random(...).astype(float32)``, as the
    JAX package does, then iterates :func:`ilrma_ip_step` or
    :func:`ilrma_iss_step` with their f32 ``eps = 1e-6``.
    """
    _check_algorithm(name, algorithm)
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng
    T = torch.from_numpy(rng.random((n_channels, n_bins, n_basis)).astype(np.float32)).to(X.device)
    V = torch.from_numpy(rng.random((n_channels, n_basis, n_frames)).astype(np.float32)).to(X.device)

    if algorithm == "IP1":
        W = _identity_filters(X)
        for _ in range(n_iter):
            W, T, V = ilrma_ip_step(X, W, T, V, **model)
        if scale_restoration:
            Y, W = _restore_filters(X, W, reference_id)
        else:
            Y = separate(X, W)
        return Y, (T, V), W

    Y = X
    for _ in range(n_iter):
        Y, T, V = ilrma_iss_step(Y, T, V, **model)
    if scale_restoration:
        Y = projection_back(Y, reference=X, reference_id=reference_id)
    return Y, (T, V), None


def fast_gauss_ilrma(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    algorithm: str = "IP1",
    source_algorithm: str = "MM",
    partitioning: bool = False,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """GaussILRMA (MM/ME, power normalization) in complex64 (fast.py:196-259).

    ``algorithm``: ``"IP1"`` or ``"ISS1"``; ``source_algorithm``: MM or ME.
    ``rng`` draws the NMF factors. Returns
    ``(separated, (basis, activation), demix_filter or None)``, tensors on
    ``device``. ``partitioning=True`` waits for ROADMAP.md, Queue 1, item 3.
    """
    if source_algorithm not in ("MM", "ME"):
        raise ValueError(f"unsupported option: {source_algorithm}.")
    if partitioning:
        raise NotImplementedError(
            "fast_gauss_ilrma(partitioning=True) is not ported to ssspy_tpu_torch yet "
            "(ROADMAP.md, Queue 1, item 3)."
        )
    return _fast_ilrma(
        "fast_gauss_ilrma", spectrogram, n_basis, n_iter, algorithm, scale_restoration,
        reference_id, rng, device, model="gauss", me=source_algorithm == "ME",
    )


def fast_t_ilrma(
    spectrogram,
    n_basis: int,
    dof: float,
    n_iter: int = 100,
    algorithm: str = "IP1",
    source_algorithm: str = "MM",
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """TILRMA (Student's-t with ``dof`` degrees of freedom, MM/ME) in complex64 (fast.py:328-357).

    ``algorithm``: ``"IP1"`` or ``"ISS1"``. Returns
    ``(separated, (basis, activation), demix_filter or None)``.
    """
    if source_algorithm not in ("MM", "ME"):
        raise ValueError(f"unsupported option: {source_algorithm}.")
    return _fast_ilrma(
        "fast_t_ilrma", spectrogram, n_basis, n_iter, algorithm, scale_restoration,
        reference_id, rng, device, model="t", dof=float(dof), me=source_algorithm == "ME",
    )


def fast_ggd_ilrma(
    spectrogram,
    n_basis: int,
    beta: float,
    n_iter: int = 100,
    algorithm: str = "IP1",
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """GGDILRMA (generalized Gaussian of shape ``beta`` in (0, 2), MM) in complex64 (fast.py:360-387).

    ``algorithm``: ``"IP1"`` or ``"ISS1"``. Returns
    ``(separated, (basis, activation), demix_filter or None)``.
    """
    if not 0 < beta < 2:
        raise ValueError(f"Shape parameter {beta} should be chosen from (0, 2).")
    return _fast_ilrma(
        "fast_ggd_ilrma", spectrogram, n_basis, n_iter, algorithm, scale_restoration,
        reference_id, rng, device, model="ggd", shape=float(beta),
    )
