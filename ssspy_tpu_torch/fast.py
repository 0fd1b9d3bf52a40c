"""Production separator entry points.

Counterpart of :mod:`ssspy_tpu.fast`. The JAX package's ``fast_*`` entry
points run planar ``[real, imag]`` f32 scans; here the same iterations run
on complex64 tensors through the hand-written kernels
(:mod:`ssspy_tpu_torch.ops.kernels`), on the card unless the caller passes
``device="cpu"``. Scale restoration runs on the same device, with
``inv_ex``, where the JAX package does it on the host.

>>> Y, W = fast_auxiva(spectrogram, n_iter=100)                   # (N,I,T), (I,N,M)
>>> Y, W = fast_auxiva(spectrogram, n_iter=100, algorithm="IP2")
>>> Y, W = fast_auxiva_batch(spectrograms, n_iter=100)            # (B,N,I,T), (B,I,N,M)
>>> Y, (T, V), W = fast_gauss_ilrma(spectrogram, n_basis=8, n_iter=100)
>>> Y = fast_fast_iva(spectrogram, n_iter=100)                      # or fast_faster_iva
>>> Y, W = fast_grad_iva(spectrogram, n_iter=100, natural=True)
>>> Y, W = fast_aux_fdica(spectrogram, n_iter=100, algorithm="IP1")   # aligned across bins
>>> Y, W = fast_grad_fdica(spectrogram, n_iter=100, natural=True)
>>> from ssspy_tpu_torch.bss import PDSIVA
>>> Y, W = fast_pds_iva(PDSIVA().normalize_by_spectral_norm(spectrogram), n_iter=100)
>>> Y, (T, V, H) = fast_gauss_mnmf_dense(spectrogram, n_basis=8, n_iter=100)
>>> Y, (T, V, Q, D) = fast_gauss_mnmf(spectrogram, n_basis=4, n_iter=100)
>>> Y = fast_cacgmm(spectrogram, n_iter=100)                        # (N, I, T)
>>> y = fast_auxiva_wave(waveform, n_iter=100)                       # (N, n_samples)
>>> Y, (T_parts, V), W = fast_gauss_ipsdta(spectrogram, n_basis=8, n_blocks=64, n_iter=100)
"""

from typing import Optional, Tuple

import numpy as np
import torch

from .algorithm import permutation_align, projection_back
from .ops import cacgmm_steps
from .ops.fast_mnmf_steps import check_diagonalizer, fast_gauss_mnmf_step, fast_mnmf_separate
from .ops.fdica_steps import aux_laplace_fdica_ip1_step, aux_laplace_fdica_ip2_step, grad_laplace_fdica_step
from .ops.ilrma_steps import ilrma_ip_step, ilrma_iss_step
from .ops.ipsdta_steps import ipsdta_vcd_step, normalize_psdtf, part_shapes, random_psdtf
from .ops.fixed_point_iva_steps import fast_iva_step, faster_iva_step, whiten_spectrogram
from .ops.iva_steps import (
    auxiva_ip1_step,
    auxiva_ip2_step,
    auxiva_ipa_step,
    auxiva_iss1_step,
    auxiva_iss2_step,
    grad_laplace_iva_step,
    separate,
)
from .ops.mnmf_steps import gauss_mnmf_step, instant_covariance, wiener_separate
from .ops.prox_steps import admm_iva_step, admm_quad_inv, hva_pds_step, pds_iva_step
from .transform import istft, stft
from .utils.device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "fast_auxiva",
    "fast_auxiva_batch",
    "fast_fast_iva",
    "fast_faster_iva",
    "fast_grad_iva",
    "fast_aux_fdica",
    "fast_grad_fdica",
    "fast_auxiva_wave",
    "fast_gauss_ilrma_wave",
    "fast_gauss_ilrma",
    "fast_t_ilrma",
    "fast_ggd_ilrma",
    "fast_pds_iva",
    "fast_admm_iva",
    "fast_hva",
    "fast_gauss_mnmf_dense",
    "fast_gauss_mnmf",
    "fast_cacgmm",
    "fast_gauss_ipsdta",
    "fast_t_ipsdta",
]

_ALGORITHMS = ("IP1", "IP2", "ISS1", "ISS2", "IPA")
_AUXIVA_STEPS = {
    "IP1": auxiva_ip1_step,
    "IP2": auxiva_ip2_step,
    "ISS1": auxiva_iss1_step,
    "ISS2": auxiva_iss2_step,
    "IPA": auxiva_ipa_step,
}


def _check_algorithm(name: str, algorithm: str, allowed=_ALGORITHMS) -> None:
    """Raise for an unknown ``algorithm`` and for one that ``name`` does not have, as its JAX twin does."""
    if algorithm not in _ALGORITHMS:
        raise ValueError(f"unsupported option: {algorithm}.")
    if algorithm not in allowed:
        raise ValueError(f"{name} has no {algorithm} spatial update; use one of {allowed}.")


def _spectrogram(spectrogram, device) -> torch.Tensor:
    """The input as a contiguous complex64 tensor on ``device`` (checked)."""
    return torch.as_tensor(spectrogram, device=resolve_device(device)).to(torch.complex64).contiguous()


def _identity_filters(X: torch.Tensor) -> torch.Tensor:
    n_channels, n_bins, _ = X.shape
    return torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(n_bins, -1, -1).contiguous()


def _restored(X, W, scale_restoration, reference_id):
    """``(separated, W)``; with ``scale_restoration`` each filter row is first rescaled by ``W^{-1}`` at ``reference_id`` (fast.py:122-126)."""
    if scale_restoration:
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
    or an array. ``algorithm``: ``"IP1"`` or ``"IP2"`` (demixing filters;
    IP2 over the sequential pairs, K1 once a pair), ``"ISS1"``, ``"ISS2"``
    or ``"IPA"`` (demix-free). ``device``: the card by default; ``"cpu"``
    runs on the CPU. Every iteration floors with ``eps=1e-10``, as the JAX
    fast path does. With ``scale_restoration``, IP1 and IP2 rescale each
    filter row by ``W^{-1}`` at ``reference_id`` and the demix-free
    algorithms project ``Y`` back onto that channel of the mixture
    (fast.py:60-72). Returns ``(separated (N, I, T), demix_filter (I, N, M)
    or None)``.
    """
    _check_algorithm("fast_auxiva", algorithm)
    X = _spectrogram(spectrogram, device)
    step = _AUXIVA_STEPS[algorithm]

    if algorithm in ("IP1", "IP2"):
        W = _identity_filters(X)
        for _ in range(n_iter):
            W = step(X, W)
        return _restored(X, W, scale_restoration, reference_id)

    Y = X
    for _ in range(n_iter):
        Y = step(Y)
    if scale_restoration:
        Y = projection_back(Y, reference=X, reference_id=reference_id)
    return Y, None


def fast_auxiva_batch(
    spectrograms,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    layout=None,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AuxLaplaceIVA-IP1 in complex64 over an utterance batch (counterpart of ``ssspy_tpu.fast.fast_auxiva_batch``, fast.py:135-168).

    ``spectrograms``: complex ``(batch, n_channels, n_bins, n_frames)``, a
    tensor or an array. The batch runs through
    :func:`ssspy_tpu_torch.parallel.make_batched_auxiva_runner` over
    ``layout``: by default :func:`~ssspy_tpu_torch.parallel.make_layout` on
    ``device``, every rank of an initialized process group, or this process
    alone without one (then the utterances share each iteration's
    launches: K1 once per utterance, K1b once for all). With a group every
    rank calls this with the same batch, whose size must divide over the
    layout's ``dp``; the bins need not divide over its ``bin``. With
    ``scale_restoration`` each filter row is rescaled by ``W^{-1}`` at
    ``reference_id``. Returns ``(separated (B, N, I, T), demix_filter (B,
    I, N, M))`` on the layout's device, on every rank.
    """
    from .parallel import make_batched_auxiva_runner, make_layout

    layout = make_layout(device=device) if layout is None else layout
    X = torch.as_tensor(spectrograms).to(torch.complex64)
    n_batch, n_channels, n_bins, _ = X.shape
    W = torch.eye(n_channels, dtype=X.dtype).expand(n_batch, n_bins, -1, -1)
    W = make_batched_auxiva_runner(layout)(X, W, n_iter)
    if scale_restoration:
        W = W * torch.linalg.inv_ex(W)[0][..., reference_id, :, None]
    return separate(X.to(W.device), W), W


def _fast_fixed_point_iva(spectrogram, n_iter, step, scale_restoration, reference_id, device) -> torch.Tensor:
    """Whitening, ``n_iter`` steps from ``W = I``, separation and projection back, all on ``device`` (fast.py:486-510)."""
    X = _spectrogram(spectrogram, device)
    Z = whiten_spectrogram(X)
    W = _identity_filters(X)
    for _ in range(n_iter):
        W = step(Z, W)
    Y = separate(Z, W)
    if scale_restoration:
        Y = projection_back(Y, reference=X, reference_id=reference_id)
    return Y


def fast_fast_iva(
    spectrogram, n_iter: int = 100, scale_restoration: bool = True, reference_id: int = 0, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """FastIVA (whitened fixed point, Laplace contrast) in complex64 (fast.py:542-557).

    The whitening (one launch of the Jacobi eigh K7), ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.fixed_point_iva_steps.fast_iva_step` at
    ``eps = 1e-10`` (K7 once per step, the polar factor) from ``W = I``, the
    separation and, with ``scale_restoration``, projection back onto the
    ``reference_id`` channel of the unwhitened input, all on ``device``.
    Returns the separated spectrograms ``(N, I, T)``.
    """
    return _fast_fixed_point_iva(spectrogram, n_iter, fast_iva_step, scale_restoration, reference_id, device)


def fast_faster_iva(
    spectrogram, n_iter: int = 100, scale_restoration: bool = True, reference_id: int = 0, device=DEFAULT_DEVICE
) -> torch.Tensor:
    """FasterIVA (top-eigenvector update, Laplace contrast) in complex64 (fast.py:560-573).

    As :func:`fast_fast_iva`, with
    :func:`~ssspy_tpu_torch.ops.fixed_point_iva_steps.faster_iva_step`: per
    step the weighted covariance K1 (``(N, T)`` weights) and K7 twice (the
    top eigenvectors at ``(I N, 2M, 2M)``, the polar factor). Returns the
    separated spectrograms ``(N, I, T)``.
    """
    return _fast_fixed_point_iva(spectrogram, n_iter, faster_iva_step, scale_restoration, reference_id, device)


def fast_grad_iva(
    spectrogram,
    n_iter: int = 100,
    step_size: float = 1e-1,
    natural: bool = False,
    is_holonomic: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad/NaturalGrad Laplace IVA in complex64 (fast.py:576-622).

    ``n_iter`` steps of :func:`~ssspy_tpu_torch.ops.iva_steps.grad_laplace_iva_step`
    at ``eps = 1e-10`` from ``W = I`` (no kernel: the vanilla gradient's
    ``W^-H`` is a ``solve_ex``), then the filters rescaled by ``W^-1`` at
    ``reference_id`` with ``scale_restoration``. Returns
    ``(separated (N, I, T), demix_filter (I, N, M))`` on ``device``.
    """
    X = _spectrogram(spectrogram, device)
    W = _identity_filters(X)
    for _ in range(n_iter):
        W = grad_laplace_iva_step(X, W, step_size=step_size, is_holonomic=is_holonomic, natural=natural)
    return _restored(X, W, scale_restoration, reference_id)


def _fdica_end(X, W, permutation_alignment, scale_restoration, reference_id):
    """FDICA's end on the device: ``(separated, W)`` aligned across bins, then rescaled (fast.py:533-540)."""
    Y = separate(X, W)
    if permutation_alignment:
        Y, W = permutation_align(Y.transpose(0, 1), W)
        Y = Y.transpose(0, 1)
    if scale_restoration:
        Y, W = _restored(X, W, True, reference_id)
    return Y, W


def fast_aux_fdica(
    spectrogram,
    n_iter: int = 100,
    algorithm: str = "IP1",
    permutation_alignment: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AuxLaplaceFDICA in complex64 (counterpart of ``ssspy_tpu.fast.fast_aux_fdica``, fast.py:494-541).

    ``algorithm``: ``"IP1"`` (per iteration K1 with ``(N, I, T)`` weights and
    the IP1 sweep K1b) or ``"IP2"`` (the sequential pairs, K1 at two sources
    once a pair). ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.fdica_steps.aux_laplace_fdica_ip1_step` or
    ``_ip2_step`` at the JAX step's ``eps = 1e-6`` from ``W = I``; then, with
    ``permutation_alignment``, the sources aligned across bins by amplitude
    correlation (:func:`~ssspy_tpu_torch.algorithm.permutation_alignment.permutation_align`)
    and, with ``scale_restoration``, each filter row rescaled by ``W^-1`` at
    ``reference_id``, all on ``device``, where the JAX package aligns and
    rescales on the host. Returns ``(separated (N, I, T), demix_filter (I, N, M))``.
    """
    _check_algorithm("fast_aux_fdica", algorithm, ("IP1", "IP2"))
    X = _spectrogram(spectrogram, device)
    step = aux_laplace_fdica_ip1_step if algorithm == "IP1" else aux_laplace_fdica_ip2_step
    W = _identity_filters(X)
    for _ in range(n_iter):
        W = step(X, W)
    return _fdica_end(X, W, permutation_alignment, scale_restoration, reference_id)


def fast_grad_fdica(
    spectrogram,
    n_iter: int = 100,
    step_size: float = 1e-1,
    natural: bool = False,
    is_holonomic: bool = False,
    permutation_alignment: bool = True,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad/NaturalGrad Laplace FDICA in complex64 (fast.py:653-706).

    ``n_iter`` steps of :func:`~ssspy_tpu_torch.ops.fdica_steps.grad_laplace_fdica_step`
    at ``eps = 1e-10`` from ``W = I`` (no kernel), then alignment and scale
    restoration as :func:`fast_aux_fdica` does them. Returns
    ``(separated (N, I, T), demix_filter (I, N, M))`` on ``device``.
    """
    X = _spectrogram(spectrogram, device)
    W = _identity_filters(X)
    for _ in range(n_iter):
        W = grad_laplace_fdica_step(X, W, step_size=step_size, is_holonomic=is_holonomic, natural=natural)
    return _fdica_end(X, W, permutation_alignment, scale_restoration, reference_id)


def _wave(waveform, n_fft: int, hop_length: Optional[int], device):
    """``(x, X, hop)``: the waveform as float32 ``(n_channels, n_samples)`` on ``device`` and its STFT, complex64."""
    x = torch.as_tensor(waveform, device=resolve_device(device)).to(torch.float32)
    if x.dim() != 2:
        raise ValueError("waveform must be (n_channels, n_samples)")
    hop = n_fft // 2 if hop_length is None else hop_length
    return x, stft(x, n_fft=n_fft, hop_length=hop, device=x.device).contiguous(), hop


def fast_auxiva_wave(
    waveform,
    n_iter: int = 100,
    algorithm: str = "IP1",
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Waveform-to-waveform AuxLaplaceIVA in complex64 (fast.py:770-848), end to end on ``device``.

    ``waveform``: real ``(n_channels, n_samples)``, a tensor or an array,
    taken as float32. The STFT (cuFFT on the card), :func:`fast_auxiva`'s
    iterations (every ``algorithm`` it takes, through the kernels'
    routers), projection back onto channel 0 and the iSTFT all run on
    ``device``: nothing crosses to the host before the output. Returns the
    separated waveforms ``(n_sources, n_samples)``, float32.
    """
    _check_algorithm("fast_auxiva_wave", algorithm)
    x, X, hop = _wave(waveform, n_fft, hop_length, device)
    Y, _ = fast_auxiva(X, n_iter=n_iter, algorithm=algorithm, device=X.device)
    return istft(Y, n_fft=n_fft, hop_length=hop, length=x.shape[-1], device=x.device)


def fast_gauss_ilrma_wave(
    waveform,
    n_basis: int,
    n_iter: int = 100,
    algorithm: str = "IP1",
    n_fft: int = 512,
    hop_length: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """Waveform-to-waveform GaussILRMA (MM, power normalization) in complex64 (fast.py:1017-1123), end to end on ``device``.

    The ILRMA twin of :func:`fast_auxiva_wave`: ``algorithm`` ``"IP1"`` or
    ``"ISS1"``, as its JAX twin takes (fast.py:1043); ``rng`` draws the basis, then the activation, at the
    STFT's shape, as the JAX package does. Returns ``(n_sources,
    n_samples)``, float32.
    """
    _check_algorithm("fast_gauss_ilrma_wave", algorithm, ("IP1", "ISS1"))
    x, X, hop = _wave(waveform, n_fft, hop_length, device)
    Y, _, _ = fast_gauss_ilrma(X, n_basis=n_basis, n_iter=n_iter, algorithm=algorithm, rng=rng, device=X.device)
    return istft(Y, n_fft=n_fft, hop_length=hop, length=x.shape[-1], device=x.device)


def _fast_ilrma(
    name, spectrogram, n_basis, n_iter, algorithm, scale_restoration, reference_id, rng, device,
    partitioning=False, **model,
):
    """The loop shared by the ILRMA fast paths (fast.py:196-483).

    Draws ``T0``, then ``V0``, as ``rng.random(...).astype(float32)``, as the
    JAX package does; with ``partitioning`` the latent ``Z0`` (divided by
    its sum over sources) comes first and all three are floored at 1e-10
    (fast.py:402-406). Then it iterates :func:`ilrma_ip_step` or
    :func:`ilrma_iss_step` (ISS1, ISS2, IPA) with their f32 ``eps = 1e-6``;
    the factors come back as ``(T, V)`` or ``(T, V, Z)``. The t and GGD
    models take IP1, IP2, ISS1 and ISS2, as the JAX package's do
    (fast.py:474).
    """
    _check_algorithm(name, algorithm, _ALGORITHMS if model["model"] == "gauss" else ("IP1", "IP2", "ISS1", "ISS2"))
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng
    if partitioning:
        Z0 = rng.random((n_channels, n_basis))
        draws = [rng.random((n_bins, n_basis)), rng.random((n_basis, n_frames)), Z0 / Z0.sum(axis=0)]
        draws = [np.maximum(draw, 1e-10) for draw in draws]
    else:
        draws = [rng.random((n_channels, n_bins, n_basis)), rng.random((n_channels, n_basis, n_frames))]
    factors = tuple(torch.from_numpy(draw.astype(np.float32)).to(X.device) for draw in draws)

    if algorithm in ("IP1", "IP2"):
        W = _identity_filters(X)
        for _ in range(n_iter):
            W, *factors = ilrma_ip_step(X, W, *factors, spatial=algorithm, **model)
        Y, W = _restored(X, W, scale_restoration, reference_id)
        return Y, tuple(factors), W

    Y = X
    for _ in range(n_iter):
        Y, *factors = ilrma_iss_step(Y, *factors, spatial=algorithm, **model)
    if scale_restoration:
        Y = projection_back(Y, reference=X, reference_id=reference_id)
    return Y, tuple(factors), None


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

    ``algorithm``: ``"IP1"``, ``"IP2"``, ``"ISS1"``, ``"ISS2"`` or ``"IPA"``;
    ``source_algorithm``: MM or ME. ``rng`` draws the NMF factors. ``partitioning=True`` selects
    the shared-basis latent model (fast.py:390-455). Returns
    ``(separated, (basis, activation), demix_filter or None)``, with
    ``(basis, activation, latent)`` under ``partitioning``, tensors on
    ``device``.
    """
    if source_algorithm not in ("MM", "ME"):
        raise ValueError(f"unsupported option: {source_algorithm}.")
    return _fast_ilrma(
        "fast_gauss_ilrma", spectrogram, n_basis, n_iter, algorithm, scale_restoration,
        reference_id, rng, device, partitioning=partitioning, model="gauss", me=source_algorithm == "ME",
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

    ``algorithm``: ``"IP1"``, ``"IP2"``, ``"ISS1"`` or ``"ISS2"``. Returns
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

    ``algorithm``: ``"IP1"``, ``"IP2"``, ``"ISS1"`` or ``"ISS2"``. Returns
    ``(separated, (basis, activation), demix_filter or None)``.
    """
    if not 0 < beta < 2:
        raise ValueError(f"Shape parameter {beta} should be chosen from (0, 2).")
    return _fast_ilrma(
        "fast_ggd_ilrma", spectrogram, n_basis, n_iter, algorithm, scale_restoration,
        reference_id, rng, device, model="ggd", shape=float(beta),
    )


def fast_pds_iva(
    spectrogram,
    n_iter: int = 100,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PDSIVA (primal-dual splitting, L21 penalty) in complex64 (fast.py:1176-1217).

    From ``W = I`` and a zero dual, ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.prox_steps.pds_iva_step`, whose log-det
    prox runs the Jacobi kernel once per step. Returns
    ``(separated (N, I, T), demix_filter (I, N, M))`` on ``device``, the
    filters rescaled by ``W^{-1}`` at ``reference_id`` when
    ``scale_restoration``.
    """
    X = _spectrogram(spectrogram, device)
    W, Y = _identity_filters(X), torch.zeros_like(X)
    for _ in range(n_iter):
        W, Y = pds_iva_step(X, W, Y, mu1=mu1, mu2=mu2, relaxation=relaxation)
    return _restored(X, W, scale_restoration, reference_id)


def fast_admm_iva(
    spectrogram,
    n_iter: int = 100,
    rho: float = 1.0,
    relaxation: float = 1.0,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ADMMIVA (two auxiliary/dual pairs, L21 penalty) in complex64 (fast.py:1220-1273).

    ``(X X^H + I)^{-1}`` is taken once, then ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.prox_steps.admm_iva_step` from zero
    auxiliaries and duals; every step, the last included, is the same call,
    and the filters are the last step's ``W``. Returns
    ``(separated, demix_filter)`` as :func:`fast_pds_iva` does.
    """
    if n_iter < 1:
        raise ValueError("n_iter must be at least 1.")
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, _ = X.shape
    quad_inv = admm_quad_inv(X)
    V = Y = torch.zeros((n_bins, n_channels, n_channels), dtype=X.dtype, device=X.device)
    Vt = Yt = torch.zeros_like(X)
    for _ in range(n_iter):
        W, V, Vt, Y, Yt = admm_iva_step(X, V, Vt, Y, Yt, rho=rho, relaxation=relaxation, quad_inv=quad_inv)
    return _restored(X, W, scale_restoration, reference_id)


def fast_hva(
    spectrogram,
    n_iter: int = 100,
    mu1: float = 1.0,
    mu2: float = 1.0,
    relaxation: float = 1.0,
    attenuation: Optional[float] = None,
    mask_iter: int = 1,
    scale_restoration: bool = True,
    reference_id: int = 0,
    device=DEFAULT_DEVICE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HVA (masking primal-dual splitting) in complex64 (fast.py:1276-1335).

    ``n_iter`` steps of :func:`~ssspy_tpu_torch.ops.prox_steps.hva_pds_step`
    (harmonic mask floored at ``1e-10``, ``attenuation`` ``1 / N`` by
    default) from ``W = I`` and a zero dual. Returns
    ``(separated, demix_filter)`` as :func:`fast_pds_iva` does.
    """
    X = _spectrogram(spectrogram, device)
    W, Y = _identity_filters(X), torch.zeros_like(X)
    for _ in range(n_iter):
        W, Y = hva_pds_step(
            X, W, Y, mu1=mu1, mu2=mu2, relaxation=relaxation, attenuation=attenuation, mask_iter=mask_iter
        )
    return _restored(X, W, scale_restoration, reference_id)


def fast_gauss_mnmf_dense(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """GaussMNMF with dense spatial covariances in complex64 (fast.py:849-909).

    Draws ``T0``, then ``V0``, as ``max(rng.random(...), 1e-10)`` in
    float32, and starts from ``H0 = I / M``, as the JAX package does;
    ``n_sources`` may be smaller or larger than the number of channels.
    ``n_iter`` steps of :func:`~ssspy_tpu_torch.ops.mnmf_steps.gauss_mnmf_step`
    at ``eps = 1e-10`` (three launches of the fused kernel K5 and one of K7
    per step), then the multichannel Wiener filter at ``reference_id``, all
    on ``device``. Returns ``(separated (N, I, T), (T, V, H))``.
    """
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, n_frames = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng
    T, V = (
        torch.from_numpy(np.maximum(rng.random(shape), 1e-10).astype(np.float32)).to(X.device)
        for shape in ((n_sources, n_bins, n_basis), (n_sources, n_basis, n_frames))
    )
    H = torch.eye(n_channels, dtype=X.dtype, device=X.device) / n_channels
    H = H.expand(n_sources, n_bins, -1, -1).contiguous()
    XX = instant_covariance(X)
    for _ in range(n_iter):
        T, V, H = gauss_mnmf_step(XX, T, V, H)
    return wiener_separate(X, T @ V, H, reference_id=reference_id), (T, V, H)


def fast_gauss_mnmf(
    spectrogram,
    n_basis: int,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    diagonalizer_algorithm: str = "IP1",
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """FastGaussMNMF (jointly diagonalized spatial model) in complex64 (fast.py:708-768).

    Draws ``T0``, then ``V0`` as ``rng.random(...)`` and ``D0`` as
    ``max(rng.random(...), 1e-10)``, all in float32, and starts from ``Q0 =
    I``, as the JAX package does. ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.fast_mnmf_steps.fast_gauss_mnmf_step` at
    ``eps = 1e-6`` (one launch of the weighted covariance K1, with
    per-channel weights, per step, then the IP1 sweep K1b or, with
    ``diagonalizer_algorithm="IP2"``, M sequential pair updates), then the
    Wiener filter in the diagonalized space at ``reference_id``
    (:func:`~ssspy_tpu_torch.ops.fast_mnmf_steps.fast_mnmf_separate`), all on
    ``device``, where the JAX package runs the filter on the host. Returns
    ``(separated (N, I, T), (T, V, Q, D))``.
    """
    check_diagonalizer(diagonalizer_algorithm)
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, n_frames = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng
    T = rng.random((n_sources, n_bins, n_basis))
    V = rng.random((n_sources, n_basis, n_frames))
    D = np.maximum(rng.random((n_bins, n_sources, n_channels)), 1e-10)
    T, V, D = (torch.from_numpy(draw.astype(np.float32)).to(X.device) for draw in (T, V, D))
    Q = _identity_filters(X)
    for _ in range(n_iter):
        Q, T, V, D = fast_gauss_mnmf_step(X, Q, T, V, D, diagonalizer=diagonalizer_algorithm)
    return fast_mnmf_separate(X, T, V, Q, D, reference_id=reference_id), (T, V, Q, D)


def fast_cacgmm(
    spectrogram,
    n_iter: int = 100,
    n_sources: Optional[int] = None,
    permutation_alignment: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
) -> torch.Tensor:
    """cACGMM in complex64 (fast.py:1124-1174): EM, posterior masks and their alignment, on ``device``.

    The observations are the mixture over its norm across channels (floored
    at 1e-10). Draws the mixing weights ``(N, I)``, normalized over
    sources, then the covariances' diagonals ``(N, I, M)``, normalized over
    channels, as the JAX package does; ``n_sources`` may exceed the number
    of channels. ``n_iter`` EM steps of
    :func:`~ssspy_tpu_torch.ops.cacgmm_steps.step` at ``eps = 1e-10`` (the
    embedded eigh K7 twice per step; the class :class:`~ssspy_tpu_torch.bss.CACGMM`
    also takes the step's other routes), the posterior of the final parameters, the soft masks applied
    to the ``reference_id`` channel and, with ``permutation_alignment``, the
    masked spectrograms aligned by amplitude correlation
    (:func:`~ssspy_tpu_torch.algorithm.permutation_alignment.permutation_align`),
    where the JAX package aligns on the host. Returns the separated
    spectrograms ``(n_sources, n_bins, n_frames)``.
    """
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, _ = X.shape
    n_sources = n_channels if n_sources is None else n_sources
    rng = np.random.default_rng() if rng is None else rng
    Z = X / torch.clamp(torch.linalg.vector_norm(X, dim=0), min=1e-10)
    alpha = rng.random((n_sources, n_bins))
    B_diag = rng.random((n_sources, n_bins, n_channels))
    B = (B_diag / B_diag.sum(axis=-1, keepdims=True))[..., None] * np.eye(n_channels)
    alpha = torch.from_numpy((alpha / alpha.sum(axis=0)).astype(np.float32)).to(X.device)
    B = torch.from_numpy(B.astype(np.float32)).to(device=X.device, dtype=X.dtype)
    for _ in range(n_iter):
        alpha, B = cacgmm_steps.step(Z, alpha, B)
    gamma = cacgmm_steps.posterior(Z, alpha, B)
    Y = gamma.to(X.dtype) * X[reference_id]  # (N, I, T)
    if permutation_alignment:
        Y = permutation_align(Y.transpose(0, 1)).transpose(0, 1)
    return Y


def fast_gauss_ipsdta(
    spectrogram,
    n_basis: int,
    n_blocks: int,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """GaussIPSDTA (MM source, VCD spatial) in complex64 (fast.py:912-933).

    The block-decomposed PSDTF of :mod:`~ssspy_tpu_torch.ops.ipsdta_steps`,
    the remainder part included when ``n_blocks`` does not divide the bins.
    Returns ``(separated, (basis_parts, activation), demix_filter)``, the
    basis as a list of parts. See :func:`fast_t_ipsdta` for the start.
    """
    return _fast_ipsdta(spectrogram, n_basis, n_blocks, None, n_iter, scale_restoration, reference_id, rng, device)


def fast_t_ipsdta(
    spectrogram,
    n_basis: int,
    n_blocks: int,
    dof: float,
    n_iter: int = 100,
    scale_restoration: bool = True,
    reference_id: int = 0,
    rng: Optional[np.random.Generator] = None,
    device=DEFAULT_DEVICE,
):
    """TIPSDTA (Student's-t source with ``dof``, VCD spatial) in complex64 (fast.py:936-955).

    Draws each part's diagonal basis, then the activation as
    ``max(rng.random(...), 1e-10)``, in float32, normalizes the basis to unit
    summed trace and starts from ``W = I``, as the JAX package does
    (fast.py:958-990); then ``n_iter`` steps of
    :func:`~ssspy_tpu_torch.ops.ipsdta_steps.ipsdta_vcd_step` at
    ``eps = 1e-10`` (three launches of the inverse kernel K3 per part and
    step; the geometric means' or square roots' eigh through K7) and, with
    ``scale_restoration``, projection back at ``reference_id``, all on
    ``device``. Returns ``(separated, (basis_parts, activation),
    demix_filter)``.
    """
    return _fast_ipsdta(
        spectrogram, n_basis, n_blocks, float(dof), n_iter, scale_restoration, reference_id, rng, device
    )


def _fast_ipsdta(spectrogram, n_basis, n_blocks, dof, n_iter, scale_restoration, reference_id, rng, device):
    X = _spectrogram(spectrogram, device)
    n_channels, n_bins, n_frames = X.shape
    rng = np.random.default_rng() if rng is None else rng
    T_parts, V = random_psdtf(
        rng, n_channels, n_basis, n_frames, part_shapes(n_bins, n_blocks), X.dtype, X.device, 1e-10
    )
    T_parts, V = normalize_psdtf(T_parts, V)
    W = _identity_filters(X)
    for _ in range(n_iter):
        W, T_parts, V = ipsdta_vcd_step(X, W, T_parts, V, dof=dof)
    Y, W = _restored(X, W, scale_restoration, reference_id)
    return Y, (T_parts, V), W
