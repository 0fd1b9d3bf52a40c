"""The ILRMA iterations (Gauss, t and GGD source models; IP1, IP2, ISS1, ISS2 and IPA) and their loss.

Counterparts of the generic ILRMA engine in ``ssspy_tpu/ops/splitc.py``
(splitc.py:414-449, :477-520, :589-693, :712-803, :2267-2328, :4210-4261)
on native complex tensors. The NMF products ``T @ V`` and the
multiplicative-update contractions are plain matrix products, as in the
JAX package, where they stay outside any Pallas kernel. The spatial update
goes through the routers of :mod:`ssspy_tpu_torch.ops.iva_steps` to the
kernels of :mod:`ssspy_tpu_torch.ops.kernels`: the weighted covariance with
per-bin weights ``(N, I, T)`` and the IP1 sweep or the IP2 pair updates,
the ISS1 sweep, the ISS2 sweep (no kernel), or the IPA sweep of
:mod:`ssspy_tpu_torch.ops.ipa_steps` (Gauss only). The pairwise updates
take any ``pair_selector`` (sequential by default).

``model`` is ``"gauss"``, ``"t"`` (``dof`` = nu) or ``"ggd"`` (``shape`` =
beta); ``p`` is the domain parameter; ``me=True`` selects the ME source
update (Gauss and t, ``p == 2``). With a latent ``Z (N, K)`` the sources
share one basis ``T (I, K)`` and one activation ``V (K, T)`` (the
partitioned model, ``r_nit = sum_k z_nk t_ik v_kt``), and each step also
returns the new ``Z``.

:func:`ilrma_ip_step` without a latent also takes a batch of utterances on
a leading axis and ``bin_sum``, as the multi-device runners of
:mod:`ssspy_tpu_torch.parallel` call it: the activation update's
numerator and denominator (one call of the hook) and the power
normalization's sum over bins (another) are summed over the bin group.
"""

from typing import Callable, Optional, Tuple

import torch

from .ipa_steps import ipa_sweep
from .iva_steps import (
    clogabsdet,
    covariance,
    ip1_update,
    ip2_update,
    iss1_update,
    iss2_sweep,
    ls_demix,
    separate,
)

__all__ = [
    "power",
    "ilrma_model_weights",
    "ilrma_model_varphi",
    "reconstruct_nmf",
    "ilrma_mm_core",
    "ilrma_mm_core_partitioning",
    "power_normalize_partitioning",
    "ilrma_ip_step",
    "ilrma_iss_step",
    "gauss_ilrma_ip1_step",
    "gauss_ilrma_ip2_step",
    "gauss_ilrma_iss1_step",
    "gauss_ilrma_iss2_step",
    "gauss_ilrma_ipa_step",
    "ilrma_loss",
]


def power(Y: torch.Tensor) -> torch.Tensor:
    """``|y|^2`` of a complex tensor as the sum of the squared parts."""
    return Y.real.square() + Y.imag.square()


def _max_floor(eps: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: torch.clamp(x, min=eps)


def ilrma_model_weights(
    model: str, Y2: torch.Tensor, R: torch.Tensor, p: float, nu=None, beta=None, me: bool = False
) -> Tuple[torch.Tensor, float, float]:
    """MM numerator weight ``(N, I, T)``, exponent and scalar factor of a source model.

    Counterpart of ``splitc._ilrma_model_weights`` (splitc.py:589-611).
    """
    if model == "gauss":
        if me:
            return Y2 / (R**2), 1.0, 1.0
        return Y2 / (R ** ((p + 2) / p)), p / (p + 2), 1.0
    if model == "t":
        nu_nu2 = nu / (nu + 2)
        if me:
            R_tilde = nu_nu2 * R + (1 - nu_nu2) * Y2
            return Y2 / (R_tilde * R), 1.0, 1.0
        R_tilde = nu_nu2 * (R ** (2 / p)) + (1 - nu_nu2) * Y2
        return Y2 / (R_tilde * R), p / (p + 2), 1.0
    if model == "ggd":
        Yb = Y2 ** (beta / 2)
        return Yb / (R ** ((beta + p) / p)), p / (beta + p), beta / 2
    raise ValueError(f"unsupported option: {model}.")


def ilrma_model_varphi(
    model: str, Y2: torch.Tensor, R: torch.Tensor, p: float, nu=None, beta=None, floor=None
) -> torch.Tensor:
    """Spatial-update weight ``varphi[n, i, t]`` of a source model.

    ``floor`` floors GGD's ``|y|^(2 - beta)``. Counterpart of
    ``splitc._ilrma_model_varphi`` (splitc.py:614-628).
    """
    if model == "gauss":
        return 1 / (R ** (2 / p))
    if model == "t":
        nu_nu2 = nu / (nu + 2)
        return 1 / (nu_nu2 * (R ** (2 / p)) + (1 - nu_nu2) * Y2)
    if model == "ggd":
        return 1 / ((2 / beta) * floor(Y2 ** ((2 - beta) / 2)) * (R ** (beta / p)))
    raise ValueError(f"unsupported option: {model}.")


def ilrma_mm_core(
    Y2: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    *,
    model: str,
    p: float,
    floor: Callable,
    floor_model: Callable,
    nu=None,
    beta=None,
    me: bool = False,
    bin_sum=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Basis, then activation multiplicative update; returns ``(T, V, R)``.

    ``Y2``: source powers ``(N, I, T)``; ``T``: basis ``(N, I, K)``;
    ``V``: activation ``(N, K, T)``. ``floor`` floors the new factors and
    ``floor_model`` the model ``R = T @ V``: ``max(., eps)`` both on the
    fast path (splitc.py:673-693); the class's ``flooring_fn`` and no floor
    on the class path (ssspy_tpu/bss/ilrma.py:662-696). Any leading batch
    axes; with ``bin_sum`` the activation's numerator and denominator, sums
    over the bins, are summed over the bin group in one call.
    """
    R = floor_model(T @ V)
    w, ex, fac = ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * torch.einsum("...nkt,...nit->...nik", V, w)
    denom = torch.einsum("...nkt,...nit->...nik", V, 1 / R)
    T = floor(((num / denom) ** ex) * T)

    R = floor_model(T @ V)
    w, ex, fac = ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * torch.einsum("...nik,...nit->...nkt", T, w)
    denom = torch.einsum("...nik,...nit->...nkt", T, 1 / R)
    if bin_sum is not None:
        num, denom = bin_sum(num, denom)
    V = floor(((num / denom) ** ex) * V)

    return T, V, floor_model(T @ V)


def reconstruct_nmf(T: torch.Tensor, V: torch.Tensor, Z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NMF power model ``(N, I, T)``: ``T @ V`` per source, or ``sum_k z_nk t_ik v_kt`` with a latent ``Z``."""
    if Z is None:
        return T @ V
    return torch.einsum("...nk,...ik,...kt->...nit", Z, T, V)


def ilrma_mm_core_partitioning(
    Y2: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z: torch.Tensor,
    *,
    model: str,
    p: float,
    floor: Callable,
    floor_model: Callable,
    nu=None,
    beta=None,
    me: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Latent, basis, then activation update of the shared-basis model; returns ``(T, V, Z, R)``.

    ``Z``: latent ``(N, K)``, renormalized over sources after its update and
    not floored; ``T``: basis ``(I, K)``; ``V``: activation ``(K, T)``.
    ``floor`` and ``floor_model`` as in :func:`ilrma_mm_core`. Counterpart
    of ``splitc._ilrma_mm_core_partitioning`` (splitc.py:631-662) and of the
    class's ``_update_latent`` / ``_update_basis`` / ``_update_activation``
    (ssspy_tpu/bss/ilrma.py:650-696).
    """

    def weights(T, V, Z):
        R = floor_model(reconstruct_nmf(T, V, Z))
        w, ex, fac = ilrma_model_weights(model, Y2, R, p, nu, beta, me)
        return fac * w, 1 / R, ex

    w, r_inv, ex = weights(T, V, Z)
    Z = (torch.einsum("ik,kt,nit->nk", T, V, w) / torch.einsum("ik,kt,nit->nk", T, V, r_inv)) ** ex * Z
    Z = Z / Z.sum(dim=0)

    w, r_inv, ex = weights(T, V, Z)
    T = floor((torch.einsum("nk,kt,nit->ik", Z, V, w) / torch.einsum("nk,kt,nit->ik", Z, V, r_inv)) ** ex * T)

    w, r_inv, ex = weights(T, V, Z)
    V = floor((torch.einsum("nk,ik,nit->kt", Z, T, w) / torch.einsum("nk,ik,nit->kt", Z, T, r_inv)) ** ex * V)

    return T, V, Z, floor_model(reconstruct_nmf(T, V, Z))


def power_normalize_partitioning(psi: torch.Tensor, T: torch.Tensor, Z: torch.Tensor, p: float):
    """Power normalization of the shared-basis factors; returns ``(T, Z)`` (splitc.py:665-670)."""
    Z_psi = Z / (psi[:, None] ** p)
    scale = Z_psi.sum(dim=0)  # (K,)
    return T * scale, Z_psi / scale


def _check_spatial(spatial: str, allowed) -> None:
    if spatial not in allowed:
        raise ValueError(f"unsupported option: {spatial}.")


def _source_model(Y2, T, V, Z, *, model, p, eps, dof, shape, me, bin_sum=None):
    """The fast paths' source-model update, every floor ``max(., eps)``: ``(T, V, Z, varphi)``."""
    floor = _max_floor(eps)
    kw = dict(model=model, p=p, floor=floor, floor_model=floor, nu=dof, beta=shape, me=me)
    if Z is None:
        T, V, R = ilrma_mm_core(Y2, T, V, bin_sum=bin_sum, **kw)
    else:
        if bin_sum is not None:
            raise ValueError("the partitioned ILRMA model has no bin-sharded step")
        T, V, Z, R = ilrma_mm_core_partitioning(Y2, T, V, Z, **kw)
    return T, V, Z, ilrma_model_varphi(model, Y2, R, p, dof, shape, floor)


def _power_normalize(Y: torch.Tensor, T: torch.Tensor, Z, p: float, eps: float, bin_sum=None):
    """``psi_n = max(sqrt(mean |y_n|^2), eps)`` and the factors that absorb it: ``(psi, T, Z)`` (splitc.py:753-760).

    With ``bin_sum`` the mean is over the bins of the whole group (each of
    its ``shards`` ranks holds as many): the sum over the rank's bins is
    summed over it in one call.
    """
    if bin_sum is None:
        mean = torch.mean(power(Y), dim=(-2, -1))  # ([B,] N)
    else:
        (total,) = bin_sum(power(Y).sum(dim=(-2, -1)))
        mean = total / (Y.shape[-2] * bin_sum.shards * Y.shape[-1])
    psi = torch.clamp(torch.sqrt(mean), min=eps)
    if Z is None:
        return psi, T / (psi[..., None, None] ** p), None
    return (psi, *power_normalize_partitioning(psi, T, Z, p))


def _factors(T, V, Z):
    return (T, V) if Z is None else (T, V, Z)


def ilrma_ip_step(
    X: torch.Tensor,
    W: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z: Optional[torch.Tensor] = None,
    model: str = "gauss",
    spatial: str = "IP1",
    domain: float = 2.0,
    eps: float = 1e-6,
    dof: Optional[float] = None,
    shape: Optional[float] = None,
    me: bool = False,
    pair_selector=None,
    bin_sum=None,
):
    """One ILRMA MM/ME + IP1/IP2 iteration; returns ``(W, T, V)``, or ``(W, T, V, Z)`` with a latent ``Z``.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``.
    Source model, per-bin weights, the weighted covariance (once per
    iteration, all sources) and the IP1 sweep or, with ``spatial="IP2"``,
    the pair updates over ``pair_selector``'s pairs, each reading its two
    rows of the covariances; then power normalization of ``W`` and the
    factors. Counterpart of ``splitc.ilrma_ip_step_sc`` (splitc.py:696-760).
    IP1 without a latent also takes a batch (``X (B, M, I, T)``, ``W (B,
    I, N, M)``, ``T (B, N, I, K)``, ``V (B, N, K, T)``) and ``bin_sum``, as
    the module describes.
    """
    _check_spatial(spatial, ("IP1", "IP2"))
    Y2 = power(separate(X, W))
    T, V, Z, varphi = _source_model(
        Y2, T, V, Z, model=model, p=domain, eps=eps, dof=dof, shape=shape, me=me, bin_sum=bin_sum
    )
    U = covariance(X, varphi)
    if spatial == "IP1":
        W = ip1_update(W, U, eps=eps)
    else:
        W = ip2_update(W, U, eps=eps, pair_selector=pair_selector)
    psi, T, Z = _power_normalize(separate(X, W), T, Z, domain, eps, bin_sum)
    return (W / psi[..., None, :, None], *_factors(T, V, Z))


def ilrma_iss_step(
    Y: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z: Optional[torch.Tensor] = None,
    model: str = "gauss",
    spatial: str = "ISS1",
    domain: float = 2.0,
    eps: float = 1e-6,
    dof: Optional[float] = None,
    shape: Optional[float] = None,
    me: bool = False,
    lqpqm_normalization: bool = True,
    newton_iter: int = 1,
    pair_selector=None,
):
    """One demix-free ILRMA MM/ME iteration on the separated spectrograms; returns ``(Y, T, V[, Z])``.

    Twin of :func:`ilrma_ip_step` without demixing filters: the ISS1 sweep
    with per-bin weights (``spatial="ISS1"``), the ISS2 sweep over
    ``pair_selector``'s pairs (``spatial="ISS2"``) or, on the Gauss model,
    the IPA sweep (``spatial="IPA"``, with its ``lqpqm_normalization`` and
    ``newton_iter``), then power normalization of ``Y`` and the factors.
    Counterpart of ``splitc.ilrma_iss_step_sc`` (splitc.py:763-803) and
    ``splitc.gauss_ilrma_ipa_step_sc`` (splitc.py:2267-2328).
    """
    if spatial == "IPA":
        if model != "gauss":
            raise ValueError("only the Gauss source model has an IPA spatial update.")
    else:
        _check_spatial(spatial, ("ISS1", "ISS2"))
    Y2 = power(Y)
    T, V, Z, varphi = _source_model(Y2, T, V, Z, model=model, p=domain, eps=eps, dof=dof, shape=shape, me=me)
    if spatial == "IPA":
        Y = ipa_sweep(Y, varphi, eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter)
    elif spatial == "ISS2":
        Y = iss2_sweep(Y, varphi, eps=eps, pair_selector=pair_selector)
    else:
        Y = iss1_update(Y, varphi, eps=eps)
    psi, T, Z = _power_normalize(Y, T, Z, domain, eps)
    return (Y / psi[:, None, None], *_factors(T, V, Z))


def gauss_ilrma_ip1_step(X, W, T, V, domain: float = 2.0, eps: float = 1e-6, bin_sum=None):
    """One GaussILRMA MM + IP1 iteration; returns ``(W, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_ip1_step_sc`` (splitc.py:477-520),
    the Gauss MM case of :func:`ilrma_ip_step` (batched and ``bin_sum`` as
    it takes them). ``eps`` is 1e-6 because the step runs in f32
    (splitc.py:491-495).
    """
    return ilrma_ip_step(X, W, T, V, model="gauss", domain=domain, eps=eps, bin_sum=bin_sum)


def gauss_ilrma_ip2_step(X, W, T, V, domain: float = 2.0, eps: float = 1e-6):
    """One GaussILRMA MM + IP2 iteration; returns ``(W, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_ip2_step_sc`` (splitc.py:523-562):
    the covariances of every source once, then the sequential pairs.
    """
    return ilrma_ip_step(X, W, T, V, model="gauss", spatial="IP2", domain=domain, eps=eps)


def gauss_ilrma_iss2_step(Y, T, V, domain: float = 2.0, eps: float = 1e-6):
    """One GaussILRMA MM + ISS2 iteration; returns ``(Y, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_iss2_step_sc`` (splitc.py:565-586).
    """
    return ilrma_iss_step(Y, T, V, model="gauss", spatial="ISS2", domain=domain, eps=eps)


def gauss_ilrma_iss1_step(Y, T, V, domain: float = 2.0, eps: float = 1e-6):
    """One GaussILRMA MM + ISS1 iteration; returns ``(Y, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_iss1_step_sc`` (splitc.py:414-449),
    the Gauss MM case of :func:`ilrma_iss_step`.
    """
    return ilrma_iss_step(Y, T, V, model="gauss", domain=domain, eps=eps)


def gauss_ilrma_ipa_step(
    Y, T, V, Z=None, domain: float = 2.0, eps: float = 1e-6, lqpqm_normalization: bool = True,
    newton_iter: int = 1, me: bool = False,
):
    """One GaussILRMA MM/ME + IPA iteration; returns ``(Y, T, V[, Z])``.

    Counterpart of ``splitc.gauss_ilrma_ipa_step_sc`` (splitc.py:2267-2328),
    the Gauss IPA case of :func:`ilrma_iss_step`.
    """
    return ilrma_iss_step(
        Y, T, V, Z, model="gauss", spatial="IPA", domain=domain, eps=eps, me=me,
        lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter,
    )


def ilrma_loss(
    X: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z=None,
    W: Optional[torch.Tensor] = None,
    Y: Optional[torch.Tensor] = None,
    model: str = "gauss",
    domain: float = 2.0,
    dof: Optional[float] = None,
    shape: Optional[float] = None,
    eps: float = 1e-6,
    bin_sum=None,
) -> torch.Tensor:
    """ILRMA negative log-likelihood, a 0-dim tensor on the input's device.

    ``sum_i [sum_n mean_t value_nit - 2 log|det W_i|]`` with the model
    ``R = max(T V, eps)`` (``sum_k z t v`` with a latent ``Z``) and, per source model,

    - gauss: ``|y|^2 / R^{2/p} + (2/p) log R``
    - t:     ``(1 + nu/2) log(1 + (2/nu) |y|^2 / R^{2/p}) + (2/p) log R``
    - ggd:   ``|y|^beta / R^{beta/p} + (2/p) log R``

    Pass ``W`` for the demix-filter state (IP) or ``Y`` for the demix-free
    state (ISS), whose ``W`` is recovered by least squares. Counterpart of
    ``splitc.ilrma_loss_sc`` (splitc.py:4210-4261). With ``bin_sum`` (the
    inputs one rank's bins) the sum over bins is summed over the bin group:
    every rank gets the loss of all bins.
    """
    p = domain
    if W is not None:
        Y = separate(X, W)
    else:
        W = ls_demix(Y, X)
    Y2 = power(Y)
    R = torch.clamp(reconstruct_nmf(T, V, Z), min=eps)
    log_term = (2 / p) * torch.log(R)
    if model == "gauss":
        value = Y2 / (R ** (2 / p)) + log_term
    elif model == "t":
        value = (1 + dof / 2) * torch.log1p((2 / dof) * Y2 / (R ** (2 / p))) + log_term
    elif model == "ggd":
        value = Y2 ** (shape / 2) / (R ** (shape / p)) + log_term
    else:
        raise ValueError(f"unsupported option: {model}.")
    per_bin = torch.sum(torch.mean(value, dim=-1), dim=0)  # (I,)
    total = torch.sum(per_bin - 2 * clogabsdet(W))
    return total if bin_sum is None else bin_sum(total)[0]
