"""The ILRMA iterations (Gauss, t and GGD source models; IP1 and ISS1) and their loss.

Counterparts of the generic ILRMA engine in ``ssspy_tpu/ops/splitc.py``
(splitc.py:414-449, :477-520, :589-628, :673-693, :712-803, :4210-4261)
on native complex tensors. The NMF products ``T @ V`` and the
multiplicative-update contractions are plain matrix products, as in the
JAX package, where they stay outside any Pallas kernel. The spatial update
goes through the kernels of :mod:`ssspy_tpu_torch.ops.kernels`: the
weighted covariance with per-bin weights ``(N, I, T)`` and the IP1 sweep,
or the ISS1 sweep.

``model`` is ``"gauss"``, ``"t"`` (``dof`` = nu) or ``"ggd"`` (``shape`` =
beta); ``p`` is the domain parameter; ``me=True`` selects the ME source
update (Gauss and t, ``p == 2``). The shared-basis partitioning (``Z``),
IP2, ISS2 and IPA are not ported yet (ROADMAP.md, Queue 1, items 3 and 5).
"""

from typing import Callable, Optional, Tuple

import torch

from . import kernels
from .iva_steps import clogabsdet, ls_demix, separate

__all__ = [
    "power",
    "ilrma_model_weights",
    "ilrma_model_varphi",
    "ilrma_mm_core",
    "ilrma_ip_step",
    "ilrma_iss_step",
    "gauss_ilrma_ip1_step",
    "gauss_ilrma_iss1_step",
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Basis, then activation multiplicative update; returns ``(T, V, R)``.

    ``Y2``: source powers ``(N, I, T)``; ``T``: basis ``(N, I, K)``;
    ``V``: activation ``(N, K, T)``. ``floor`` floors the new factors and
    ``floor_model`` the model ``R = T @ V``: ``max(., eps)`` both on the
    fast path (splitc.py:673-693); the class's ``flooring_fn`` and no floor
    on the class path (ssspy_tpu/bss/ilrma.py:662-696).
    """
    R = floor_model(T @ V)
    w, ex, fac = ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * torch.einsum("nkt,nit->nik", V, w)
    denom = torch.einsum("nkt,nit->nik", V, 1 / R)
    T = floor(((num / denom) ** ex) * T)

    R = floor_model(T @ V)
    w, ex, fac = ilrma_model_weights(model, Y2, R, p, nu, beta, me)
    num = fac * torch.einsum("nik,nit->nkt", T, w)
    denom = torch.einsum("nik,nit->nkt", T, 1 / R)
    V = floor(((num / denom) ** ex) * V)

    return T, V, floor_model(T @ V)


def _check_ported(Z, spatial: Optional[str], ported: Optional[str]) -> None:
    """Raise for the options of the JAX engine that the port does not run yet."""
    if Z is not None:
        raise NotImplementedError(
            "the shared-basis partitioning (Z) is not ported to ssspy_tpu_torch yet "
            "(ROADMAP.md, Queue 1, item 3)."
        )
    if spatial != ported:
        raise NotImplementedError(
            f"spatial={spatial!r} is not ported to ssspy_tpu_torch yet "
            f"(ROADMAP.md, Queue 1, items 3 and 5); use {ported!r}."
        )


def _power_normalize(Y: torch.Tensor, T: torch.Tensor, p: float, eps: float):
    """``psi_n = max(sqrt(mean |y_n|^2), eps)`` and ``T / psi^p`` (splitc.py:753-758)."""
    psi = torch.clamp(torch.sqrt(torch.mean(power(Y), dim=(-2, -1))), min=eps)  # (N,)
    return psi, T / (psi[:, None, None] ** p)


def ilrma_ip_step(
    X: torch.Tensor,
    W: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z=None,
    model: str = "gauss",
    spatial: str = "IP1",
    domain: float = 2.0,
    eps: float = 1e-6,
    dof: Optional[float] = None,
    shape: Optional[float] = None,
    me: bool = False,
):
    """One ILRMA MM/ME + IP1 iteration; returns ``(W, T, V)``.

    ``X``: mixture ``(M, I, T)``; ``W``: demixing filters ``(I, N, M)``.
    Source model, per-bin weights, the weighted covariance and the IP1
    sweep, then power normalization of ``W`` and ``T``. Counterpart of
    ``splitc.ilrma_ip_step_sc`` with ``spatial="IP1"`` and no ``Z``
    (splitc.py:712-760); ``Z`` and ``spatial="IP2"`` raise.
    """
    _check_ported(Z, spatial, "IP1")
    p, floor = domain, _max_floor(eps)
    Y2 = power(separate(X, W))
    T, V, R = ilrma_mm_core(
        Y2, T, V, model=model, p=p, floor=floor, floor_model=floor, nu=dof, beta=shape, me=me
    )
    varphi = ilrma_model_varphi(model, Y2, R, p, dof, shape, floor)
    W = kernels.ip1_sweep(W, kernels.weighted_covariance(X, varphi), eps=eps)
    psi, T = _power_normalize(separate(X, W), T, p, eps)
    return W / psi[None, :, None], T, V


def ilrma_iss_step(
    Y: torch.Tensor,
    T: torch.Tensor,
    V: torch.Tensor,
    Z=None,
    model: str = "gauss",
    spatial: str = "ISS1",
    domain: float = 2.0,
    eps: float = 1e-6,
    dof: Optional[float] = None,
    shape: Optional[float] = None,
    me: bool = False,
):
    """One ILRMA MM/ME + ISS1 iteration on the separated spectrograms; returns ``(Y, T, V)``.

    Demix-free twin of :func:`ilrma_ip_step`: the ISS1 sweep with per-bin
    weights, then power normalization of ``Y`` and ``T``. Counterpart of
    ``splitc.ilrma_iss_step_sc`` with ``spatial="ISS1"`` and no ``Z``
    (splitc.py:763-803); ``Z`` and ``spatial="ISS2"`` raise.
    """
    _check_ported(Z, spatial, "ISS1")
    p, floor = domain, _max_floor(eps)
    Y2 = power(Y)
    T, V, R = ilrma_mm_core(
        Y2, T, V, model=model, p=p, floor=floor, floor_model=floor, nu=dof, beta=shape, me=me
    )
    varphi = ilrma_model_varphi(model, Y2, R, p, dof, shape, floor)
    Y = kernels.iss1_sweep(Y, varphi, eps=eps)
    psi, T = _power_normalize(Y, T, p, eps)
    return Y / psi[:, None, None], T, V


def gauss_ilrma_ip1_step(X, W, T, V, domain: float = 2.0, eps: float = 1e-6):
    """One GaussILRMA MM + IP1 iteration; returns ``(W, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_ip1_step_sc`` (splitc.py:477-520),
    the Gauss MM case of :func:`ilrma_ip_step`. ``eps`` is 1e-6 because the
    step runs in f32 (splitc.py:491-495).
    """
    return ilrma_ip_step(X, W, T, V, model="gauss", domain=domain, eps=eps)


def gauss_ilrma_iss1_step(Y, T, V, domain: float = 2.0, eps: float = 1e-6):
    """One GaussILRMA MM + ISS1 iteration; returns ``(Y, T, V)``.

    Counterpart of ``splitc.gauss_ilrma_iss1_step_sc`` (splitc.py:414-449),
    the Gauss MM case of :func:`ilrma_iss_step`.
    """
    return ilrma_iss_step(Y, T, V, model="gauss", domain=domain, eps=eps)


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
) -> torch.Tensor:
    """ILRMA negative log-likelihood, a 0-dim tensor on the input's device.

    ``sum_i [sum_n mean_t value_nit - 2 log|det W_i|]`` with the model
    ``R = max(T V, eps)`` and, per source model,

    - gauss: ``|y|^2 / R^{2/p} + (2/p) log R``
    - t:     ``(1 + nu/2) log(1 + (2/nu) |y|^2 / R^{2/p}) + (2/p) log R``
    - ggd:   ``|y|^beta / R^{beta/p} + (2/p) log R``

    Pass ``W`` for the demix-filter state (IP) or ``Y`` for the demix-free
    state (ISS), whose ``W`` is recovered by least squares. Counterpart of
    ``splitc.ilrma_loss_sc`` (splitc.py:4210-4261); ``Z`` raises.
    """
    _check_ported(Z, None, None)
    p = domain
    if W is not None:
        Y = separate(X, W)
    else:
        W = ls_demix(Y, X)
    Y2 = power(Y)
    R = torch.clamp(T @ V, min=eps)
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
    return torch.sum(per_bin - 2 * clogabsdet(W))
