"""Independent low-rank matrix analysis (ILRMA): Gauss, Student's-t and GGD source models.

Counterpart of :mod:`ssspy_tpu.bss.ilrma` (parity target
ssspy/bss/ilrma.py) for ``ILRMABase``, ``GaussILRMA``, ``TILRMA`` and ``GGDILRMA`` with the NMF
source model (MM or ME updates, optionally the shared-basis
``partitioning``), spatial ``"IP"``/``"IP1"``/``"IP2"`` (demixing filters),
``"ISS"``/``"ISS1"``/``"ISS2"`` or, for ``GaussILRMA``, ``"IPA"``
(demix-free), and power or projection-back normalization. One iteration is
``source model -> spatial model -> normalization``; the spatial update
goes through the routers of :mod:`ssspy_tpu_torch.ops.iva_steps` to the
kernels (the weighted covariance with per-bin weights, then the IP1 sweep
or the IP2 pair updates over ``pair_selector``'s pairs; the ISS1 sweep;
the ISS2 sweep; or the IPA sweep of :mod:`ssspy_tpu_torch.ops.ipa_steps`).
"""

from typing import Callable, List, Optional, Union

import numpy as np
import torch

from ..ops.ilrma_steps import (
    ilrma_mm_core,
    ilrma_mm_core_partitioning,
    ilrma_model_varphi,
    power,
    power_normalize_partitioning,
    reconstruct_nmf,
)
from ..ops.ipa_steps import ipa_sweep
from ..ops.iva_steps import clogabsdet, covariance, ip1_update, ip2_update, iss1_update, iss2_sweep, ls_demix
from ..ops.iva_steps import separate as _separate
from ..special.flooring import identity, step_flooring
from ..utils.device import DEFAULT_DEVICE
# re-exported, as the reference does
from ._update_spatial_model import (  # noqa: F401
    update_by_ip1,
    update_by_ip2,
    update_by_ipa,
    update_by_iss1,
    update_by_iss2,
)
from .base import SeparatorBase, check_spatial_algorithm, config_repr, default_pair_selector, ipa_keywords

__all__ = ["ILRMABase", "GaussILRMA", "TILRMA", "GGDILRMA"]

source_algorithms = ["MM", "ME"]


class ILRMABase(SeparatorBase):
    """Base class of ILRMA (parity: ssspy/bss/ilrma.py:32-580).

    ``rng``: the ``np.random.Generator`` the NMF factors are drawn from, on
    the host and in the JAX class's order (basis, then activation), then
    moved to ``device``; a seeded run starts from the same factors in both
    packages. Warm start through ``demix_filter=``, ``basis=`` and
    ``activation=`` (and ``output=`` with ``demix_filter=None``). With
    ``partitioning`` the sources share one basis ``(I, K)`` and one
    activation ``(K, T)`` through the latent ``(N, K)`` (drawn first,
    normalized over sources; warm start ``latent=``), and only power
    normalization applies.
    """

    _model = None  # "gauss", "t" or "ggd"

    def __init__(
        self,
        n_basis: int,
        spatial_algorithm: str = "IP",
        source_algorithm: str = "MM",
        domain: float = 2,
        partitioning: bool = False,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[Callable] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        normalization: Optional[Union[bool, str]] = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        rng: Optional[np.random.Generator] = None,
        device=DEFAULT_DEVICE,
        **kwargs,
    ) -> None:
        check_spatial_algorithm(spatial_algorithm)
        if spatial_algorithm == "IPA" and self._model != "gauss":
            raise ValueError(f"{type(self).__name__} has no IPA spatial update; choose IP/ISS variants.")
        ipa = ipa_keywords(spatial_algorithm, kwargs)
        if source_algorithm not in source_algorithms:
            raise ValueError(f"unsupported option: {source_algorithm}.")
        if not 0 < domain <= 2:
            raise ValueError("domain must lie in (0, 2].")
        if source_algorithm == "ME" and domain != 2:
            raise ValueError("the ME source update requires domain=2.")
        if normalization not in (True, False, None, "power", "projection_back"):
            raise ValueError(f"Normalization {normalization} is not implemented.")
        if partitioning and normalization == "projection_back":
            raise ValueError("projection-back normalization is incompatible with partitioning.")
        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )

        self.n_basis = n_basis
        self.spatial_algorithm = spatial_algorithm
        self.pair_selector = default_pair_selector(spatial_algorithm, pair_selector)
        self.source_algorithm = source_algorithm
        self.domain = domain
        self.partitioning = partitioning
        self.normalization = normalization
        self.rng = np.random.default_rng() if rng is None else rng
        for key, value in ipa.items():
            setattr(self, key, value)

    def __repr__(self) -> str:
        keys = ["n_basis", "spatial_algorithm", "source_algorithm", "domain", "partitioning"]
        keys += ["normalization", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, type(self).__name__, keys)

    def _model_params(self) -> dict:
        """``nu``/``beta``/``me`` of the source model, as ``ilrma_mm_core`` takes them."""
        return {"me": self.source_algorithm == "ME"}

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames
        self._reset_demix_filter(kwargs)
        self._init_nmf()
        if not self._uses_demix_filter:
            self.demix_filter = None

    def _init_nmf(self) -> None:
        """Random NMF factors (host draws, JAX's order; ssspy_tpu/bss/ilrma.py:153-191).

        Drawn only where no ``basis``/``activation`` (``latent``) is set yet,
        in the real dtype of the input, on its device, then floored. With
        ``partitioning`` the latent comes first, divided by its sum over
        sources before the floor.
        """
        X = self.input
        real = X.real.dtype
        if self.partitioning:
            shapes = {
                "latent": (self.n_sources, self.n_basis),
                "basis": (self.n_bins, self.n_basis),
                "activation": (self.n_basis, self.n_frames),
            }
        else:
            shapes = {
                "basis": (self.n_sources, self.n_bins, self.n_basis),
                "activation": (self.n_sources, self.n_basis, self.n_frames),
            }
        for name, shape in shapes.items():
            if hasattr(self, name):
                value = getattr(self, name).to(dtype=real).contiguous().clone()
            else:
                draw = self.rng.random(shape)
                if name == "latent":
                    draw = draw / draw.sum(axis=0)
                value = self.flooring_fn(torch.as_tensor(draw, dtype=real, device=X.device))
            setattr(self, name, value)

    def separate(self, input, demix_filter):
        if demix_filter is None:
            return None
        return _separate(input, demix_filter)

    def reconstruct_nmf(self, basis, activation, latent=None):
        return reconstruct_nmf(basis, activation, latent)

    # ---- state plumbing ----------------------------------------------------

    warm_start_keys = {**SeparatorBase.warm_start_keys, "T": "basis", "V": "activation", "Z": "latent"}

    def init_state(self):
        state = {"X": self.input, "T": self.basis, "V": self.activation}
        if self.partitioning:
            state["Z"] = self.latent
        if self._uses_demix_filter:
            state["W"] = self.demix_filter
        else:
            state["Y"] = self.output
        return state

    def commit_state(self, state) -> None:
        self._state = state
        self.basis, self.activation = state["T"], state["V"]
        if self.partitioning:
            self.latent = state["Z"]
        if self._uses_demix_filter:
            self.demix_filter = state["W"]
            self.output = _separate(state["X"], state["W"])
        else:
            self.output = state["Y"]

    @staticmethod
    def _current_Y(state) -> torch.Tensor:
        return _separate(state["X"], state["W"]) if "W" in state else state["Y"]

    # ---- one iteration -------------------------------------------------------

    def make_step(self):
        model, p, flooring_fn = self._model, self.domain, self.flooring_fn
        params = self._model_params()
        # a max-type flooring_fn is an eps for the kernels; any other reaches the spatial updates that the
        # JAX class floors with it (update_by_*: ssspy_tpu/bss/ilrma.py:706-728)
        eps, floor = step_flooring(flooring_fn, self.input.dtype)
        algorithm, pair_selector = self.spatial_algorithm, self.pair_selector
        ipa = {key: getattr(self, key) for key in ("lqpqm_normalization", "newton_iter")} if algorithm == "IPA" else {}
        normalize = self._normalizer()

        def step(state):
            Y2 = power(self._current_Y(state))
            # the class floors the factors with flooring_fn and not the model
            # (ssspy_tpu/bss/ilrma.py:650-696)
            kw = dict(model=model, p=p, floor=flooring_fn, floor_model=identity, **params)
            if "Z" in state:
                T, V, Z, R = ilrma_mm_core_partitioning(Y2, state["T"], state["V"], state["Z"], **kw)
                state = {**state, "T": T, "V": V, "Z": Z}
            else:
                T, V, R = ilrma_mm_core(Y2, state["T"], state["V"], **kw)
                state = {**state, "T": T, "V": V}
            varphi = ilrma_model_varphi(
                model, Y2, R, p, params.get("nu"), params.get("beta"), flooring_fn
            )
            if algorithm == "IP2":
                state["W"] = ip2_update(
                    state["W"], covariance(state["X"], varphi), eps=eps, pair_selector=pair_selector, flooring_fn=floor
                )
            elif "W" in state:
                state["W"] = ip1_update(state["W"], covariance(state["X"], varphi), eps=eps, flooring_fn=floor)
            elif algorithm == "IPA":
                state["Y"] = ipa_sweep(state["Y"], varphi, eps=eps, flooring_fn=floor, **ipa)
            elif algorithm == "ISS2":
                state["Y"] = iss2_sweep(state["Y"], varphi, eps=eps, pair_selector=pair_selector, flooring_fn=floor)
            else:
                state["Y"] = iss1_update(state["Y"], varphi, eps=eps, flooring_fn=floor)
            return normalize(state)

        return step

    # ---- normalization (in-loop; parity: ssspy/bss/ilrma.py:333-514) -------

    def _normalizer(self) -> Callable:
        normalization = self.normalization
        if not normalization:
            return lambda state: state
        if normalization is True or normalization == "power":
            return self._normalize_by_power
        return self._normalize_by_projection_back

    def _normalize_by_power(self, state):
        p = self.domain
        psi = self.flooring_fn(torch.sqrt(torch.mean(power(self._current_Y(state)), dim=(-2, -1))))
        if "Z" in state:
            T, Z = power_normalize_partitioning(psi, state["T"], state["Z"], p)
            state = {**state, "T": T, "Z": Z}
        else:
            state = {**state, "T": state["T"] / (psi[:, None, None] ** p)}
        if "W" in state:
            return {**state, "W": state["W"] / psi[None, :, None]}
        return {**state, "Y": state["Y"] / psi[:, None, None]}

    def _normalize_by_projection_back(self, state):
        ref = self.reference_id
        if "W" in state:
            W = state["W"]
            scale = torch.linalg.inv_ex(W)[0][:, ref, :]  # (I, N)
            state = {**state, "W": W * scale[:, :, None]}
        else:
            X, Y = state["X"], state["Y"]
            Yb, Xb = Y.transpose(0, 1), X.transpose(0, 1)  # (I, N, T), (I, M, T)
            YH = Yb.transpose(-2, -1).conj()
            scale = ((Xb @ YH) @ torch.linalg.inv_ex(Yb @ YH)[0])[:, ref, :]  # (I, N)
            state = {**state, "Y": Y * scale.transpose(0, 1)[:, :, None]}
        T = state["T"] * (scale.transpose(0, 1).abs() ** self.domain)[:, :, None]
        return {**state, "T": T}

    # ---- loss ----------------------------------------------------------------

    def _loss_value(self, Y2, R) -> torch.Tensor:
        """The per-(source, bin, frame) integrand of the negative log-likelihood."""
        raise NotImplementedError

    def make_loss(self):
        value_of = self._loss_value

        def loss(state):
            if "W" in state:
                Y, W = _separate(state["X"], state["W"]), state["W"]
            else:
                Y, W = state["Y"], ls_demix(state["Y"], state["X"])
            value = value_of(power(Y), reconstruct_nmf(state["T"], state["V"], state.get("Z")))
            return torch.sum(torch.sum(torch.mean(value, dim=-1), dim=0) - 2 * clogabsdet(W))

        return loss


class GaussILRMA(ILRMABase):
    """ILRMA on a Gaussian source model (parity: ssspy/bss/ilrma.py:582-1989).

    ``source_algorithm``: MM or ME (ME requires ``domain == 2``);
    ``domain`` p in (0, 2]; ``partitioning`` enables the shared-basis latent
    model; ``normalization``: power | projection_back. With
    ``spatial_algorithm="IPA"`` it takes the keywords ``lqpqm_normalization``
    (default True) and ``newton_iter`` (default 1).
    """

    _model = "gauss"

    def _loss_value(self, Y2, R):
        p = self.domain
        return Y2 / (R ** (2 / p)) + (2 / p) * torch.log(R)


class TILRMA(ILRMABase):
    """ILRMA on a Student's-t source model (parity: ssspy/bss/ilrma.py:1992-3334).

    ``dof`` is the t-distribution's degrees of freedom. It has no IPA
    spatial update (``ValueError``).
    """

    _model = "t"

    def __init__(self, n_basis: int, dof: float, spatial_algorithm: str = "IP", **kwargs) -> None:
        super().__init__(n_basis, spatial_algorithm=spatial_algorithm, **kwargs)
        self.dof = dof

    def _model_params(self) -> dict:
        return {"nu": self.dof, "me": self.source_algorithm == "ME"}

    def _loss_value(self, Y2, R):
        p, nu = self.domain, self.dof
        return (1 + nu / 2) * torch.log(1 + (2 / nu) * Y2 / (R ** (2 / p))) + (2 / p) * torch.log(R)


class GGDILRMA(ILRMABase):
    """ILRMA on a generalized-Gaussian source model (parity: ssspy/bss/ilrma.py:3337-4410).

    ``beta`` in (0, 2) is the GGD shape parameter; MM updates only, and no
    IPA spatial update (``ValueError``).
    """

    _model = "ggd"

    def __init__(self, n_basis: int, beta: float, spatial_algorithm: str = "IP", **kwargs) -> None:
        if not 0 < beta < 2:
            raise ValueError(f"Shape parameter {beta} should be chosen from (0, 2).")
        if kwargs.get("source_algorithm", "MM") != "MM":
            raise ValueError(f"unsupported option: {kwargs['source_algorithm']}.")
        super().__init__(n_basis, spatial_algorithm=spatial_algorithm, **kwargs)
        self.beta = beta

    def _model_params(self) -> dict:
        return {"beta": self.beta}

    def _loss_value(self, Y2, R):
        p, beta = self.domain, self.beta
        return Y2 ** (beta / 2) / (R ** (beta / p)) + (2 / p) * torch.log(R)

