"""Independent vector analysis (IVA): the auxiliary-function IP/IP1, ISS/ISS1 and IPA family.

Counterpart of :mod:`ssspy_tpu.bss.iva` (parity target ssspy/bss/iva.py)
for the classes ported so far: ``IVABase``, ``AuxIVABase``, ``AuxIVA``
with ``spatial_algorithm="IP"``/``"IP1"`` (demixing filters),
``"ISS"``/``"ISS1"`` and ``"IPA"`` (demix-free: the state is the separated
spectrogram), ``AuxLaplaceIVA``, and the proximal-splitting factories
``PDSIVA`` and ``ADMMIVA``. The separator runs on its ``device`` (the card
by default); its step goes through the same routers as the ``fast_*``
entry points of :mod:`ssspy_tpu_torch.fast` (``ops.iva_steps.covariance``,
``ip1_update`` and ``iss1_update``), which send complex64 to the kernels
and complex128 to their plain versions.
"""

from typing import Callable, List, Optional, Union

import torch

from ..ops.ipa_steps import ipa_sweep
from ..ops.iva_steps import covariance, ip1_update, iss1_update, ls_demix
from ..ops.iva_steps import separate as _separate
from ..special.flooring import sweep_eps
from ..utils.device import DEFAULT_DEVICE
from .admmbss import ADMMBSS
from .base import SeparatorBase, check_spatial_algorithm, config_repr, ipa_keywords
from .pdsbss import PDSBSS
from .proxbss import iva_prox_defaults

__all__ = ["IVABase", "AuxIVABase", "AuxIVA", "AuxLaplaceIVA", "PDSIVA", "ADMMIVA"]


def _laplace_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _laplace_d_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.ones_like(y)


class IVABase(SeparatorBase):
    """Base class of IVA (parity: ssspy/bss/iva.py:47-282)."""

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IVA", keys)

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames
        self._reset_demix_filter(kwargs)

    def separate(self, input, demix_filter):
        """Apply demixing filters: ``(M,I,T) -> (N,I,T)``."""
        return _separate(input, demix_filter)

    def compute_logdet(self, demix_filter):
        return torch.linalg.slogdet(demix_filter)[1]

    # ---- default W-state plumbing -----------------------------------------

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = _separate(state["X"], state["W"])

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            X, W = state["X"], state["W"]
            G = contrast_fn(_separate(X, W))  # (n_sources, n_frames)
            logdet = torch.linalg.slogdet(W)[1]
            return torch.sum(torch.mean(G, dim=1)) - 2 * torch.sum(logdet)

        return loss


class AuxIVABase(IVABase):
    """Base of auxiliary-function IVA (parity: ssspy/bss/iva.py:563-641)."""

    def __init__(
        self,
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)


class AuxIVA(AuxIVABase):
    """Auxiliary-function IVA (parity: ssspy/bss/iva.py:1403-2260).

    ``spatial_algorithm="IP"``/``"IP1"``: each step computes the MM weight
    ``phi = G'(r) / flooring(2 r)``, the weighted covariance and the IP1
    sweep. ``"ISS"``/``"ISS1"``: the state is the separated spectrogram
    ``Y``; each step computes the same weight from ``Y`` and runs the ISS1
    sweep, the loss recovers ``W`` by least squares, and projection back
    rescales ``Y`` against the mixture. ``"IPA"``: demix-free as well, the
    sweep of :func:`ssspy_tpu_torch.ops.ipa_steps.ipa_sweep`, with the
    keywords ``lqpqm_normalization`` (default True) and ``newton_iter``
    (default 1), which no other spatial algorithm takes. All through the
    routers of :mod:`ssspy_tpu_torch.ops.iva_steps` and
    :mod:`ssspy_tpu_torch.ops.ipa_steps`. IP2 and ISS2 are
    not ported yet (ROADMAP.md, Queue 1, item 5).
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
        **kwargs,
    ) -> None:
        check_spatial_algorithm(spatial_algorithm)
        ipa = ipa_keywords(spatial_algorithm, kwargs)
        super().__init__(
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.spatial_algorithm = spatial_algorithm
        for key, value in ipa.items():
            setattr(self, key, value)

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        if not self._uses_demix_filter:
            self.demix_filter = None

    def init_state(self):
        if self._uses_demix_filter:
            return super().init_state()
        return {"X": self.input, "Y": self.output}

    def commit_state(self, state) -> None:
        if self._uses_demix_filter:
            super().commit_state(state)
        else:
            self._state = state
            self.output = state["Y"]

    def _varphi(self, Y: torch.Tensor) -> torch.Tensor:
        """MM weight ``G'(r) / flooring(2r)`` per (source, frame)."""
        norm = torch.linalg.vector_norm(Y, dim=1)
        return self.d_contrast_fn(norm) / self.flooring_fn(2 * norm)  # (N, T)

    def make_step(self):
        varphi_of = self._varphi
        eps = sweep_eps(self.flooring_fn, self.input.dtype)

        if self._uses_demix_filter:

            def step(state):
                X, W = state["X"], state["W"]
                U = covariance(X, varphi_of(_separate(X, W)))
                return {**state, "W": ip1_update(W, U, eps=eps)}

        elif self.spatial_algorithm == "IPA":
            lqpqm_normalization, newton_iter = self.lqpqm_normalization, self.newton_iter

            def step(state):
                Y = state["Y"]
                Y = ipa_sweep(
                    Y, varphi_of(Y), eps=eps, lqpqm_normalization=lqpqm_normalization, newton_iter=newton_iter
                )
                return {**state, "Y": Y}

        else:

            def step(state):
                Y = state["Y"]
                return {**state, "Y": iss1_update(Y, varphi_of(Y), eps=eps)}

        return step

    def make_loss(self):
        if self._uses_demix_filter:
            return super().make_loss()
        contrast_fn = self.contrast_fn

        def loss(state):
            X, Y = state["X"], state["Y"]
            G = contrast_fn(Y)
            logdet = torch.linalg.slogdet(ls_demix(Y, X))[1]
            return torch.sum(torch.mean(G, dim=1)) - 2 * torch.sum(logdet)

        return loss


class AuxLaplaceIVA(AuxIVA):
    """AuxIVA with Laplace prior (parity: ssspy/bss/iva.py:2976-3130)."""

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
        **kwargs,
    ) -> None:
        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=_laplace_contrast,
            d_contrast_fn=_laplace_d_contrast,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
            **kwargs,
        )


class PDSIVA:
    """IVA by primal-dual splitting (parity: ssspy/bss/iva.py:2217-2277).

    A :class:`~ssspy_tpu_torch.bss.pdsbss.PDSBSS` with the L21 contrast
    (the norm over bins) and its group shrinkage as defaults, which run
    :func:`ssspy_tpu_torch.ops.prox_steps.pds_iva_step`. A factory, as in
    the JAX package (ssspy_tpu/bss/iva.py:1123-1160).
    """

    def __new__(
        cls,
        mu1: float = 1,
        mu2: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        contrast_fn: Callable = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ):
        contrast_fn, prox_penalty, penalty_fn = iva_prox_defaults(contrast_fn, prox_penalty)
        method = PDSBSS(
            mu1=mu1,
            mu2=mu2,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        method.contrast_fn = contrast_fn
        return method


class ADMMIVA:
    """IVA by ADMM (parity: ssspy/bss/iva.py:2280-2338).

    An :class:`~ssspy_tpu_torch.bss.admmbss.ADMMBSS` with the defaults of
    :class:`PDSIVA`, which run
    :func:`ssspy_tpu_torch.ops.prox_steps.admm_iva_step`.
    """

    def __new__(
        cls,
        rho: float = 1,
        alpha: float = None,
        relaxation: float = 1,
        contrast_fn: Callable = None,
        prox_penalty: Callable = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ):
        contrast_fn, prox_penalty, penalty_fn = iva_prox_defaults(contrast_fn, prox_penalty)
        method = ADMMBSS(
            rho=rho,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        method.contrast_fn = contrast_fn
        return method
