"""Independent vector analysis (IVA): the gradient, fixed-point and auxiliary-function families.

Counterpart of :mod:`ssspy_tpu.bss.iva` (parity target ssspy/bss/iva.py):
``IVABase``; the gradient classes ``GradIVABase``, ``GradIVA``,
``NaturalGradIVA``, ``GradLaplaceIVA``, ``GradGaussIVA``,
``NaturalGradLaplaceIVA`` and ``NaturalGradGaussIVA``; the fixed-point
classes ``FastIVABase``, ``FastIVA`` and ``FasterIVA`` on the whitened
input; ``AuxIVABase``, ``AuxIVA`` with ``spatial_algorithm="IP"``/``"IP1"``/``"IP2"``
(demixing filters), ``"ISS"``/``"ISS1"``/``"ISS2"`` and ``"IPA"``
(demix-free: the state is the separated spectrogram), ``AuxLaplaceIVA``,
``AuxGaussIVA``; and the proximal-splitting factories ``PDSIVA`` and
``ADMMIVA``. The separator runs on its ``device`` (the card by default);
its step goes through the same routers as the ``fast_*`` entry points of
:mod:`ssspy_tpu_torch.fast` (``ops.iva_steps.covariance``, ``ip1_update``
and ``iss1_update``, and ``ops.prox_steps.herm_eigh_embed`` for the
fixed-point classes' eighs), which send complex64 to the kernels and
complex128 to their plain versions.
"""

from typing import Callable, List, Optional, Tuple, Union

import torch

from ..algorithm import minimal_distortion_principle, projection_back
from ..ops.fixed_point_iva_steps import fast_iva_update, faster_iva_update, whiten_spectrogram
from ..ops.ipa_steps import ipa_sweep
from ..ops.iva_steps import (
    PairSelector,
    auxiva_ip2_step,
    covariance,
    grad_iva_step,
    ip1_update,
    iss1_update,
    iss2_sweep,
    ls_demix,
)
from ..ops.iva_steps import separate as _separate
from ..special.flooring import step_flooring
from ..utils.device import DEFAULT_DEVICE
from .admmbss import ADMMBSS
# re-exported, as the reference does
from ._update_spatial_model import (  # noqa: F401
    update_by_ip1,
    update_by_ip2_one_pair,
    update_by_ipa,
    update_by_iss1,
    update_by_iss2,
)
from .base import SeparatorBase, check_spatial_algorithm, config_repr, default_pair_selector, ipa_keywords
from .pdsbss import PDSBSS
from .proxbss import iva_prox_defaults

__all__ = [
    "IVABase",
    "GradIVABase",
    "FastIVABase",
    "AuxIVABase",
    "GradIVA",
    "NaturalGradIVA",
    "FastIVA",
    "FasterIVA",
    "AuxIVA",
    "PDSIVA",
    "ADMMIVA",
    "GradLaplaceIVA",
    "GradGaussIVA",
    "NaturalGradLaplaceIVA",
    "NaturalGradGaussIVA",
    "AuxLaplaceIVA",
    "AuxGaussIVA",
]


def _laplace_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _laplace_d_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.ones_like(y)


def _gauss_contrast(Y: torch.Tensor, variance: torch.Tensor) -> torch.Tensor:
    """``I log(alpha) + ||y||^2 / alpha`` per (source, frame) (ssspy_tpu/bss/iva.py:1269-1273)."""
    return Y.shape[1] * torch.log(variance) + torch.linalg.vector_norm(Y, dim=1) ** 2 / variance


def _source_variance(Y: torch.Tensor) -> torch.Tensor:
    """The Gaussian source model ``alpha = mean_i |y|^2``: ``(N, T)``."""
    return torch.mean(Y.real.square() + Y.imag.square(), dim=1)


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


class GradIVABase(IVABase):
    """Base class of gradient-descent IVA (parity: ssspy/bss/iva.py:285-410).

    ``score_fn(Y)`` gives the score ``Phi (N, I, T)``; each step moves
    ``W`` by ``step_size`` along ``(PhiY - I) W`` (natural) or
    ``(PhiY - I) W^-H`` (vanilla, ``W^-H`` by ``solve_ex``), the diagonal
    of ``PhiY - I`` dropped unless ``is_holonomic``
    (:func:`ssspy_tpu_torch.ops.iva_steps.grad_iva_step`). No kernel: the
    step is a few batched products, as in the JAX package.
    """

    _natural = False  # NaturalGradIVA: True

    def __init__(
        self,
        step_size: float = 1e-1,
        contrast_fn: Callable = None,
        score_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = False,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if score_fn is None:
            raise ValueError("a score_fn must be provided.")
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.step_size = step_size
        self.contrast_fn = contrast_fn
        self.score_fn = score_fn
        self.is_holonomic = is_holonomic

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "GradIVA", keys)

    def make_step(self):
        score_fn, step_size, is_holonomic, natural = self.score_fn, self.step_size, self.is_holonomic, self._natural

        def step(state):
            W = state["W"]
            Y = _separate(state["X"], W)
            return {**state, "W": grad_iva_step(W, Y, score_fn(Y), step_size, is_holonomic, natural)}

        return step


class GradIVA(GradIVABase):
    """IVA by (vanilla) gradient descent (parity: ssspy/bss/iva.py:644-775); ``is_holonomic`` defaults to True."""

    def __init__(self, *args, is_holonomic: bool = True, **kwargs) -> None:
        super().__init__(*args, is_holonomic=is_holonomic, **kwargs)


class NaturalGradIVA(GradIVABase):
    """IVA by natural gradient descent (parity: ssspy/bss/iva.py:778-908); ``is_holonomic`` defaults to True."""

    _natural = True

    def __init__(self, *args, is_holonomic: bool = True, **kwargs) -> None:
        super().__init__(*args, is_holonomic=is_holonomic, **kwargs)

    def __repr__(self) -> str:
        return "Natural" + super().__repr__()


class FastIVABase(IVABase):
    """Base class of the fixed-point IVA methods on the whitened input (parity: ssspy/bss/iva.py:411-560).

    The input is whitened on the device by
    :func:`ssspy_tpu_torch.ops.fixed_point_iva_steps.whiten_spectrogram`
    (one embedded eigh, K7 in complex64), as ``fast_fast_iva`` and
    ``fast_faster_iva`` whiten it, so that a class with the fast path's
    floor (``flooring_fn="f64"``) runs its trajectory. The loss is the
    contrast alone: the rows stay unitary. Scale restoration rescales the
    output against the unwhitened input and refits the demixing filters on
    the whitened one (ssspy_tpu/bss/iva.py:543-549, :656-680).
    """

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
        return config_repr(self, "FastIVA", keys)

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)
        if self.scale_restoration:
            self.restore_scale()
        else:
            self.output = _separate(self.whitened_input, self.demix_filter)
        return self.output

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.whitened_input = whiten_spectrogram(self.input)
        self.output = _separate(self.whitened_input, self.demix_filter)

    def separate(self, input, demix_filter, use_whitening: bool = True):
        z = whiten_spectrogram(torch.as_tensor(input, device=self.device)) if use_whitening else input
        return _separate(z, demix_filter)

    def init_state(self):
        return {"Xw": self.whitened_input, "W": self.demix_filter}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.output = _separate(state["Xw"], state["W"])

    def make_loss(self):
        contrast_fn = self.contrast_fn

        def loss(state):
            return torch.sum(torch.mean(contrast_fn(_separate(state["Xw"], state["W"])), dim=1))

        return loss

    def apply_projection_back(self) -> None:
        Y = projection_back(self.output, reference=self.input, reference_id=self.reference_id)
        self.output, self.demix_filter = Y, ls_demix(Y, self.whitened_input)

    def apply_minimal_distortion_principle(self) -> None:
        Y = minimal_distortion_principle(self.output, reference=self.input, reference_id=self.reference_id)
        self.output, self.demix_filter = Y, ls_demix(Y, self.whitened_input)


class FastIVA(FastIVABase):
    """Fast fixed-point IVA (parity: ssspy/bss/iva.py:1000-1230).

    Needs ``contrast_fn``, ``d_contrast_fn`` and ``dd_contrast_fn``. Each
    step is :func:`ssspy_tpu_torch.ops.fixed_point_iva_steps.fast_iva_update`
    with ``varphi = G'(r) / flooring(2r)`` and
    ``(2 varphi - G''(r)) / flooring(2r)``, then the polar factor (K7).
    """

    def __init__(
        self,
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        dd_contrast_fn: Callable = None,
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
        if dd_contrast_fn is None:
            raise ValueError("Specify second-order derivative of contrast function.")
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
        self.dd_contrast_fn = dd_contrast_fn

    def make_step(self):
        flooring_fn, d_contrast_fn, dd_contrast_fn = self.flooring_fn, self.d_contrast_fn, self.dd_contrast_fn

        def step(state):
            Z, W = state["Xw"], state["W"]
            Y = _separate(Z, W)
            norm = torch.linalg.vector_norm(Y, dim=1)
            denom = flooring_fn(2 * norm)
            varphi = d_contrast_fn(norm) / denom
            y_gg = (2 * varphi - dd_contrast_fn(norm)) / denom
            return {**state, "W": fast_iva_update(Z, W, Y, varphi, y_gg)}

        return step


class FasterIVA(FastIVABase):
    """FasterIVA: the top eigenvector of each source's weighted covariance (parity: ssspy/bss/iva.py:1233-1400).

    Each step is :func:`ssspy_tpu_torch.ops.fixed_point_iva_steps.faster_iva_update`
    with ``varphi = G'(r) / flooring(2r)``: K1 with ``(N, T)`` weights, the
    top eigenvectors (K7 at ``(I N, 2M, 2M)``) and the polar factor (K7).
    """

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

    def make_step(self):
        flooring_fn, d_contrast_fn = self.flooring_fn, self.d_contrast_fn

        def step(state):
            Z = state["Xw"]
            norm = torch.linalg.vector_norm(_separate(Z, state["W"]), dim=1)
            return {**state, "W": faster_iva_update(Z, d_contrast_fn(norm) / flooring_fn(2 * norm))}

        return step


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
    sweep. ``"IP2"``: for each pair of ``pair_selector`` (sequential by
    default), the weights of the pair's two current rows, their
    covariances (K1 at two sources) and the pair update of
    :func:`ssspy_tpu_torch.ops.iva_steps.ip2_pair_update`.
    ``"ISS"``/``"ISS1"``: the state is the separated spectrogram ``Y``;
    each step computes the same weight from ``Y`` and runs the ISS1 sweep,
    the loss recovers ``W`` by least squares, and projection back rescales
    ``Y`` against the mixture. ``"ISS2"``: demix-free as well, the ISS2
    sweep over ``pair_selector``'s pairs. ``"IPA"``: demix-free, the sweep
    of :func:`ssspy_tpu_torch.ops.ipa_steps.ipa_sweep`, with the keywords
    ``lqpqm_normalization`` (default True) and ``newton_iter`` (default 1),
    which no other spatial algorithm takes. All through the routers of
    :mod:`ssspy_tpu_torch.ops.iva_steps` and :mod:`ssspy_tpu_torch.ops.ipa_steps`.
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        contrast_fn: Callable = None,
        d_contrast_fn: Callable = None,
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[PairSelector] = None,
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
        self.pair_selector = default_pair_selector(spatial_algorithm, pair_selector)
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

    def _varphi(self, Y: torch.Tensor, state: dict, pair: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """MM weight ``G'(r) / flooring(2r)`` per (source, frame); ``pair``: ``Y`` holds those two rows only."""
        norm = torch.linalg.vector_norm(Y, dim=1)
        return self.d_contrast_fn(norm) / self.flooring_fn(2 * norm)  # (N, T)

    def make_step(self):
        varphi_of = self._varphi
        # a max-type flooring_fn is an eps for the kernels; any other reaches every update that the JAX
        # class floors with it (update_by_*: ssspy_tpu/bss/iva.py:947-1002)
        eps, floor = step_flooring(self.flooring_fn, self.input.dtype)
        algorithm, pair_selector = self.spatial_algorithm, self.pair_selector

        if algorithm == "IP2":

            def step(state):
                W = auxiva_ip2_step(
                    state["X"], state["W"], eps=eps, pair_selector=pair_selector,
                    varphi_of=lambda Y, pair: varphi_of(Y, state, pair), flooring_fn=floor,
                )
                return {**state, "W": W}

        elif self._uses_demix_filter:

            def step(state):
                X, W = state["X"], state["W"]
                U = covariance(X, varphi_of(_separate(X, W), state))
                return {**state, "W": ip1_update(W, U, eps=eps, flooring_fn=floor)}

        elif algorithm == "IPA":
            lqpqm_normalization, newton_iter = self.lqpqm_normalization, self.newton_iter

            def step(state):
                Y = state["Y"]
                Y = ipa_sweep(
                    Y, varphi_of(Y, state), eps=eps, lqpqm_normalization=lqpqm_normalization,
                    newton_iter=newton_iter, flooring_fn=floor,
                )
                return {**state, "Y": Y}

        elif algorithm == "ISS2":

            def step(state):
                Y = state["Y"]
                return {
                    **state,
                    "Y": iss2_sweep(Y, varphi_of(Y, state), eps=eps, pair_selector=pair_selector, flooring_fn=floor),
                }

        else:

            def step(state):
                Y = state["Y"]
                return {**state, "Y": iss1_update(Y, varphi_of(Y, state), eps=eps, flooring_fn=floor)}

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
        pair_selector: Optional[PairSelector] = None,
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
            pair_selector=pair_selector,
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


class AuxGaussIVA(AuxIVA):
    """AuxIVA with a time-varying Gaussian source model (parity: ssspy/bss/iva.py:3131-3473).

    Each iteration first updates the variance ``alpha = mean_i |y|^2`` per
    (source, frame), carried in the state, then runs the chosen spatial
    update with the weight ``(2 r / alpha) / flooring(2 r)``; an IP2 pair
    reads its two rows of ``alpha``.
    """

    def __init__(
        self,
        spatial_algorithm: str = "IP",
        flooring_fn: Union[str, Callable, None] = "dtype",
        pair_selector: Optional[PairSelector] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
        **kwargs,
    ) -> None:
        def contrast_fn(y):
            return _gauss_contrast(y, self.variance)

        def d_contrast_fn(y):
            return 2 * y / self.variance

        super().__init__(
            spatial_algorithm=spatial_algorithm,
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            pair_selector=pair_selector,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
            **kwargs,
        )

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxGaussIVA", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.variance = torch.ones(
            (self.n_sources, self.n_frames), dtype=self.input.real.dtype, device=self.input.device
        )

    warm_start_keys = {**IVABase.warm_start_keys, "variance": "variance"}

    def init_state(self):
        return {**super().init_state(), "variance": self.variance}

    def commit_state(self, state) -> None:
        super().commit_state(state)
        self.variance = state["variance"]

    def _varphi(self, Y, state, pair=None):
        norm = torch.linalg.vector_norm(Y, dim=1)
        alpha = state["variance"]
        if pair is not None:
            alpha = torch.stack([alpha[pair[0]], alpha[pair[1]]])
        return (2 * norm / alpha) / self.flooring_fn(2 * norm)

    def make_step(self):
        spatial_step = super().make_step()
        uses_demix_filter = self._uses_demix_filter

        def step(state):
            Y = _separate(state["X"], state["W"]) if uses_demix_filter else state["Y"]
            return spatial_step({**state, "variance": _source_variance(Y)})

        return step

    def make_loss(self):
        uses_demix_filter = self._uses_demix_filter

        def loss(state):
            if uses_demix_filter:
                W = state["W"]
                Y = _separate(state["X"], W)
            else:
                Y = state["Y"]
                W = ls_demix(Y, state["X"])
            G = _gauss_contrast(Y, state["variance"])
            return torch.sum(torch.mean(G, dim=1)) - 2 * torch.sum(torch.linalg.slogdet(W)[1])

        return loss


class GradLaplaceIVA(GradIVA):
    """Gradient-descent IVA with a Laplace prior (parity: ssspy/bss/iva.py:2367-2503): score ``y / flooring(||y||)``."""

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        def score_fn(y):
            return y / self.flooring_fn(torch.linalg.vector_norm(y, dim=1, keepdim=True))

        super().__init__(
            step_size=step_size,
            contrast_fn=_laplace_contrast,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )

    def __repr__(self) -> str:
        keys = ["step_size", "is_holonomic", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, type(self).__name__, keys)


class NaturalGradLaplaceIVA(GradLaplaceIVA, NaturalGradIVA):
    """Natural-gradient IVA with a Laplace prior (parity: ssspy/bss/iva.py:2654-2788)."""


class GradGaussIVA(GradIVA):
    """Gradient-descent IVA with a time-varying Gaussian prior (parity: ssspy/bss/iva.py:2504-2652).

    Each iteration first updates the variance ``alpha = mean_i |y|^2``,
    carried in the state, then takes the gradient step with the score
    ``y / alpha``.
    """

    def __init__(
        self,
        step_size: float = 1e-1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        is_holonomic: bool = True,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        def contrast_fn(y):
            return _gauss_contrast(y, self.variance)

        def score_fn(y):
            return y / self.variance[:, None, :]

        super().__init__(
            step_size=step_size,
            contrast_fn=contrast_fn,
            score_fn=score_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            is_holonomic=is_holonomic,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self.variance = torch.ones(
            (self.n_sources, self.n_frames), dtype=self.input.real.dtype, device=self.input.device
        )

    warm_start_keys = {**IVABase.warm_start_keys, "variance": "variance"}

    def init_state(self):
        return {**super().init_state(), "variance": self.variance}

    def commit_state(self, state) -> None:
        super().commit_state(state)
        self.variance = state["variance"]

    def make_step(self):
        step_size, is_holonomic, natural = self.step_size, self.is_holonomic, self._natural

        def step(state):
            W = state["W"]
            Y = _separate(state["X"], W)
            variance = _source_variance(Y)
            Phi = Y / variance[:, None, :]
            return {**state, "W": grad_iva_step(W, Y, Phi, step_size, is_holonomic, natural), "variance": variance}

        return step

    def make_loss(self):
        def loss(state):
            W = state["W"]
            G = _gauss_contrast(_separate(state["X"], W), state["variance"])
            return torch.sum(torch.mean(G, dim=1)) - 2 * torch.sum(torch.linalg.slogdet(W)[1])

        return loss


class NaturalGradGaussIVA(GradGaussIVA):
    """Natural-gradient IVA with a time-varying Gaussian prior (parity: ssspy/bss/iva.py:2823-2974)."""

    _natural = True
