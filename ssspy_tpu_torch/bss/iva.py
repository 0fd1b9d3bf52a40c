"""Independent vector analysis (IVA): the auxiliary-function IP/IP1 family.

Counterpart of :mod:`ssspy_tpu.bss.iva` (parity target ssspy/bss/iva.py)
for the classes on the port's first slice: ``IVABase``, ``AuxIVABase``,
``AuxIVA`` with ``spatial_algorithm="IP"``/``"IP1"``, and
``AuxLaplaceIVA``. The separator runs on the input's device; its step
goes through the same two kernel wrappers as
:func:`ssspy_tpu_torch.fast.fast_auxiva` (``ops.kernels``).
"""

import functools
from typing import Callable, List, Optional, Union

import torch

from ..algorithm import (
    MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
    PROJECTION_BACK_KEYWORDS,
    minimal_distortion_principle,
    projection_back,
)
from ..ops.iva_steps import separate as _separate
from ..ops.kernels import ip1_sweep, weighted_covariance
from ..special.flooring import (
    EPS,
    dtype_eps,
    dtype_flooring,
    identity,
    max_flooring,
    resolve_flooring_spec,
)
from .base import IterativeMethodBase, config_repr

__all__ = ["IVABase", "AuxIVABase", "AuxIVA", "AuxLaplaceIVA"]

spatial_algorithms = ["IP", "IP1", "IP2", "ISS", "ISS1", "ISS2", "IPA"]
_PORTED_SPATIAL_ALGORITHMS = ("IP", "IP1")


def _ls_demix(Y: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Least-squares demixing filter ``W = Y X^H (X X^H)^{-1}`` per bin."""
    Xb = X.transpose(0, 1)  # (I, M, T)
    Yb = Y.transpose(0, 1)  # (I, N, T)
    XH = Xb.transpose(-2, -1).conj()
    return Yb @ XH @ torch.linalg.inv_ex(Xb @ XH)[0]


def _laplace_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.linalg.vector_norm(y, dim=1)


def _laplace_d_contrast(y: torch.Tensor) -> torch.Tensor:
    return 2 * torch.ones_like(y)


def _sweep_eps(flooring_fn: Callable, dtype: torch.dtype) -> float:
    """The ``eps`` of ``max(sqrt(w^H U w), eps)`` that ``flooring_fn`` applies.

    The IP1 sweep kernel floors the normaliser with a max-type eps, so the
    class's flooring function (``update_by_ip1``'s ``flooring_fn``,
    ssspy_tpu/bss/_update_spatial_model.py:46-79) must be one of those.
    """
    if flooring_fn is dtype_flooring:
        return dtype_eps(dtype)
    if isinstance(flooring_fn, functools.partial) and flooring_fn.func is max_flooring:
        return flooring_fn.keywords.get("eps", EPS)
    if flooring_fn is max_flooring:
        return EPS
    if flooring_fn is identity:
        return 0.0
    raise NotImplementedError(
        "the IP1 sweep floors its normaliser with max(., eps): flooring_fn must be "
        "'dtype', 'f32', 'f64', None, max_flooring or a functools.partial of it"
    )


class IVABase(IterativeMethodBase):
    """Base class of IVA (parity: ssspy/bss/iva.py:47-282)."""

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss)

        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.input = None
        self.scale_restoration = scale_restoration
        self.reference_id = reference_id

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self._bind_input(input)
        self._reset(**kwargs)
        raise NotImplementedError("subclasses must implement __call__.")

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "IVA", keys)

    def _bind_input(self, input) -> None:
        """Keep a contiguous copy of the spectrogram on its own device."""
        self.input = torch.as_tensor(input).clone(memory_format=torch.contiguous_format)

    def _reset(self, **kwargs) -> None:
        if self.input is None:
            raise RuntimeError("no input bound; call the separator with a spectrogram first.")

        X = self.input
        for key, value in kwargs.items():
            if hasattr(value, "shape"):
                value = torch.as_tensor(value, device=X.device)
            setattr(self, key, value)

        n_channels, n_bins, n_frames = X.shape
        n_sources = n_channels

        self.n_sources, self.n_channels = n_sources, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames

        if getattr(self, "demix_filter", None) is None:
            W = torch.eye(n_sources, n_channels, dtype=X.dtype, device=X.device)
            W = W.expand(n_bins, n_sources, n_channels).clone()
        else:
            W = self.demix_filter.to(device=X.device, dtype=X.dtype).contiguous().clone()

        self.demix_filter = W
        self.output = self.separate(X, demix_filter=W)

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

    # ---- scale restoration -------------------------------------------------

    def restore_scale(self) -> None:
        scale_restoration = self.scale_restoration
        if not scale_restoration:
            raise RuntimeError("scale restoration is disabled on this instance.")

        if type(scale_restoration) is bool:
            scale_restoration = PROJECTION_BACK_KEYWORDS[0]

        if scale_restoration in PROJECTION_BACK_KEYWORDS:
            self.apply_projection_back()
        elif scale_restoration in MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS:
            self.apply_minimal_distortion_principle()
        else:
            raise ValueError(f"{scale_restoration} is not supported for scale restoration.")

    def apply_projection_back(self) -> None:
        X, W = self.input, self.demix_filter
        W_scaled = projection_back(W, reference_id=self.reference_id)
        self.output, self.demix_filter = _separate(X, W_scaled), W_scaled

    def apply_minimal_distortion_principle(self) -> None:
        X, W = self.input, self.demix_filter
        Y_scaled = minimal_distortion_principle(
            _separate(X, W), reference=X, reference_id=self.reference_id
        )
        self.output = Y_scaled
        self.demix_filter = _ls_demix(Y_scaled, X)


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
    ) -> None:
        super().__init__(
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        if contrast_fn is None:
            raise ValueError("a contrast_fn must be provided.")
        if d_contrast_fn is None:
            raise ValueError("a d_contrast_fn must be provided.")
        self.contrast_fn = contrast_fn
        self.d_contrast_fn = d_contrast_fn

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)

        if self.scale_restoration:
            self.restore_scale()
        self.output = _separate(self.input, self.demix_filter)
        return self.output

    def __repr__(self) -> str:
        keys = ["scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)


class AuxIVA(AuxIVABase):
    """Auxiliary-function IVA (parity: ssspy/bss/iva.py:1403-2260).

    ``spatial_algorithm="IP"``/``"IP1"``: the sequential IP sweep. Each
    step computes the MM weight ``phi = G'(r) / flooring(2 r)``, the
    weighted covariance and the IP1 sweep through the kernel wrappers of
    :mod:`ssspy_tpu_torch.ops.kernels`. IP2, ISS/ISS1/ISS2 and IPA are not
    ported yet (ROADMAP.md, Queue 1, item 5).
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
    ) -> None:
        super().__init__(
            contrast_fn=contrast_fn,
            d_contrast_fn=d_contrast_fn,
            flooring_fn=flooring_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
        )
        if spatial_algorithm not in spatial_algorithms:
            raise ValueError(f"unsupported option: {spatial_algorithm}.")
        if spatial_algorithm not in _PORTED_SPATIAL_ALGORITHMS:
            raise NotImplementedError(
                f"spatial_algorithm={spatial_algorithm!r} is not ported to ssspy_tpu_torch yet "
                "(ROADMAP.md, Queue 1, item 5); use 'IP' or 'IP1'."
            )
        self.spatial_algorithm = spatial_algorithm

    def __repr__(self) -> str:
        keys = ["spatial_algorithm", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "AuxIVA", keys)

    def _varphi(self, Y: torch.Tensor) -> torch.Tensor:
        """MM weight ``G'(r) / flooring(2r)`` per (source, frame)."""
        norm = torch.linalg.vector_norm(Y, dim=1)
        return self.d_contrast_fn(norm) / self.flooring_fn(2 * norm)  # (N, T)

    def make_step(self):
        varphi_of = self._varphi
        eps = _sweep_eps(self.flooring_fn, self.input.dtype)

        def step(state):
            X, W = state["X"], state["W"]
            U = weighted_covariance(X, varphi_of(_separate(X, W)))
            return {**state, "W": ip1_sweep(W, U, eps=eps)}

        return step


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
        )
