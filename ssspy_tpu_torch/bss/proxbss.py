"""Base class of proximal-splitting BSS (PDS/ADMM).

Counterpart of :mod:`ssspy_tpu.bss.proxbss` (parity target
ssspy/bss/proxbss.py: ``ProxBSSBase`` with its penalty and prox lists,
spectral-norm input normalization and scale restoration), on the port's
:class:`~ssspy_tpu_torch.bss.base.SeparatorBase`: the separator runs on its
``device``, the card by default.
"""

import warnings
from typing import Callable, List, Optional, Union

import torch

from ..ops.iva_steps import separate
from ..ops.prox_steps import herm_eigh_embed, prox_l21
from ..utils.device import DEFAULT_DEVICE
from .base import SeparatorBase, config_repr

__all__ = ["ProxBSSBase", "l21_contrast", "l21_prox_penalty", "iva_prox_defaults"]


def l21_contrast(y: torch.Tensor) -> torch.Tensor:
    """The IVA contrast of the prox family: the norm over bins, ``(N, T)``."""
    return torch.linalg.vector_norm(y, dim=1)


def l21_prox_penalty(x: torch.Tensor, step_size: float = 1) -> torch.Tensor:
    """Its prox: group soft-thresholding over the bin axis.

    The PDS/ADMM classes recognise this function and run the L21 step of
    :mod:`ssspy_tpu_torch.ops.prox_steps` with it.
    """
    return prox_l21(x, step_size=step_size, axis=1)


def iva_prox_defaults(contrast_fn, prox_penalty):
    """Default L21 contrast + group-shrinkage prox for PDS/ADMM IVA (ssspy_tpu/bss/iva.py:1209-1225)."""
    if contrast_fn is not None and prox_penalty is None:
        raise ValueError("a prox_penalty is required.")
    if contrast_fn is None and prox_penalty is not None:
        raise ValueError("a contrast_fn is required.")
    if contrast_fn is None:
        contrast_fn, prox_penalty = l21_contrast, l21_prox_penalty

    def penalty_fn(y):
        return torch.sum(contrast_fn(y))

    return contrast_fn, prox_penalty, penalty_fn


def resolve_relaxation(alpha: Optional[float], relaxation: float) -> float:
    """``relaxation``, or the deprecated ``alpha`` in its place (with a warning)."""
    if alpha is None:
        return relaxation
    assert relaxation == 1, "relaxation and the deprecated alpha are mutually exclusive; pass only one."
    warnings.warn("the alpha keyword is deprecated; use relaxation.", DeprecationWarning)
    return alpha


def resolve_record_loss(penalty_fn, record_loss: Optional[bool]) -> bool:
    """``record_loss`` defaults to whether there is a ``penalty_fn``; True without one asserts."""
    if penalty_fn is None:
        record_loss = False if record_loss is None else record_loss
        assert not record_loss, "record_loss=True needs a penalty_fn to evaluate."
        return record_loss
    return True if record_loss is None else record_loss


class ProxBSSBase(SeparatorBase):
    """Base class of BSS via proximal splitting (parity: ssspy/bss/proxbss.py:16-266).

    ``penalty_fn``: a callable or a list of them, one per ``prox_penalty``;
    ``prox_penalty``: the penalties' proxes ``prox(x, step_size=...)``.
    The masking classes pass ``masking=True`` and keep a ``mask_fn``
    instead (one penalty, ``penalty_fn`` a single callable).
    """

    def __init__(
        self,
        penalty_fn: Optional[Union[Callable, List[Callable]]] = None,
        prox_penalty: Optional[Union[Callable, List[Callable]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
        masking: bool = False,
    ) -> None:
        record_loss = resolve_record_loss(penalty_fn, record_loss)
        super().__init__(
            flooring_fn=None,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        if reference_id is None and scale_restoration:
            raise ValueError("scale_restoration=True needs a reference_id channel.")

        if masking:
            assert penalty_fn is None or callable(penalty_fn), "penalty_fn must be callable."
            self.penalty_fn = penalty_fn
            return

        if penalty_fn is not None and callable(penalty_fn):
            penalty_fn = [penalty_fn]
        if prox_penalty is None:
            raise ValueError("a prox_penalty must be provided.")
        if callable(prox_penalty):
            prox_penalty = [prox_penalty]
        if penalty_fn is not None:
            assert len(penalty_fn) == len(prox_penalty), (
                "penalty_fn and prox_penalty lists must have equal length."
            )
        self.penalty_fn = penalty_fn
        self.prox_penalty = prox_penalty

    def __repr__(self) -> str:
        keys = ["n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ProxBSSBase", keys)

    @property
    def n_penalties(self) -> int:
        return len(self.prox_penalty)

    @property
    def _l21_penalty(self) -> bool:
        """Whether the penalty is the IVA default alone, which runs the L21 step."""
        return self.prox_penalty == [l21_prox_penalty]

    def _reset(self, **kwargs) -> None:
        self._set_warm_start(kwargs)
        n_channels, n_bins, n_frames = self.input.shape
        self.n_sources, self.n_channels = n_channels, n_channels
        self.n_bins, self.n_frames = n_bins, n_frames
        self._reset_demix_filter(kwargs)

    def _reset_state(self, name: str, shape) -> None:
        """Zeros of ``shape`` for a state attribute the instance lacks; else a copy of it on the input's device."""
        X = self.input
        value = getattr(self, name, None)
        if not hasattr(self, name):
            value = torch.zeros(shape, dtype=X.dtype, device=X.device)
        elif value is not None:
            value = torch.as_tensor(value, device=X.device).to(X.dtype).contiguous().clone()
        setattr(self, name, value)

    def separate(self, input, demix_filter):
        if demix_filter is None:
            return None
        return separate(input, demix_filter)

    def compute_logdet(self, demix_filter):
        return torch.linalg.slogdet(demix_filter)[1]

    def make_loss(self):
        penalty_fns = self.penalty_fn if isinstance(self.penalty_fn, list) else [self.penalty_fn]

        def loss(state):
            X, W = state["X"], state["W"]
            Y = separate(X, W)
            penalty = sum(penalty_fn(Y) for penalty_fn in penalty_fns)
            return penalty - torch.sum(torch.linalg.slogdet(W)[1])

        return loss

    def normalize_by_spectral_norm(self, input, n_penalties: Optional[int] = None) -> torch.Tensor:
        """Scale the mixture so the PDS/ADMM operator norm is bounded (parity: ssspy/bss/proxbss.py:205-223).

        ``X / (sqrt(n_penalties) max_i ||X_i||_2)``, the spectral norm of each
        bin's ``(M, T)`` block read from the largest eigenvalue of
        ``X_i X_i^H`` through :func:`~ssspy_tpu_torch.ops.prox_steps.herm_eigh_embed`
        (the Jacobi kernel in float32), not from an SVD. The input moves to
        the separator's device first, as the separator's own input does.
        """
        if n_penalties is None:
            n_penalties = self.n_penalties
        X = torch.as_tensor(input, device=self.device)
        lamb = herm_eigh_embed(torch.einsum("mit,pit->imp", X, X.conj()))[0]
        norm = torch.sqrt(torch.clamp(lamb[..., -1].max(), min=0))
        return X / (float(n_penalties) ** 0.5 * norm).to(X.dtype)
