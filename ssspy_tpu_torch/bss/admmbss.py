"""ADMM-based BSS.

Counterpart of :mod:`ssspy_tpu.bss.admmbss` (parity target
ssspy/bss/admmbss.py: ``ADMMBSS``, ``MaskingADMMBSS``). One iteration:
the quadratic ``W`` subproblem against the loop-invariant inverse
``(Q X X^H + I)^{-1}`` (taken once per call and kept in the state as
``quad_inv``), the relaxed averages, the log-det prox of the filter
auxiliary (with the null lift; one batched eigh of the left and right
Grams, the Jacobi kernel K7 in float32), the penalty prox or the mask of
the spectrogram auxiliary, the dual ascent:
:func:`ssspy_tpu_torch.ops.prox_steps.admm_step`. The IVA default (the
L21 penalty alone) runs
:func:`~ssspy_tpu_torch.ops.prox_steps.admm_iva_step`, the step of
:func:`ssspy_tpu_torch.fast.fast_admm_iva`.
"""

import warnings
from typing import Callable, List, Optional, Union

import torch

from ..ops.iva_steps import separate
from ..ops.prox_steps import admm_iva_step, admm_quad_inv, admm_step
from ..utils.device import DEFAULT_DEVICE
from .base import config_repr
from .proxbss import ProxBSSBase, resolve_relaxation

__all__ = ["ADMMBSS", "MaskingADMMBSS"]


def _pop_deprecated_aux(kwargs):
    if "aux1" in kwargs:
        warnings.warn("the aux1 keyword is deprecated; use auxiliary1.", DeprecationWarning)
        kwargs["auxiliary1"] = kwargs.pop("aux1")
    if "aux2" in kwargs:
        warnings.warn("the aux2 keyword is deprecated; use auxiliary2.", DeprecationWarning)
        kwargs["auxiliary2"] = kwargs.pop("aux2")
    return kwargs


class ADMMBSSBase(ProxBSSBase):
    """Base of ADMM-type methods (parity: ssspy/bss/admmbss.py:15-52).

    The state is ``{"X", "W", "auxiliary1", "auxiliary2", "dual1", "dual2",
    "quad_inv"}``; all but ``X`` and ``quad_inv`` are written back to the
    attributes of the same names.
    """

    _STATE_KEYS = ("auxiliary1", "auxiliary2", "dual1", "dual2")
    warm_start_keys = {"W": "demix_filter", **{name: name for name in _STATE_KEYS}}  # not quad_inv, the input's

    def __repr__(self) -> str:
        keys = ["n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ADMMBSS", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**_pop_deprecated_aux(kwargs))
        filter_shape = (self.n_bins, self.n_sources, self.n_channels)
        spectrogram_shape = (self.n_sources, self.n_bins, self.n_frames)
        if self._penalty_axis:
            spectrogram_shape = (self.n_penalties,) + spectrogram_shape
        for name, shape in zip(self._STATE_KEYS, (filter_shape, spectrogram_shape) * 2):
            self._reset_state(name, shape)

    def init_state(self):
        return {
            "X": self.input,
            "W": self.demix_filter,
            **{name: getattr(self, name) for name in self._STATE_KEYS},
            "quad_inv": admm_quad_inv(self.input, self.n_penalties),
        }

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        for name in self._STATE_KEYS:
            setattr(self, name, state[name])
        self.output = separate(state["X"], state["W"])

    def _admm_step(self, spectrogram_prox=None):
        """``step(state)`` of :func:`admm_step` with ``spectrogram_prox`` (:func:`admm_iva_step` if None)."""
        rho, relaxation = self.rho, self.relaxation

        def step(state):
            args = (state["X"], state["auxiliary1"], state["auxiliary2"], state["dual1"], state["dual2"])
            if spectrogram_prox is None:
                out = admm_iva_step(*args, rho, relaxation, quad_inv=state["quad_inv"])
            else:
                out = admm_step(*args, spectrogram_prox, rho, relaxation, quad_inv=state["quad_inv"])
            return {**state, **dict(zip(("W",) + self._STATE_KEYS, out))}

        return step


class ADMMBSS(ADMMBSSBase):
    """BSS via ADMM (parity: ssspy/bss/admmbss.py:55-257).

    ``auxiliary2`` and ``dual2`` carry a penalty axis, ``(n_penalties, N, I, T)``.
    """

    _penalty_axis = True

    def __init__(
        self,
        rho: float = 1,
        alpha: Optional[float] = None,
        relaxation: float = 1,
        penalty_fn: Optional[Union[Callable, List[Callable]]] = None,
        prox_penalty: Optional[Union[Callable, List[Callable]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            penalty_fn=penalty_fn,
            prox_penalty=prox_penalty,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.rho = rho
        self.relaxation = resolve_relaxation(alpha, relaxation)

    def __repr__(self) -> str:
        keys = ["rho", "relaxation", "n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "ADMMBSS", keys)

    def make_step(self):
        if self._l21_penalty:
            l21_step = self._admm_step()

            def step(state):
                # the L21 step takes the penalty's own (N, I, T) pair
                state = l21_step({**state, "auxiliary2": state["auxiliary2"][0], "dual2": state["dual2"][0]})
                return {**state, "auxiliary2": state["auxiliary2"][None], "dual2": state["dual2"][None]}

            return step

        rho, prox_penalties = self.rho, self.prox_penalty

        def spectrogram_prox(Z):
            return torch.stack([prox(Z[q], step_size=1 / rho) for q, prox in enumerate(prox_penalties)])

        return self._admm_step(spectrogram_prox)


class MaskingADMMBSS(ADMMBSSBase):
    """Masking-based ADMM BSS (parity: ssspy/bss/admmbss.py:260-442).

    The spectrogram auxiliary is ``mask_fn(Z) Z``; ``auxiliary2`` and
    ``dual2`` are ``(N, I, T)``.
    """

    _penalty_axis = False

    def __init__(
        self,
        rho: float = 1,
        alpha: Optional[float] = None,
        relaxation: float = 1,
        penalty_fn: Optional[Callable] = None,
        mask_fn: Optional[Callable] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            penalty_fn=penalty_fn,
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
            masking=True,
        )
        if mask_fn is None:
            raise ValueError("MaskingPDSBSS/MaskingADMMBSS require a mask_fn.")
        assert callable(mask_fn), "mask_fn must be callable."
        self.mask_fn = mask_fn
        self.rho = rho
        self.relaxation = resolve_relaxation(alpha, relaxation)

    def __repr__(self) -> str:
        keys = ["rho", "relaxation", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "MaskingADMMBSS", keys)

    @property
    def n_penalties(self) -> int:
        return 1

    def make_step(self):
        mask_fn = self.mask_fn
        return self._admm_step(lambda Z: mask_fn(Z) * Z)
