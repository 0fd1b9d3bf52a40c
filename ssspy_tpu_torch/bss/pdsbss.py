"""Primal-dual splitting BSS.

Counterpart of :mod:`ssspy_tpu.bss.pdsbss` (parity target
ssspy/bss/pdsbss.py: ``PDSBSS``, ``MaskingPDSBSS``). One iteration: the
log-det prox of the demixing filter (one embedded-Gram eigh per bin, the
Jacobi kernel K7 in float32), the reflected separation, the dual prox or
the mask, the relaxation: :func:`ssspy_tpu_torch.ops.prox_steps.pds_step`.
The IVA default (the L21 penalty alone) runs
:func:`~ssspy_tpu_torch.ops.prox_steps.pds_iva_step`, the step of
:func:`ssspy_tpu_torch.fast.fast_pds_iva`.
"""

from typing import Callable, List, Optional, Union

import torch

from ..ops.iva_steps import separate
from ..ops.prox_steps import pds_iva_step, pds_step
from ..utils.device import DEFAULT_DEVICE
from .base import config_repr
from .proxbss import ProxBSSBase, resolve_relaxation

__all__ = ["PDSBSS", "MaskingPDSBSS"]


class PDSBSSBase(ProxBSSBase):
    """Base of PDS-type methods (parity: ssspy/bss/pdsbss.py:14-55).

    The state is ``{"X", "W", "dual"}``; ``dual`` is written back to the
    attribute of the same name.
    """

    def __repr__(self) -> str:
        keys = ["n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "PDSBSS", keys)

    warm_start_keys = {"W": "demix_filter", "dual": "dual"}

    def init_state(self):
        return {"X": self.input, "W": self.demix_filter, "dual": self.dual}

    def commit_state(self, state) -> None:
        self._state = state
        self.demix_filter = state["W"]
        self.dual = state["dual"]
        self.output = separate(state["X"], state["W"])


class PDSBSS(PDSBSSBase):
    """BSS via primal-dual splitting (parity: ssspy/bss/pdsbss.py:58-219).

    ``dual`` carries a penalty axis, ``(n_penalties, N, I, T)``.
    """

    def __init__(
        self,
        mu1: float = 1,
        mu2: float = 1,
        alpha: Optional[float] = None,
        relaxation: float = 1,
        penalty_fn: Optional[Union[Callable, List[Callable]]] = None,
        prox_penalty: Optional[Union[Callable, List[Callable]]] = None,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: Optional[bool] = None,
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
        self.mu1, self.mu2 = mu1, mu2
        self.relaxation = resolve_relaxation(alpha, relaxation)

    def __repr__(self) -> str:
        keys = ["mu1", "mu2", "relaxation", "n_penalties", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "PDSBSS", keys)

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self._reset_state("dual", (self.n_penalties, self.n_sources, self.n_bins, self.n_frames))

    def make_step(self):
        mu1, mu2, relaxation = self.mu1, self.mu2, self.relaxation

        if self._l21_penalty:

            def step(state):
                W, Y = pds_iva_step(state["X"], state["W"], state["dual"][0], mu1, mu2, relaxation)
                return {**state, "W": W, "dual": Y[None]}

            return step

        prox_penalties = self.prox_penalty

        def dual_prox(Z):
            return torch.stack([Z[q] - prox(Z[q], step_size=1 / mu2) for q, prox in enumerate(prox_penalties)])

        def step(state):
            W, Y = pds_step(state["X"], state["W"], state["dual"], dual_prox, mu1, mu2, relaxation)
            return {**state, "W": W, "dual": Y}

        return step


class MaskingPDSBSS(PDSBSSBase):
    """Masking-based PDS BSS (parity: ssspy/bss/pdsbss.py:222-412).

    The dual prox is replaced by a mask: ``Y~ = Z - mask_fn(Z) Z``;
    ``dual`` is ``(N, I, T)``.
    """

    def __init__(
        self,
        mu1: float = 1,
        mu2: float = 1,
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
        self.mu1, self.mu2 = mu1, mu2
        self.relaxation = resolve_relaxation(alpha, relaxation)

    def __repr__(self) -> str:
        keys = ["mu1", "mu2", "relaxation", "scale_restoration", "record_loss"]
        if self.scale_restoration:
            keys += ["reference_id"]
        return config_repr(self, "MaskingPDSBSS", keys)

    @property
    def n_penalties(self) -> int:
        return 1

    def _reset(self, **kwargs) -> None:
        super()._reset(**kwargs)
        self._reset_state("dual", (self.n_sources, self.n_bins, self.n_frames))

    def make_step(self):
        mu1, mu2, relaxation = self.mu1, self.mu2, self.relaxation
        mask_fn = self.mask_fn

        def step(state):
            W, Y = pds_step(
                state["X"], state["W"], state["dual"], lambda Z: Z - mask_fn(Z) * Z, mu1, mu2, relaxation
            )
            return {**state, "W": W, "dual": Y}

        return step
