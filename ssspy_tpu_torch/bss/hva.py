"""Harmonic vector analysis (HVA).

Counterpart of :mod:`ssspy_tpu.bss.hva` (parity target ssspy/bss/hva.py:
``MaskingPDSHVA``, ``MaskingADMMHVA``, ``HVA``). The mask is
:func:`ssspy_tpu_torch.ops.prox_steps.harmonic_mask` (log magnitude through
the instance's ``flooring_fn``, cepstral cosine shrinkage ``mask_iter``
times over ``torch.fft.irfft``, softmax over sources).
"""

from typing import Callable, List, Optional, Union

from ..ops.prox_steps import harmonic_mask
from ..special.flooring import resolve_flooring_spec
from ..utils.device import DEFAULT_DEVICE
from .admmbss import MaskingADMMBSS
from .base import config_repr
from .pdsbss import MaskingPDSBSS

__all__ = ["MaskingPDSHVA", "MaskingADMMHVA", "HVA"]


def _make_harmonic_mask_fn(method):
    """Cepstral-shrinkage mask closure over the method instance (ssspy_tpu/bss/hva.py:27-51)."""

    def mask_fn(y):
        if method.attenuation is None:
            method.attenuation = 1 / y.shape[0]
        return harmonic_mask(y, method.attenuation, mask_iter=method.mask_iter, flooring_fn=method.flooring_fn)

    return mask_fn


def _hva_repr(method, name: str, first_keys) -> str:
    keys = list(first_keys)
    if method.attenuation is not None:
        keys += ["attenuation"]
    keys += ["mask_iter", "scale_restoration", "record_loss"]
    if method.scale_restoration:
        keys += ["reference_id"]
    return config_repr(method, name, keys)


class MaskingPDSHVA(MaskingPDSBSS):
    """HVA via masking PDS (parity: ssspy/bss/hva.py:20-155)."""

    def __init__(
        self,
        mu1: float = 1,
        mu2: float = 1,
        alpha: Optional[float] = None,
        relaxation: float = 1,
        attenuation: Optional[float] = None,
        mask_iter: int = 1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            mu1=mu1,
            mu2=mu2,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=None,
            mask_fn=_make_harmonic_mask_fn(self),
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.attenuation = attenuation
        self.mask_iter = mask_iter
        self.flooring_fn = resolve_flooring_spec(flooring_fn)

    def __repr__(self) -> str:
        return _hva_repr(self, "MaskingPDSHVA", ["mu1", "mu2", "relaxation"])


class MaskingADMMHVA(MaskingADMMBSS):
    """HVA via masking ADMM (parity: ssspy/bss/hva.py:158-275)."""

    def __init__(
        self,
        rho: float = 1,
        alpha: Optional[float] = None,
        relaxation: float = 1,
        attenuation: Optional[float] = None,
        mask_iter: int = 1,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: Optional[bool] = None,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(
            rho=rho,
            alpha=alpha,
            relaxation=relaxation,
            penalty_fn=None,
            mask_fn=_make_harmonic_mask_fn(self),
            callbacks=callbacks,
            scale_restoration=scale_restoration,
            record_loss=record_loss,
            reference_id=reference_id,
            device=device,
        )
        self.attenuation = attenuation
        self.mask_iter = mask_iter
        self.flooring_fn = resolve_flooring_spec(flooring_fn)

    def __repr__(self) -> str:
        return _hva_repr(self, "MaskingADMMHVA", ["rho", "relaxation"])


class HVA(MaskingPDSHVA):
    """Alias of :class:`MaskingPDSHVA` (parity: ssspy/bss/hva.py:278-298)."""

    def __repr__(self) -> str:
        return _hva_repr(self, "HVA", ["mu1", "mu2", "relaxation"])
