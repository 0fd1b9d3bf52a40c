"""Iteration driver of the separator classes.

Counterpart of :mod:`ssspy_tpu.bss.base` (``IterativeMethodBase``;
parity target ssspy/bss/base.py:10-89). Every algorithm defines four
functions over a state dict of tensors —

- ``init_state()``   builds the state from the input + warm-start kwargs,
- ``make_step()``    returns ``step(state) -> state`` (one iteration),
- ``make_loss()``    returns ``loss(state) -> 0-dim tensor``,
- ``commit_state()`` writes the state back to the reference's attributes,

and the base class runs them in a Python loop (JAX's ``lax.scan``). The
loss trace stays on the device and is read once after the loop, so the
loop itself never waits for the device; with callbacks the loss is read
every iteration, because the callbacks observe it.
"""

from typing import Callable, Dict, List, Optional, Union

import torch

from ..algorithm import (
    MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS,
    PROJECTION_BACK_KEYWORDS,
    minimal_distortion_principle,
    projection_back,
)
from ..ops.iva_steps import ls_demix, separate
from ..special.flooring import resolve_flooring_spec
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.select_pair import sequential_pair_selector

__all__ = [
    "IterativeMethodBase",
    "SeparatorBase",
    "config_repr",
    "SPATIAL_ALGORITHMS",
    "check_spatial_algorithm",
    "default_pair_selector",
    "ipa_keywords",
]

SPATIAL_ALGORITHMS = ("IP", "IP1", "IP2", "ISS", "ISS1", "ISS2", "IPA")
PAIRWISE_ALGORITHMS = ("IP2", "ISS2")
# these carry the separated spectrograms and no demixing filters
DEMIX_FREE_ALGORITHMS = ("ISS", "ISS1", "ISS2", "IPA")


def config_repr(obj, name: str, keys) -> str:
    """Render ``Name(key=value, ...)`` from instance attributes."""
    inner = ", ".join(f"{k}={getattr(obj, k)}" for k in keys)
    return f"{name}({inner})"


def check_spatial_algorithm(spatial_algorithm: str) -> None:
    """Raise for an unknown spatial update."""
    if spatial_algorithm not in SPATIAL_ALGORITHMS:
        raise ValueError(f"unsupported option: {spatial_algorithm}.")


def default_pair_selector(spatial_algorithm: str, pair_selector):
    """The pair schedule of IP2 and ISS2: ``pair_selector``, or the sequential one (ssspy_tpu/bss/iva.py:887-891)."""
    if pair_selector is None and spatial_algorithm in PAIRWISE_ALGORITHMS:
        return sequential_pair_selector
    return pair_selector


IPA_DEFAULTS = {"lqpqm_normalization": True, "newton_iter": 1}


def ipa_keywords(spatial_algorithm: str, kwargs: dict) -> dict:
    """The IPA keywords of a separator: ``lqpqm_normalization`` and ``newton_iter``, with their defaults.

    They exist only with ``spatial_algorithm="IPA"``; any other keyword,
    and either of them without IPA, raises
    (ssspy_tpu/bss/iva.py:893-905, ssspy_tpu/bss/ilrma.py:816-828).
    """
    valid = IPA_DEFAULTS if spatial_algorithm == "IPA" else {}
    invalid = set(kwargs) - set(valid)
    if invalid:
        raise ValueError(f"Invalid keywords {invalid} are given.")
    return {**valid, **kwargs}


class IterativeMethodBase:
    """Base class of iterative methods (the iteration loop and its callbacks).

    ``device``: where the method runs, the card by default; ``"cpu"`` runs
    on the CPU, and without a card the default raises
    (:func:`ssspy_tpu_torch.utils.device.resolve_device`). The input and
    every warm-start tensor are moved there.

    ``warm_start_keys`` maps each key of the state that a checkpoint keeps
    to the ``__call__`` keyword that takes it back
    (:mod:`ssspy_tpu_torch.utils.checkpoint`); keys it does not name, such
    as the input and what ``_reset`` derives from it, are not kept. A class
    that declares none cannot be checkpointed.
    """

    warm_start_keys: Optional[Dict[str, str]] = None

    def __init__(
        self,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
        device=DEFAULT_DEVICE,
    ) -> None:
        if callbacks is not None and callable(callbacks):
            callbacks = [callbacks]
        self.callbacks = callbacks

        self.record_loss = record_loss
        self.loss = [] if record_loss else None
        self.input = None
        self.device = resolve_device(device)

    def _bind_input(self, input) -> None:
        """Keep a contiguous copy of the spectrogram on the method's device."""
        self.input = torch.as_tensor(input, device=self.device).clone(
            memory_format=torch.contiguous_format
        )

    def _set_warm_start(self, kwargs) -> None:
        """Set each keyword as an attribute, tensors moved to the input's device."""
        if self.input is None:
            raise RuntimeError("no input bound; call the separator with a spectrogram first.")
        for key, value in kwargs.items():
            if hasattr(value, "shape"):
                value = torch.as_tensor(value, device=self.input.device)
            setattr(self, key, value)

    # ---- subclass contract -------------------------------------------------

    def init_state(self):
        """Build the initial state dict from instance attributes."""
        raise NotImplementedError("Implement 'init_state' method.")

    def make_step(self) -> Callable:
        """Return the per-iteration update ``step(state) -> state``."""
        raise NotImplementedError("Implement 'make_step' method.")

    def make_loss(self) -> Callable:
        """Return the loss function ``loss(state) -> 0-dim tensor``."""
        raise NotImplementedError("Implement 'make_loss' method.")

    def commit_state(self, state) -> None:
        """Write state back to reference-compatible attributes."""
        raise NotImplementedError("Implement 'commit_state' method.")

    # ---- reference-compatible imperative API -------------------------------

    def update_once(self) -> None:
        """Advance the current state by one iteration (imperative API)."""
        self._state = self.make_step()(self._state)
        self.commit_state(self._state)

    def compute_loss(self) -> float:
        """Loss of the current state (imperative API)."""
        return float(self.make_loss()(self._state))

    # ---- driver ------------------------------------------------------------

    def _iterate(self, n_iter: int, initial_call: bool) -> None:
        """Run ``n_iter`` updates on ``self._state``."""
        state = self._state
        step = self.make_step()
        loss_fn = self.make_loss() if self.record_loss else None

        if self.callbacks is not None:
            if initial_call:
                if loss_fn is not None:
                    self.loss.append(float(loss_fn(state)))
                self.commit_state(state)
                for callback in self.callbacks:
                    callback(self)
            for _ in range(n_iter):
                state = step(state)
                if loss_fn is not None:
                    self.loss.append(float(loss_fn(state)))
                self.commit_state(state)
                for callback in self.callbacks:
                    callback(self)
        else:
            losses = []
            if loss_fn is not None and initial_call:
                losses.append(loss_fn(state))
            for _ in range(n_iter):
                state = step(state)
                if loss_fn is not None:
                    losses.append(loss_fn(state))
            if losses:
                self.loss.extend(torch.stack(losses).tolist())  # the one host read
            self.commit_state(state)

        self._state = state

    def __call__(self, *args, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Iteratively apply the update (subclasses orchestrate around this)."""
        self._iterate(n_iter=n_iter, initial_call=initial_call)


class SeparatorBase(IterativeMethodBase):
    """What the frequency-domain separators with demixing filters (IVA, ILRMA, the prox family) share.

    The flooring, the scale restoration after the loop and the demixing
    filters' warm start. The state holds demixing filters ``W``
    (``demix_filter``; IP) or only the separated spectrograms ``Y``
    (``demix_filter`` is ``None``; ISS, IPA). ``device`` as in
    :class:`IterativeMethodBase`.
    """

    warm_start_keys = {"W": "demix_filter", "Y": "output"}

    def __init__(
        self,
        flooring_fn: Union[str, Callable, None] = "dtype",
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        scale_restoration: Union[bool, str] = True,
        record_loss: bool = True,
        reference_id: int = 0,
        device=DEFAULT_DEVICE,
    ) -> None:
        super().__init__(callbacks=callbacks, record_loss=record_loss, device=device)

        self.flooring_fn = resolve_flooring_spec(flooring_fn)
        self.scale_restoration = scale_restoration
        self.reference_id = reference_id

    def __call__(self, input, n_iter: int = 100, initial_call: bool = True, **kwargs):
        """Bind ``input``, reset from the warm-start ``kwargs``, iterate, restore the scale."""
        self._bind_input(input)
        self._reset(**kwargs)
        self._state = self.init_state()
        self._iterate(n_iter=n_iter, initial_call=initial_call)

        if self.scale_restoration:
            self.restore_scale()
        if self.demix_filter is not None:
            self.output = separate(self.input, self.demix_filter)
        return self.output

    @property
    def _uses_demix_filter(self) -> bool:
        return self.spatial_algorithm not in DEMIX_FREE_ALGORITHMS

    def _reset_demix_filter(self, kwargs) -> None:
        """Initial ``demix_filter`` and ``output`` (ssspy_tpu/bss/iva.py:159-176).

        The identity when there is none, or when a previous demix-free run
        left ``None`` and this call gives no ``demix_filter=``; an explicit
        ``demix_filter=None`` with ``output=`` is a demix-free warm start.
        """
        X = self.input
        n_channels, n_bins, _ = X.shape
        if getattr(self, "demix_filter", None) is None and "demix_filter" not in kwargs:
            W = torch.eye(n_channels, dtype=X.dtype, device=X.device).expand(n_bins, -1, -1).clone()
        elif self.demix_filter is None:
            W = None
        else:
            W = self.demix_filter.to(dtype=X.dtype).contiguous().clone()
        self.demix_filter = W
        if W is not None:
            self.output = separate(X, W)
        elif not hasattr(self, "output"):
            self.output = None
        elif self.output is not None:
            self.output = self.output.to(dtype=X.dtype).contiguous()

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
        X = self.input
        if self.demix_filter is None:
            self.output = projection_back(self.output, reference=X, reference_id=self.reference_id)
        else:
            W_scaled = projection_back(self.demix_filter, reference_id=self.reference_id)
            self.output, self.demix_filter = separate(X, W_scaled), W_scaled

    def apply_minimal_distortion_principle(self) -> None:
        X = self.input
        if self.demix_filter is None:
            self.output = minimal_distortion_principle(
                self.output, reference=X, reference_id=self.reference_id
            )
        else:
            Y_scaled = minimal_distortion_principle(
                separate(X, self.demix_filter), reference=X, reference_id=self.reference_id
            )
            self.output = Y_scaled
            self.demix_filter = ls_demix(Y_scaled, X)
