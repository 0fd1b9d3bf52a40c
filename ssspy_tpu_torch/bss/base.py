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

from typing import Callable, List, Optional, Union

import torch

__all__ = ["IterativeMethodBase", "config_repr"]


def config_repr(obj, name: str, keys) -> str:
    """Render ``Name(key=value, ...)`` from instance attributes."""
    inner = ", ".join(f"{k}={getattr(obj, k)}" for k in keys)
    return f"{name}({inner})"


class IterativeMethodBase:
    """Base class of iterative methods (loop driver + callbacks)."""

    def __init__(
        self,
        callbacks: Optional[Union[Callable, List[Callable]]] = None,
        record_loss: bool = True,
    ) -> None:
        if callbacks is not None and callable(callbacks):
            callbacks = [callbacks]
        self.callbacks = callbacks

        self.record_loss = record_loss
        self.loss = [] if record_loss else None

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
