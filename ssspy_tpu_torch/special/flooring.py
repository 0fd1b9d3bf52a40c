"""Flooring primitives for numerical stability.

Counterpart of :mod:`ssspy_tpu.special.flooring` (and of
``ssspy_tpu.utils.flooring.choose_flooring_fn``) on torch tensors. Every
division / sqrt in the separators is guarded by a user-swappable flooring
function, mirroring the reference's safety model
(ssspy/special/flooring.py:1-18).
"""

import functools
from typing import Any, Callable, Optional, Tuple, Union

import torch

EPS = 1e-10
# f32-calibrated floor: the reference's eps=1e-10 is tuned for float64
# and under-/overflows in float32 after ~150 iterations on
# high-dynamic-range mixtures (near-silent bins drive 1/eps toward the
# f32 range limit); 1e-6 is the measured-stable f32 setting.
F32_EPS = 1e-6

__all__ = [
    "EPS",
    "F32_EPS",
    "identity",
    "max_flooring",
    "add_flooring",
    "dtype_eps",
    "dtype_flooring",
    "resolve_flooring_spec",
    "choose_flooring_fn",
    "sweep_eps",
    "step_flooring",
    "floor",
]


def identity(input):
    """Return the input unchanged (disable flooring)."""
    return input


def max_flooring(input, eps: float = EPS):
    """Elementwise ``max(input, eps)``."""
    return torch.clamp(input, min=eps)


def add_flooring(input, eps: float = EPS):
    """Elementwise ``input + eps``."""
    return input + eps


def dtype_flooring(input, eps64: float = EPS, eps32: float = F32_EPS):
    """``max_flooring`` with the eps chosen by the operand's precision.

    float32/complex64 operands get the f32-calibrated floor, everything
    else the reference's f64-calibrated default.
    """
    return torch.clamp(input, min=dtype_eps(input.dtype, eps64, eps32))


def dtype_eps(dtype: torch.dtype, eps64: float = EPS, eps32: float = F32_EPS) -> float:
    """The floor :func:`dtype_flooring` applies to operands of ``dtype``."""
    return eps32 if torch.finfo(dtype).bits <= 32 else eps64


def resolve_flooring_spec(spec):
    """Resolve a constructor ``flooring_fn`` argument to a callable.

    ``None`` disables flooring; ``"f64"`` (eps=1e-10), ``"f32"``
    (eps=1e-6) and ``"dtype"`` (precision-dependent, see
    :func:`dtype_flooring`) select calibrated ``max_flooring`` variants;
    a callable passes through unchanged.
    """
    if spec is None:
        return identity
    if isinstance(spec, str):
        if spec == "f32":
            return functools.partial(max_flooring, eps=F32_EPS)
        if spec == "f64":
            return functools.partial(max_flooring, eps=EPS)
        if spec == "dtype":
            return dtype_flooring
        raise ValueError(
            f"unknown flooring spec {spec!r}; expected 'f32', 'f64', 'dtype', "
            "None, or a callable"
        )
    if not callable(spec):
        raise TypeError("flooring_fn must be callable.")
    return spec


def choose_flooring_fn(
    flooring_fn: Optional[Union[str, Callable]] = "self",
    method: Optional[Any] = None,
) -> Callable:
    """Resolve a flooring spec against a method instance.

    ``None`` -> identity; ``"self"`` -> ``method.flooring_fn`` (or
    identity); a callable is returned as-is (parity:
    ssspy/utils/flooring.py:8-24).
    """
    if flooring_fn is None:
        if method is not None:
            raise ValueError("a flooring method was given without a flooring function.")
        flooring_fn = identity
    elif isinstance(flooring_fn, str) and flooring_fn == "self":
        flooring_fn = getattr(method, "flooring_fn", identity)

    if not callable(flooring_fn):
        raise TypeError("flooring_fn must be callable.")
    return flooring_fn


def sweep_eps(flooring_fn: Callable, dtype: torch.dtype) -> Optional[float]:
    """The ``eps`` of ``max(., eps)`` that ``flooring_fn`` applies, or ``None`` where it is not max-type.

    Max-type are ``dtype_flooring`` (``dtype`` is the operand dtype it
    reads), ``max_flooring``, a ``functools.partial`` of it and
    ``identity`` (``eps = 0``): the IP1 and ISS1 sweep kernels floor their
    denominators with such an ``eps``
    (ssspy_tpu/bss/_update_spatial_model.py:46-79, :158-187). Any other
    callable gives ``None``, and the steps apply it on their plain routes.
    """
    if flooring_fn is dtype_flooring:
        return dtype_eps(dtype)
    if isinstance(flooring_fn, functools.partial) and flooring_fn.func is max_flooring:
        return flooring_fn.keywords.get("eps", EPS)
    if flooring_fn is max_flooring:
        return EPS
    if flooring_fn is identity:
        return 0.0
    return None


def step_flooring(
    flooring_fn: Callable, dtype: torch.dtype, eps: Optional[float] = None
) -> Tuple[float, Optional[Callable]]:
    """``(eps, floor)`` for a step: ``(its eps, None)`` for a max-type ``flooring_fn``, else ``(default, flooring_fn)``.

    ``eps`` is the max-type eps when given (a class that reads it
    otherwise, as the MNMF classes do), else :func:`sweep_eps`'s. For any
    other callable the eps is ``dtype_eps(dtype)``, the floor of the places
    where the JAX class floors with a constant and not with its
    ``flooring_fn``, and the callable goes to the steps, which apply it
    where the JAX class does (:func:`floor`).
    """
    max_eps = sweep_eps(flooring_fn, dtype)
    if max_eps is None:
        return dtype_eps(dtype), flooring_fn
    return (max_eps if eps is None else eps), None


def floor(input: torch.Tensor, eps: float, flooring_fn: Optional[Callable] = None) -> torch.Tensor:
    """``max(input, eps)``; ``flooring_fn(input)`` in its place where a callable is given."""
    return torch.clamp(input, min=eps) if flooring_fn is None else flooring_fn(input)
