from .flooring import (
    EPS,
    F32_EPS,
    add_flooring,
    choose_flooring_fn,
    dtype_eps,
    dtype_flooring,
    identity,
    max_flooring,
    resolve_flooring_spec,
    sweep_eps,
)
from .psd import to_psd
from .softmax import logsumexp, softmax

__all__ = [
    "EPS",
    "F32_EPS",
    "add_flooring",
    "choose_flooring_fn",
    "dtype_eps",
    "dtype_flooring",
    "identity",
    "max_flooring",
    "resolve_flooring_spec",
    "sweep_eps",
    "to_psd",
    "softmax",
    "logsumexp",
]
