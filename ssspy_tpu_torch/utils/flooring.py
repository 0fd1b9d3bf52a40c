"""Resolution of ``flooring_fn="self" | None | callable`` against a method (parity: ssspy/utils/flooring.py:8-24).

The function lives in :mod:`ssspy_tpu_torch.special.flooring`; this module
is where :mod:`ssspy_tpu.utils.flooring` has it.
"""

from ..special.flooring import choose_flooring_fn, identity

__all__ = ["choose_flooring_fn", "identity"]
