"""Linear-algebra helpers of the port: the proximal operators of the prox family and IPA's LQPQM solver."""

from . import lqpqm, prox
from .lqpqm import lqpqm2

__all__ = ["lqpqm", "lqpqm2", "prox"]
