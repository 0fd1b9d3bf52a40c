"""Linear-algebra helpers of the port: the proximal operators of the prox family."""

from . import prox

__all__ = ["prox"]
