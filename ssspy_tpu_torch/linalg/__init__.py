"""Linear-algebra helpers of the port: the proximal operators of the prox family, IPA's LQPQM solver and the closed-form 2 x 2 generalized eigenproblem of IP2 and ISS2."""

from . import eigh, lqpqm, prox
from .eigh import gevd2
from .lqpqm import lqpqm2

__all__ = ["eigh", "gevd2", "lqpqm", "lqpqm2", "prox"]
