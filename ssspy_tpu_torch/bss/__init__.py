"""Separator classes ported so far (see ROADMAP.md, Queue 1)."""

from . import ilrma, iva
from .base import IterativeMethodBase, SeparatorBase
from .ilrma import GaussILRMA, GGDILRMA, ILRMABase, TILRMA
from .iva import AuxIVA, AuxLaplaceIVA

__all__ = [
    "ilrma",
    "iva",
    "IterativeMethodBase",
    "SeparatorBase",
    "AuxIVA",
    "AuxLaplaceIVA",
    "ILRMABase",
    "GaussILRMA",
    "TILRMA",
    "GGDILRMA",
]
