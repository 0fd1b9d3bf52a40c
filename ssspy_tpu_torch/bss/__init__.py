"""Separator classes ported so far (see ROADMAP.md, Queue 1)."""

from . import iva
from .base import IterativeMethodBase

__all__ = ["iva", "IterativeMethodBase"]
