"""Separator classes ported so far (see ROADMAP.md, Queue 1)."""

from . import admmbss, cacgmm, hva, ilrma, ipsdta, iva, mnmf, pdsbss, proxbss
from .admmbss import ADMMBSS, MaskingADMMBSS
from .base import IterativeMethodBase, SeparatorBase
from .cacgmm import CACGMM, CACGMMBase
from .hva import HVA, MaskingADMMHVA, MaskingPDSHVA
from .ilrma import GaussILRMA, GGDILRMA, ILRMABase, TILRMA
from .ipsdta import BlockDecompositionIPSDTABase, GaussIPSDTA, IPSDTABase, TIPSDTA
from .iva import ADMMIVA, PDSIVA, AuxIVA, AuxLaplaceIVA
from .mnmf import MNMF, FastGaussMNMF, FastMNMFBase, GaussMNMF, MNMFBase
from .pdsbss import MaskingPDSBSS, PDSBSS
from .proxbss import ProxBSSBase

__all__ = [
    "admmbss",
    "cacgmm",
    "hva",
    "ilrma",
    "ipsdta",
    "iva",
    "mnmf",
    "pdsbss",
    "proxbss",
    "IterativeMethodBase",
    "SeparatorBase",
    "AuxIVA",
    "AuxLaplaceIVA",
    "ILRMABase",
    "GaussILRMA",
    "TILRMA",
    "GGDILRMA",
    "ProxBSSBase",
    "PDSBSS",
    "MaskingPDSBSS",
    "ADMMBSS",
    "MaskingADMMBSS",
    "PDSIVA",
    "ADMMIVA",
    "MaskingPDSHVA",
    "MaskingADMMHVA",
    "HVA",
    "MNMFBase",
    "MNMF",
    "GaussMNMF",
    "FastMNMFBase",
    "FastGaussMNMF",
    "IPSDTABase",
    "BlockDecompositionIPSDTABase",
    "GaussIPSDTA",
    "TIPSDTA",
    "CACGMMBase",
    "CACGMM",
]
