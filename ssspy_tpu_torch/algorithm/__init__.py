from . import permutation_alignment
from .minimal_distortion_principle import minimal_distortion_principle
from .permutation_alignment import (
    correlation_based_permutation_solver,
    permutation_align,
    score_based_permutation_solver,
)
from .projection_back import projection_back

__all__ = [
    "minimal_distortion_principle",
    "projection_back",
    "correlation_based_permutation_solver",
    "score_based_permutation_solver",
    "permutation_align",
    "permutation_alignment",
]

PROJECTION_BACK_KEYWORDS = ["projection_back", "projection-back", "PB"]
MINIMAL_DISTORTION_PRINCIPLE_KEYWORDS = [
    "minimal_distortion_principle",
    "minimal-distortion-principle",
    "MDP",
]
