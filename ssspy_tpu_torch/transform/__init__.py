from .pca import pca
from .stft import get_window, istft, stft
from .whiten import whiten

__all__ = ["stft", "istft", "get_window", "pca", "whiten"]
