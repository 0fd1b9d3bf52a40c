from .stft import get_window, istft, stft

__all__ = ["stft", "istft", "get_window"]
