from .convert import complex_to_planar, from_jax_state, planar_to_complex
from .dataset import host_stft, make_mixture, sample_speech_mixture
from .device import DEFAULT_DEVICE, resolve_device
from .flooring import choose_flooring_fn
from .select_pair import combination_pair_selector, sequential_pair_selector

__all__ = [
    "choose_flooring_fn",
    "complex_to_planar",
    "from_jax_state",
    "planar_to_complex",
    "host_stft",
    "make_mixture",
    "sample_speech_mixture",
    "sequential_pair_selector",
    "combination_pair_selector",
    "DEFAULT_DEVICE",
    "resolve_device",
]
