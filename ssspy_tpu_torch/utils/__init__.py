from .convert import complex_to_planar, from_jax_state, planar_to_complex
from .dataset import host_stft, make_mixture
from .device import DEFAULT_DEVICE, resolve_device

__all__ = [
    "complex_to_planar",
    "from_jax_state",
    "planar_to_complex",
    "host_stft",
    "make_mixture",
    "DEFAULT_DEVICE",
    "resolve_device",
]
