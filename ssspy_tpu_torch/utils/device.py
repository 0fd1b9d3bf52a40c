"""Where the port's entry points run: the card unless the caller asks for the CPU."""

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; raise if it is CUDA and there is no card.

    The entry points (the separator classes, the ``fast_*`` functions and
    :func:`ssspy_tpu_torch.separate`) default to ``device="cuda"`` and
    never carry on on the CPU by themselves: ``device="cpu"`` is the only
    way onto it.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"ssspy_tpu_torch runs on the card by default (device={str(device)!r}), but "
            "torch.cuda.is_available() is False; pass device='cpu' to run on the CPU."
        )
    return device
