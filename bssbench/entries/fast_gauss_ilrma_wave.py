"""Entry ``fast_gauss_ilrma_wave``: one recording ``(M, S)``, host memory in, the port's waveform-to-waveform GaussILRMA out.

The basis and activation are drawn inside the call by the
``numpy.random.default_rng(request.draw_seed)`` handed in, as the entry takes it.
"""

import numpy as np
import torch


def make(config: dict, device):
    """``call(request) -> (N, S)`` on ``device``."""
    from ssspy_tpu_torch.fast import fast_gauss_ilrma_wave

    if config["reference_id"] != 0:
        raise ValueError("fast_gauss_ilrma_wave projects back onto channel 0")

    def call(request):
        return fast_gauss_ilrma_wave(torch.from_numpy(request.waveforms), n_basis=config["n_basis"],
                                     n_iter=config["n_iter"], algorithm=config["spatial_algorithm"],
                                     n_fft=config["n_fft"], hop_length=config["hop_length"],
                                     rng=np.random.default_rng(request.draw_seed), device=device)

    return call
