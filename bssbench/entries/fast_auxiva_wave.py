"""Entry ``fast_auxiva_wave``: one recording ``(M, S)``, host memory in, the port's waveform-to-waveform AuxIVA out."""

import torch


def make(config: dict, device):
    """``call(request) -> (N, S)`` on ``device``: ``ssspy_tpu_torch.fast.fast_auxiva_wave`` on the request's waveform."""
    from ssspy_tpu_torch.fast import fast_auxiva_wave

    if config["reference_id"] != 0:
        raise ValueError("fast_auxiva_wave projects back onto channel 0")

    def call(request):
        return fast_auxiva_wave(torch.from_numpy(request.waveforms), n_iter=config["n_iter"],
                                algorithm=config["spatial_algorithm"], n_fft=config["n_fft"],
                                hop_length=config["hop_length"], device=device)

    return call
