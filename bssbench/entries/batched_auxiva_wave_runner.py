"""Entry ``batched_auxiva_wave_runner``: a batch ``(B, M, S)``, host memory in, the port's batched waveform runner out.

``ssspy_tpu_torch.parallel.make_batched_auxiva_wave_runner`` at world size 1,
with no process group: one rank on ``device``, no collective.
"""

import torch


def make(config: dict, device):
    """``call(request) -> (B, N, S)`` on ``device``."""
    from ssspy_tpu_torch.parallel import make_batched_auxiva_wave_runner, make_layout

    if config["reference_id"] != 0 or config["spatial_algorithm"] != "IP1":
        raise ValueError("the batched waveform runner runs IP1 and projects back onto channel 0")
    run = make_batched_auxiva_wave_runner(make_layout(world_size=1, device=device), n_fft=config["n_fft"],
                                          hop_length=config["hop_length"])

    def call(request):
        return run(torch.from_numpy(request.waveforms), config["n_iter"])

    return call
