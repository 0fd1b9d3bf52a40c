"""AuxIVA separation, class API or the complex64 kernel path (--fast), on the card by default.

The class branch runs ``AuxIVA(spatial_algorithm="IP")`` through
``separate`` in the mixture's float64 / complex128. On the card that takes
the plain PyTorch routes and launches no hand-written kernel (the kernels
take complex64). ``--fast`` runs ``fast_auxiva_wave``: STFT, 100 IP1
iterations in complex64 (the weighted covariance K1 and the IP1 sweep K1b
once each an iteration), projection back and iSTFT, all on the device.

    python examples/torch/separate_auxiva.py --fast
    python examples/torch/separate_auxiva.py --device cpu
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_auxiva_wave

        return to_numpy(fast_auxiva_wave(mix.astype(np.float32), n_iter=100, algorithm="IP1", device=device))

    import torch

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import AuxIVA

    iva = AuxIVA(
        spatial_algorithm="IP",
        contrast_fn=lambda y: 2 * torch.linalg.norm(y, dim=1),
        d_contrast_fn=lambda y: 2 * torch.ones_like(y),
        device=device,
    )
    y = to_numpy(separate(mix, iva, n_iter=100, device=device))
    print(f"loss: {iva.loss[0]:.1f} -> {iva.loss[-1]:.1f}")
    return y


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_auxiva_wave in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "auxiva", args.out)


if __name__ == "__main__":
    main()
