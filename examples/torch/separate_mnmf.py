"""FastGaussMNMF: jointly diagonalized spatial covariance model, on the card by default.

The class branch runs ``FastGaussMNMF(n_basis=8)`` through ``separate`` in
float64 / complex128: on the card the plain PyTorch routes, no
hand-written kernel. ``--fast`` runs ``fast_gauss_mnmf`` in complex64: the
diagonalizer's weighted covariance K1 with per-channel weights and its IP1
sweep K1b once each an iteration, 100 iterations.

    python examples/torch/separate_mnmf.py --fast
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_gauss_mnmf
        from ssspy_tpu_torch.transform import istft, stft

        X = stft(mix, n_fft=512, hop_length=256, device=device)
        Y, _ = fast_gauss_mnmf(X, n_basis=8, n_iter=100, rng=np.random.default_rng(0), device=device)
        return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import FastGaussMNMF

    mnmf = FastGaussMNMF(n_basis=8, rng=np.random.default_rng(0), device=device)
    return to_numpy(separate(mix, mnmf, n_iter=100, device=device))


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_gauss_mnmf in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "mnmf", args.out)


if __name__ == "__main__":
    main()
