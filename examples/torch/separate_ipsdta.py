"""GaussIPSDTA: block-decomposed PSDTF source model + VCD spatial update, on the card by default.

The class branch runs ``GaussIPSDTA(n_basis=2, n_blocks=64)`` through
``separate`` in float64 / complex128: on the card the plain PyTorch
routes, no hand-written kernel. ``--fast`` runs ``fast_gauss_ipsdta`` in
complex64: the model inverse through the batched Hermitian inverse K3 and
the basis update's geometric mean through the Jacobi eigh K7, once per
part of the blocks (63 blocks of 4 bins and one of 5), 30 iterations.

    python examples/torch/separate_ipsdta.py --fast
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=2, duration=2.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_gauss_ipsdta
        from ssspy_tpu_torch.transform import istft, stft

        X = stft(mix, n_fft=512, hop_length=256, device=device)
        Y, _, _ = fast_gauss_ipsdta(X, n_basis=2, n_blocks=64, n_iter=30, rng=np.random.default_rng(0), device=device)
        return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import GaussIPSDTA

    ipsdta = GaussIPSDTA(n_basis=2, n_blocks=64, rng=np.random.default_rng(0), device=device)
    return to_numpy(separate(mix, ipsdta, n_iter=30, device=device))


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_gauss_ipsdta in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "ipsdta", args.out)


if __name__ == "__main__":
    main()
