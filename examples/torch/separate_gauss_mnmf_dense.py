"""Dense GaussMNMF: full-rank spatial covariances + Wiener separation, on the card by default.

The heaviest model in the library (docs/walkthroughs/gauss-mnmf.md). The
class branch runs ``GaussMNMF(n_basis=4)`` through ``separate`` in
float64 / complex128: on the card the plain PyTorch routes, no
hand-written kernel. ``--fast`` runs ``fast_gauss_mnmf_dense`` in
complex64: each iteration's model inverse, Wiener traces and frame sums go
through the fused model pass K5 (three launches) and the spatial update's
geometric mean and eigenvalue floor through the Jacobi eigh K7 (two), 30
iterations.

    python examples/torch/separate_gauss_mnmf_dense.py --fast
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_gauss_mnmf_dense
        from ssspy_tpu_torch.transform import istft, stft

        X = stft(mix, n_fft=512, hop_length=256, device=device)
        Y, _ = fast_gauss_mnmf_dense(X, n_basis=4, n_iter=30, rng=np.random.default_rng(0), device=device)
        return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import GaussMNMF

    mnmf = GaussMNMF(n_basis=4, rng=np.random.default_rng(0), device=device)
    return to_numpy(separate(mix, mnmf, n_iter=30, device=device))


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_gauss_mnmf_dense in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "mnmf_dense", args.out)


if __name__ == "__main__":
    main()
