"""AuxLaplaceFDICA: per-bin ICA + correlation permutation alignment, on the card by default.

The class branch runs ``AuxLaplaceFDICA(spatial_algorithm="IP")`` through
``separate`` in float64 / complex128: on the card the plain PyTorch
routes, no hand-written kernel. ``--fast`` runs ``fast_aux_fdica`` in
complex64: the weighted covariance K1 with per-source, per-bin weights and
the IP1 sweep K1b once each an iteration, 100 iterations, then the
alignment across bins and projection back.

    python examples/torch/separate_fdica.py --fast
"""

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_aux_fdica
        from ssspy_tpu_torch.transform import istft, stft

        X = stft(mix, n_fft=512, hop_length=256, device=device)
        Y, W = fast_aux_fdica(X, n_iter=100, device=device)
        return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import AuxLaplaceFDICA

    fdica = AuxLaplaceFDICA(spatial_algorithm="IP", device=device)
    return to_numpy(separate(mix, fdica, n_iter=100, device=device))


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_aux_fdica in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "fdica", args.out)


if __name__ == "__main__":
    main()
