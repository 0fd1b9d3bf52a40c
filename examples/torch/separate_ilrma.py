"""GaussILRMA separation (NMF source model + IP spatial updates), on the card by default.

The class branch runs ``GaussILRMA(n_basis=8, spatial_algorithm="IP")``
through ``separate`` in float64 / complex128: on the card the plain
PyTorch routes, no hand-written kernel. ``--fast`` runs
``fast_gauss_ilrma`` in complex64: the weighted covariance K1 with per-bin
weights and the IP1 sweep K1b once each an iteration, 100 iterations.

    python examples/torch/separate_ilrma.py --fast
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, fast=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    if fast:
        from ssspy_tpu_torch.fast import fast_gauss_ilrma
        from ssspy_tpu_torch.transform import istft, stft

        X = stft(mix, n_fft=512, hop_length=256, device=device)
        Y, (T, V), W = fast_gauss_ilrma(X, n_basis=8, n_iter=100, rng=np.random.default_rng(0), device=device)
        return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))

    from ssspy_tpu_torch import separate
    from ssspy_tpu_torch.bss import GaussILRMA

    ilrma = GaussILRMA(n_basis=8, spatial_algorithm="IP", rng=np.random.default_rng(0), device=device)
    y = to_numpy(separate(mix, ilrma, n_iter=100, device=device))
    print(f"loss: {ilrma.loss[0]:.1f} -> {ilrma.loss[-1]:.1f}")
    return y


def main(argv=None):
    args = parser(__doc__.splitlines()[0], fast="fast_gauss_ilrma in complex64 through the kernels").parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, fast=args.fast, device=args.device)
    report(y, images, mix)
    save_wavs(y, "ilrma", args.out)


if __name__ == "__main__":
    main()
