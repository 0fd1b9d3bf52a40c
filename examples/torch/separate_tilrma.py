"""t-ILRMA / GGD-ILRMA: heavy-tailed source models on the complex64 fast path, on the card by default.

``fast_t_ilrma`` (``dof=5``) or, with ``--ggd``, ``fast_ggd_ilrma``
(``beta=1.5``), ``n_basis=2``, 50 IP1 iterations: the weighted covariance
K1 with per-bin weights and the IP1 sweep K1b once each an iteration.

    python examples/torch/separate_tilrma.py
    python examples/torch/separate_tilrma.py --ggd
"""

import numpy as np

from _common import make_mixture, parser, report, save_wavs, to_numpy

MIXTURE = dict(n_sources=3, duration=4.0)  # make_mixture's keywords: the script's own mixture


def run(mix, *, ggd=False, device="cuda"):
    """The separated waveforms ``(n_sources, n_samples)`` of ``mix`` ``(n_channels, n_samples)``, as numpy."""
    from ssspy_tpu_torch.transform import istft, stft

    X = stft(mix, n_fft=512, hop_length=256, device=device)
    if ggd:
        from ssspy_tpu_torch.fast import fast_ggd_ilrma

        Y, _, _ = fast_ggd_ilrma(X, n_basis=2, beta=1.5, n_iter=50, rng=np.random.default_rng(0), device=device)
    else:
        from ssspy_tpu_torch.fast import fast_t_ilrma

        Y, _, _ = fast_t_ilrma(X, n_basis=2, dof=5, n_iter=50, rng=np.random.default_rng(0), device=device)
    return to_numpy(istft(Y, n_fft=512, hop_length=256, length=mix.shape[-1], device=device))


def main(argv=None):
    p = parser(__doc__.splitlines()[0])
    p.add_argument("--ggd", action="store_true", help="GGD-ILRMA (beta=1.5) in place of t-ILRMA")
    args = p.parse_args(argv)
    mix, images = make_mixture(**MIXTURE)
    y = run(mix, ggd=args.ggd, device=args.device)
    report(y, images, mix)
    save_wavs(y, "ggd_ilrma" if args.ggd else "t_ilrma", args.out)


if __name__ == "__main__":
    main()
